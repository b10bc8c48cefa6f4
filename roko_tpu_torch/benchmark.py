"""Benchmarks of the port: ``python -m roko_tpu_torch bench``.

Counterpart of ``roko_tpu/benchmark.py`` for the suites that run on the
port's modules: the inference batch sweep (:383), the per-kind rows, the
recurrence alone (:178), the precision column (:215), with
``--train`` the train suite (:575), and with ``--mesh-devices`` the mesh
suite (:2163, the same global batch split over 1, 2 and 4 processes,
``parallel/``). Driver contract, as the reference's:
ONE JSON line ``{"metric", "value", "unit", "vs_baseline", "detail"}``,
``value`` the polished bases per second of the card (windows/s x
WINDOW_STRIDE = 30) and ``vs_baseline`` the windows/s over those of the
reference architecture in torch on the host CPU
(:func:`bench_torch_reference`, copied).

Where the reference timed two device paths, ``scan`` and ``pallas``, the
port has one, named ``kernels``: the model's recurrence wrappers launch
the hand-written CUDA kernels on a card (on the CPU they run their plain
loops, which are for tests and are not timed as a path of their own). The
headline runs in the port's default compute dtype, float32 on a card and
on the CPU (``config.default_compute_dtype``; the reference's is bf16 on
a TPU): bf16 and int8 show in ``precision``, and ``compute_dtype`` is
recorded. ``mfu_pct`` divides by the card's peak for that dtype from
NVIDIA's H100 data sheet (:func:`card_peaks`): float32 runs without TF32
(``infer.use_float32_matmuls``), so its peak is the CUDA-core figure.

Suites whose modules are not ported appear in ``detail`` as ``{"error":
"not ported yet (ROADMAP queue item ...)"}``, shown and never hidden, and
their flags are usage errors. A row of a ported suite that fails is
recorded as an ``error`` and the run goes on, as the reference's does;
the command then exits 1. Not ported on purpose: the reference's probe,
child process and CPU fallback (:1478-1660), which keep a sick TPU tunnel
from voiding the artifact: the port measures in this process, on
``--device cuda`` by default, and raises without a card unless
``--device cpu`` is given.

    python -m roko_tpu_torch bench [--train] [--b N] [--bench-iterations N]
        [--out FILE] [--compare PREVIOUS.json] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

BATCH = 512
WARMUP = 3
ITERS = 20
TORCH_ITERS = 10
SWEEP_BATCHES = (BATCH, 2048)
#: windows whose logits the precision column compares across dtypes (the
#: reference's ``min(batch, 16)``)
LOGIT_DELTA_BATCH = 16

#: cross-round deltas inside this band are flagged ``noise``, never
#: regressions (the reference's ``NOISE_BAND_PCT``)
NOISE_BAND_PCT = 10.0

#: NVIDIA's H100 data sheet: dense FLOP/s of float32 on CUDA cores and of
#: bfloat16 on tensor cores, and memory bytes/s, of the SXM and PCIe parts
_H100 = {
    "sxm": {"f32": 67e12, "bf16": 989e12, "bytes": 3.35e12},
    "pcie": {"f32": 51.2e12, "bf16": 756e12, "bytes": 2.0e12},
}

#: suites of the reference whose modules the port lacks: detail key ->
#: (ROADMAP queue item, why)
UNPORTED_SUITES = {
    "features": ("A11b", "it times extraction into HDF5, and the card machine has no h5py"),
    "end_to_end": ("A11b", "it runs features -> HDF5 -> inference, and the card machine has "
                   "no h5py"),
    "pipeline": ("A11b", "its staged half goes through HDF5, and the card machine has no h5py"),
    "cascade": ("A10", "the cascade is not ported"),
    "coldstart": ("A9.3", "it needs the AOT bundle"),
    "input": ("A11b", "it writes an HDF5 corpus, and the card machine has no h5py"),
    "fleet": ("A9", "the serve stack is not ported"),
    "serve": ("A9", "the serve stack is not ported"),
}

#: rows of the reference's train suite with no counterpart in the port
UNPORTED_TRAIN_ROWS = {
    "train_gru_remat": "no counterpart: ModelConfig.remat_frontend is a JAX-side lever "
                       "(jax.checkpoint of the front end) that the port's ModelConfig lacks "
                       "(ROADMAP queue item A12)",
    "train_gru_remat_scan": "no counterpart: ModelConfig.remat_scan is a JAX-side lever "
                            "(jax.checkpoint of the scan cell) that the port's ModelConfig "
                            "lacks (ROADMAP queue item A12)",
    "train_gru_rbg": "no counterpart: TrainConfig.dropout_rng_impl picks a JAX PRNG; the port "
                     "draws its dropout masks from a torch.Generator (ROADMAP queue item A12)",
    "train_gru_pallas": "the same thing as train_gru in the port: its one train path runs "
                        "the hand-written kernels",
    "input_stall": "not ported yet (ROADMAP queue item A11b): it writes an HDF5 corpus, and "
                   "the card machine has no h5py",
}

#: flags of the reference's bench whose suites are not ported: attribute ->
#: (flag, ROADMAP queue item); None for --in-process, which is deliberately
#: not ported
UNPORTED_FLAGS = {
    "features": ("--features", "A11b"),
    "e2e_draft": ("--e2e-draft", "A11b"),
    "pipeline_draft": ("--pipeline-draft", "A11b"),
    "cascade_draft": ("--cascade-draft", "A10"),
    "coldstart_ladder": ("--coldstart-ladder", "A9.3"),
    "input_rows": ("--input-rows", "A11b"),
    "fleet_workers": ("--fleet-workers", "A9"),
    "in_process": ("--in-process", None),
}


def card_peaks(name: str, ops: str = "f32") -> Tuple[float, float]:
    """(FLOP/s, memory bytes/s) of the card named ``name`` from NVIDIA's
    H100 data sheet, the SXM part unless the name says PCIe: ``ops`` "f32"
    for float32 without tensor cores, "bf16" for dense bf16 on tensor
    cores."""
    part = _H100["pcie" if "PCIe" in name else "sxm"]
    return part[ops], part["bytes"]


def _device_peak_flops(device, compute_dtype: str) -> Optional[float]:
    """Peak FLOP/s of ``compute_dtype`` on ``device``: the H100's, None off
    a CUDA device or on a card that is not an H100 (the reference's
    ``_device_peak_flops`` :53, which knew TPU kinds only)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        return None
    return card_peaks(name, "bf16" if compute_dtype == "bfloat16" else "f32")[0]


def model_param_bytes(cfg) -> int:
    """Storage bytes of the whole parameter tree, counted off the port's
    own model (``RokoModel(cfg).state_dict()``): float parameters are
    float32 in every compute dtype (bf16 narrows the compute, not these
    bytes), and ``quantize="int8"`` stores each target matrix as one byte
    an element plus a float32 scale per output channel
    (``models/quant.py``), the quantized tree."""
    import torch

    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.models.quant import quantize_params

    sd = RokoModel(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    if cfg.quantize is not None:
        sd = quantize_params(sd, cfg)
    return sum(t.numel() * t.element_size() for t in sd.values())


def model_param_bytes_per_window(cfg, batch: int) -> float:
    """Weight bytes charged to one window when a dispatch of ``batch``
    windows reads the parameters once."""
    return model_param_bytes(cfg) / max(1, batch)


def model_flops_per_window(cfg, *, training: bool = False) -> float:
    """Analytic matmul FLOPs per window of the recurrent consensus models,
    formula for formula the reference's: inference with the reassociated
    embed + fc1 front end, training with the one-hot embedding GEMM, the
    backward counted as twice the forward; the lingru's elementwise scan
    left out."""
    T, R, V = cfg.window_cols, cfg.window_rows, cfg.embed_vocab
    D = cfg.embed_dim
    J1, J2 = cfg.read_mlp
    H, L = cfg.hidden_size, cfg.num_layers
    gin = cfg.gru_in_size

    if training:
        # onehot[B,R,T,V] @ E[V,D], then e[B,R,T,D] x W1[R,J1]
        embed_fc1 = 2 * T * R * V * D + 2 * T * D * J1 * R
    else:
        # einsum brtv,rj + vd,btvj
        embed_fc1 = 2 * T * V * J1 * R + 2 * T * D * J1 * V
    fc2 = 2 * T * J1 * J2 * D
    if cfg.kind == "lingru":
        # gate projections only: [in, 2H] per direction, no hidden matmul
        rec_in = 2 * T * gin * 4 * H  # both directions, layer 1
        rec_in += (L - 1) * 2 * T * (2 * H) * 4 * H
        rec_h = 0
    else:
        rec_in = 2 * T * gin * 6 * H  # both directions, layer 1
        rec_in += (L - 1) * 2 * T * (2 * H) * 6 * H
        rec_h = L * 2 * T * 2 * H * 3 * H
    head = 2 * T * 2 * H * cfg.num_classes
    fwd = embed_fc1 + fc2 + rec_in + rec_h + head
    return fwd * (3.0 if training else 1.0)


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_infer(
    cfg, batch: int = BATCH, iters: int = ITERS,
    detail: Optional[Dict[str, Any]] = None, device="cuda",
) -> float:
    """windows/s of the port's forward + argmax (the device half of
    ``infer.predict``: ``RokoModel`` in eval mode, quantized first when
    ``cfg`` asks for int8) on a seeded uint8 batch already on the device,
    so the host-to-device copy of the windows is not in it. The timing
    ends in the device-to-host copy of the last batch's class ids, after
    ``WARMUP`` untimed calls whose wall time goes to
    ``detail["warmup_seconds"]``."""
    import torch

    from roko_tpu_torch import constants as C
    from roko_tpu_torch.infer import resolve_device, use_float32_matmuls
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.models.quant import maybe_quantize

    dev = resolve_device(device)
    use_float32_matmuls()
    model = RokoModel(cfg, generator=torch.Generator().manual_seed(0))
    model = maybe_quantize(model).to(dev).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(
        0, C.FEATURE_VOCAB, (batch, C.WINDOW_ROWS, C.WINDOW_COLS)).astype(np.uint8)).to(dev)

    def predict():
        with torch.inference_mode():
            return model(x).argmax(dim=-1).to(torch.int32)

    t_w = time.perf_counter()
    for _ in range(WARMUP):
        predict().cpu()
    if detail is not None:
        detail["warmup_seconds"] = round(time.perf_counter() - t_w, 3)
    t0 = time.perf_counter()
    outs = [predict() for _ in range(iters)]
    outs[-1].cpu()
    dt = time.perf_counter() - t0
    return batch * iters / dt


def bench_recurrence(kind: str, batch: int, iters: int, device="cuda",
                     model_overrides: Optional[Dict] = None) -> float:
    """windows/s of the recurrence stack alone ([B, T, gru_in] -> [B, T,
    2H] through ``RokoGRU`` or ``RokoLinGRU``, the default widths, float32)
    on a seeded input on the device: the per-kind rows without the front
    end and head the kinds share. Synced on the device (the reference
    fetched the output, since its TPU's sync returned at dispatch)."""
    import torch

    from roko_tpu_torch.config import ModelConfig
    from roko_tpu_torch.infer import resolve_device, use_float32_matmuls
    from roko_tpu_torch.models.gru import RokoGRU
    from roko_tpu_torch.models.lingru import RokoLinGRU

    dev = resolve_device(device)
    use_float32_matmuls()
    cfg = ModelConfig(**(model_overrides or {}))
    stack = RokoLinGRU if kind == "lingru" else RokoGRU
    mod = stack(cfg.gru_in_size, cfg.hidden_size, cfg.num_layers, 0.0,
                torch.Generator().manual_seed(0)).to(dev).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, cfg.window_cols, cfg.gru_in_size)).astype(np.float32)).to(dev)

    def step():
        with torch.inference_mode():
            return mod(x)

    for _ in range(WARMUP):
        step()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(torch, dev)
    return batch * iters / (time.perf_counter() - t0)


def bench_precision(
    kind: str, batch: int, iters: int, model_overrides: Optional[Dict] = None,
    device="cuda",
) -> Dict[str, Any]:
    """f32, bf16 and int8 (weight-only, f32 compute) windows/s of
    :func:`bench_infer` on the same work, each with its parameter bytes a
    window and FLOPs a parameter byte, and the max |delta| of the bf16 and
    int8 logits from the f32 ones on the same weights and windows."""
    import torch

    from roko_tpu_torch import constants as C
    from roko_tpu_torch.config import ModelConfig
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.models.quant import maybe_quantize

    dev = resolve_device(device)
    over = model_overrides or {}
    cfg32 = ModelConfig(kind=kind, compute_dtype="float32", **over)
    cfgbf = ModelConfig(kind=kind, compute_dtype="bfloat16", **over)
    cfg8 = ModelConfig(kind=kind, compute_dtype="float32", quantize="int8", **over)
    row: Dict[str, Any] = {"model_kind": kind, "batch": batch}
    row["f32_windows_per_sec"] = round(bench_infer(cfg32, batch, iters, device=dev), 1)
    row["bf16_windows_per_sec"] = round(bench_infer(cfgbf, batch, iters, device=dev), 1)
    row["int8_windows_per_sec"] = round(bench_infer(cfg8, batch, iters, device=dev), 1)
    flops = model_flops_per_window(cfg32)
    for tag, c in (("f32", cfg32), ("bf16", cfgbf), ("int8", cfg8)):
        pb = model_param_bytes_per_window(c, batch)
        row[f"{tag}_param_bytes_per_window"] = round(pb, 1)
        row[f"{tag}_flops_per_param_byte"] = round(flops / pb, 1)
    m32 = RokoModel(cfg32, generator=torch.Generator().manual_seed(0))
    mbf, m8 = RokoModel(cfgbf), RokoModel(cfg8)
    for m in (mbf, m8):
        m.load_state_dict(m32.state_dict())
    m32, mbf, m8 = (maybe_quantize(m).to(dev).eval() for m in (m32, mbf, m8))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(
        0, C.FEATURE_VOCAB,
        (min(batch, LOGIT_DELTA_BATCH), cfg32.window_rows, cfg32.window_cols)
    ).astype(np.uint8)).to(dev)
    with torch.inference_mode():
        ref = m32(x)
        row["max_abs_logit_delta"] = round(float((ref - mbf(x)).abs().max()), 5)
        row["int8_max_abs_logit_delta"] = round(float((ref - m8(x)).abs().max()), 5)
    return row


def bench_train(cfg, batch: int = BATCH, iters: int = ITERS, device="cuda") -> Dict[str, float]:
    """Time of one step of the port's trainer, forward, backward and Adam
    (``training/loop.py``: ``grad_step``, then the optimizer's step), on a
    seeded batch on the device: {"step_ms", "windows_per_sec"}, after
    ``WARMUP`` untimed steps; the timing ends in a device-to-host copy of
    the last loss."""
    import torch

    from roko_tpu_torch import constants as C
    from roko_tpu_torch.infer import resolve_device, use_float32_matmuls
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.training.loop import grad_step, make_optimizer

    dev = resolve_device(device)
    use_float32_matmuls()
    model = RokoModel(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model, 1e-4)
    rng = np.random.default_rng(0)
    x = rng.integers(0, C.FEATURE_VOCAB, (batch, C.WINDOW_ROWS, C.WINDOW_COLS)).astype(np.uint8)
    y = rng.integers(0, C.NUM_CLASSES, (batch, C.WINDOW_COLS)).astype(np.uint8)
    x, y, w = (torch.from_numpy(a).to(dev) for a in (x, y, np.ones((batch,), np.float32)))
    generator = torch.Generator(device=dev).manual_seed(1)

    def step():
        loss, _ = grad_step(model, x, y, w, generator)
        opt.step()
        return loss

    for _ in range(WARMUP):
        step().item()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    loss.item()
    dt = time.perf_counter() - t0
    return {"step_ms": 1e3 * dt / iters, "windows_per_sec": batch * iters / dt}


def bench_torch_reference(iters: int = TORCH_ITERS, batch: int = 128) -> float:
    """The reference's architecture (roko/rnn_model.py:24-59 semantics) in
    torch on the host CPU, windows/s: the ``vs_baseline`` denominator.
    Weights and windows are drawn from seed 0 without touching the global
    generator's state."""
    import torch

    class RefModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = torch.nn.Embedding(12, 50)
            self.fc1 = torch.nn.Linear(200, 100)
            self.fc2 = torch.nn.Linear(100, 10)
            self.gru = torch.nn.GRU(
                500, 128, 3, batch_first=True, bidirectional=True, dropout=0.2
            )
            self.head = torch.nn.Linear(256, 5)

        def forward(self, x):
            e = self.embedding(x)  # [B,200,90,50]
            e = e.permute(0, 2, 3, 1)  # [B,90,50,200]
            h = torch.relu(self.fc1(e))
            h = torch.relu(self.fc2(h))  # [B,90,50,10]
            h = h.reshape(-1, 90, 500)
            h, _ = self.gru(h)
            return self.head(h)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = RefModel().eval()
    x = torch.randint(0, 12, (batch, 200, 90), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(x)  # warmup
        t0 = time.perf_counter()
        for _ in range(iters):
            out = model(x)
        dt = time.perf_counter() - t0
    del out
    return batch * iters / dt  # windows/sec


def _error(e: Exception) -> str:
    return f"{type(e).__name__}: {e}"[:300]


def run_inference_suite(
    batch: Optional[int] = None, progress=None, iters: Optional[int] = None,
    device="cuda", model_overrides: Optional[Dict] = None,
) -> Dict[str, Any]:
    """The inference suite: windows/s of the ``kernels`` path across
    ``SWEEP_BATCHES`` on a card (``batch`` pins one; off a card one batch,
    ``batch`` or ``BATCH``), the best as the headline; the per-kind rows
    (gru from the sweep's first batch, lingru measured at it), the
    recurrence alone, and the precision column at ``min(batch, 128)``. A
    failing row is recorded as an ``error`` and the suite goes on;
    ``progress`` (if given) is called with the detail after each row."""
    from roko_tpu_torch.config import ModelConfig, default_compute_dtype
    from roko_tpu_torch.infer import resolve_device

    dev = resolve_device(device)
    batches = SWEEP_BATCHES if batch is None and dev.type == "cuda" else (batch or BATCH,)
    iters = ITERS if iters is None else iters
    over = dict(model_overrides or {})
    detail: Dict[str, Any] = {"batch": batches[0], "iterations": iters}
    dtype = default_compute_dtype(dev.type)
    detail["compute_dtype"] = dtype
    cfg = ModelConfig(compute_dtype=dtype, **over)
    best, best_batch, sweep = 0.0, None, {}
    detail["batch_sweep"] = sweep
    for b in batches:
        rates: Dict[str, Any] = {}
        sweep[str(b)] = rates
        try:
            d_k: Dict[str, Any] = {}
            rates["kernels"] = round(bench_infer(cfg, b, iters, detail=d_k, device=dev), 1)
            rates["kernels_warmup_seconds"] = d_k.get("warmup_seconds")
        except Exception as e:  # report, never swallow
            rates["kernels_error"] = _error(e)
        if progress is not None:
            progress(detail)
        if rates.get("kernels", 0.0) > best:
            best, best_batch = rates["kernels"], b
    if best == 0.0:
        raise RuntimeError(f"all inference paths failed: {sweep}")

    # the per-kind rows on identical fixed work (same batch and iterations)
    b0 = batches[0]
    first = sweep[str(b0)]
    kinds: Dict[str, Any] = {}
    detail["model_kinds"] = kinds
    gru_row: Dict[str, Any] = {"model_kind": "gru", "batch": b0, "iterations": iters}
    if "kernels" in first:
        gru_row["kernels_windows_per_sec"] = first["kernels"]
    else:
        gru_row["error"] = first.get("kernels_error", "kernels row failed")
    kinds["gru"] = gru_row
    lin_row: Dict[str, Any] = {"model_kind": "lingru", "batch": b0, "iterations": iters}
    try:
        d_l: Dict[str, Any] = {}
        lin_row["kernels_windows_per_sec"] = round(bench_infer(
            ModelConfig(kind="lingru", compute_dtype=dtype, **over), b0, iters, detail=d_l,
            device=dev), 1)
        lin_row["warmup_seconds"] = d_l.get("warmup_seconds")
    except Exception as e:  # report, never swallow
        lin_row["error"] = _error(e)
    kinds["lingru"] = lin_row
    if progress is not None:
        progress(detail)
    if "kernels_windows_per_sec" in gru_row and "kernels_windows_per_sec" in lin_row:
        detail["lingru_speedup_vs_gru"] = round(
            lin_row["kernels_windows_per_sec"] / gru_row["kernels_windows_per_sec"], 2)
    try:
        rec_g = bench_recurrence("gru", b0, iters, device=dev, model_overrides=over)
        rec_l = bench_recurrence("lingru", b0, iters, device=dev, model_overrides=over)
        detail["recurrence_only"] = {
            "batch": b0, "iterations": iters,
            "gru_windows_per_sec": round(rec_g, 1),
            "lingru_windows_per_sec": round(rec_l, 1),
            "lingru_speedup_vs_gru": round(rec_l / rec_g, 2),
        }
    except Exception as e:  # report, never swallow
        detail["recurrence_only"] = {"error": _error(e)}
    if progress is not None:
        progress(detail)

    prec: Dict[str, Any] = {}
    detail["precision"] = prec
    for kind in ("gru", "lingru"):
        try:
            prec[kind] = bench_precision(kind, min(b0, 128), iters, model_overrides=over,
                                         device=dev)
        except Exception as e:  # report, never swallow
            prec[kind] = {"error": _error(e)}
        if progress is not None:
            progress(detail)

    if "kernels" in first:
        detail["kernels_windows_per_sec"] = first["kernels"]
    detail["windows_per_sec"] = best
    detail["best_batch"] = best_batch
    flops = model_flops_per_window(cfg)
    detail["model_flops_per_window"] = round(flops)
    detail["model_param_bytes"] = model_param_bytes(cfg)
    pbpw = model_param_bytes_per_window(cfg, best_batch or batches[0])
    detail["param_bytes_per_window"] = round(pbpw, 1)
    detail["flops_per_param_byte"] = round(flops / pbpw, 1)
    peak = _device_peak_flops(dev, dtype)
    if peak:
        detail["mfu_pct"] = round(100.0 * best * flops / peak, 2)
    return detail


def run_train_suite(
    batch: int = BATCH, progress=None, iters: Optional[int] = None, device="cuda",
    model_overrides: Optional[Dict] = None,
) -> Dict[str, Any]:
    """The train suite in the port's default compute dtype: ``train_gru``
    (the default model), ``train_scan_stress`` (4 layers, twice the
    hidden size: 256 at the default widths) and ``train_transformer``
    (``kind="transformer"``, ``d_model`` twice the hidden size), each with
    ``step_ms`` and ``windows_per_sec``, and the gru rows on an H100 with
    ``mfu_pct`` (the reference gives the transformer none); the
    reference's other rows as ``error`` strings that say why the port has
    no counterpart (:data:`UNPORTED_TRAIN_ROWS`)."""
    from roko_tpu_torch.config import ModelConfig, default_compute_dtype
    from roko_tpu_torch.infer import resolve_device

    dev = resolve_device(device)
    dtype = default_compute_dtype(dev.type)
    peak = _device_peak_flops(dev, dtype)
    iters = ITERS if iters is None else iters
    over = dict(model_overrides or {})
    hidden = ModelConfig(**over).hidden_size
    out: Dict[str, Any] = {"batch": batch, "iterations": iters, "compute_dtype": dtype}
    suites = {
        "train_gru": ModelConfig(compute_dtype=dtype, **over),
        "train_gru_remat": None,
        "train_gru_remat_scan": None,
        "train_gru_rbg": None,
        "train_scan_stress": ModelConfig(
            compute_dtype=dtype, **{**over, "num_layers": 4, "hidden_size": 2 * hidden}),
        "train_transformer": ModelConfig(
            compute_dtype=dtype, **{**over, "kind": "transformer", "d_model": 2 * hidden}),
        "train_gru_pallas": None,
    }
    for name, cfg in suites.items():
        if cfg is None:
            out[name] = {"error": UNPORTED_TRAIN_ROWS[name]}
            continue
        try:
            r = bench_train(cfg, batch, iters, device=dev)
            r["windows_per_sec"] = round(r["windows_per_sec"], 1)
            r["step_ms"] = round(r["step_ms"], 2)
            if peak and cfg.kind == "gru":
                flops = model_flops_per_window(cfg, training=True)
                r["mfu_pct"] = round(100.0 * r["windows_per_sec"] * flops / peak, 2)
            out[name] = r
        except Exception as e:  # report, never swallow
            out[name] = {"error": _error(e)}
        if progress is not None:
            progress(out)
    out["input_stall"] = {"error": UNPORTED_TRAIN_ROWS["input_stall"]}
    return out


#: mesh suite: rank counts (--mesh-devices), timed iterations
#: (--bench-iterations overrides), and the fixed global batch every count
#: shards (divisible by every default count)
DEFAULT_MESH_DEVICES = (1, 2, 4)
MESH_SUITE_ITERS = 8
MESH_SUITE_GLOBAL_BATCH = 128


def parse_counts(text: Optional[str]) -> Tuple[int, ...]:
    """``--mesh-devices``: "1,2,4" -> (1, 2, 4); None, "", "0" or "off" -> ()."""
    if text is None or str(text).strip() in ("", "0", "off"):
        return ()
    return tuple(int(t) for t in str(text).split(",") if t.strip())


def _mesh_child(spec_path: str) -> None:
    """One rank of :func:`run_mesh_suite`, in a process of its own: joins
    the count's process group (``ROKO_*`` from the parent; none for one
    rank), predicts its rows of the fixed global batch through the port's
    forward and argmax (``infer.predict``, host windows in, host class ids
    out), untimed once and then ``iterations`` times between barriers, and
    writes its time, its class ids and its kernel launches."""
    import dataclasses

    import torch

    from roko_tpu_torch import constants as C
    from roko_tpu_torch.config import ModelConfig
    from roko_tpu_torch.infer import predict, resolve_device, use_float32_matmuls
    from roko_tpu_torch.models import fused_gru as fg
    from roko_tpu_torch.models import fused_lingru as fl
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.parallel import distributed
    from roko_tpu_torch.parallel.mesh import make_mesh, shard_batch

    with open(spec_path) as f:
        spec = json.load(f)
    dev = resolve_device(spec["device"])
    distributed.initialize(device=dev, backend=spec.get("backend"))
    dev = distributed.device_of_rank(dev)
    mesh = make_mesh()
    use_float32_matmuls()
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in (spec.get("model") or {}).items()}
    cfg = dataclasses.replace(ModelConfig(), **over)
    model = RokoModel(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    gb = int(spec["global_batch"])
    rng = np.random.default_rng(0)  # the same windows in every rank and count
    x = rng.integers(0, C.FEATURE_VOCAB, (gb, cfg.window_rows, cfg.window_cols)).astype(np.uint8)
    (mine,) = shard_batch(mesh, (x,))
    preds = predict(model, mine, dev).cpu().numpy()  # the first dispatch, outside the clock
    counters = {"gru_fwd": (fg.gru_recurrence, "launches"),
                "lingru_fwd": (fl.lingru_scan, "launches"),
                "gru_fwd_bf16": (fg.gru_recurrence, "launches_bf16"),
                "lingru_fwd_bf16": (fl.lingru_scan, "launches_bf16")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    iters = int(spec["iterations"])
    distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        predict(model, mine, dev).cpu()
    wall = time.perf_counter() - t0
    distributed.barrier()
    np.save(f"{spec['out']}.rank{mesh.rank}.npy", preds)
    with open(f"{spec['out']}.rank{mesh.rank}.json", "w") as f:
        json.dump({"wall_s": wall, "rows": len(mine),
                   "launches": {k: getattr(fn, a) for k, (fn, a) in counters.items()}}, f)
    distributed.shutdown()


def _mesh_backend(n: int, device: str) -> Tuple[Optional[str], str]:
    """(backend, what ran) for ``n`` ranks on ``device``: one rank needs
    no group; ranks that fit the cards run NCCL, ranks that share a card
    gloo (NCCL refuses two ranks on one card)."""
    if device == "cpu":
        return (None, "cpu (1 rank)") if n == 1 else ("gloo", f"cpu ({n} ranks, gloo)")
    import torch

    cards = torch.cuda.device_count()
    used = min(n, cards)
    if n == 1:
        return None, "1 rank on 1 card"
    backend = "nccl" if n <= cards else "gloo"
    return backend, f"{n} ranks on {used} card{'s' if used > 1 else ''} ({backend})"


def run_mesh_suite(
    device_counts=DEFAULT_MESH_DEVICES,
    iterations: Optional[int] = None,
    global_batch: int = MESH_SUITE_GLOBAL_BATCH,
    child_budget_s: float = 900.0,
    device: str = "cuda",
    model_overrides: Optional[Dict] = None,
) -> Dict[str, Any]:
    """Windows/s of the same fixed global batch split over 1, 2 and 4
    ranks (``roko_tpu/benchmark.py:2163-2300``): each count is a fresh
    group of that many child processes, each predicting its rows. The
    reference simulated devices on the CPU; the port's ranks are real
    processes, and on a machine with fewer cards than ranks they share
    the cards through gloo, which adds no silicon: the ideal efficiency
    is then 1.0, as on the reference's simulated devices.

    Rows: ``devices`` (ranks), ``per_device_batch``, ``wall_s`` (the
    slowest rank's), ``windows_per_sec``, ``preds_sha256`` of the class
    ids of the whole global batch in rank order, ``backend`` and each
    rank's kernel launches. ``scaling_efficiency`` is windows/s at N over
    windows/s at the smallest count (``efficiency_vs_devices``), and
    ``byte_identical`` whether every count predicted the same bytes; when
    one does not, its row says how many (window, column) class ids differ
    from the smallest count's."""
    import hashlib
    import tempfile

    counts = tuple(sorted(set(int(c) for c in device_counts)))
    bad = [c for c in counts if c < 1 or global_batch % c]
    if bad:
        raise ValueError(f"mesh suite device counts {bad} must be >= 1 and divide the fixed "
                         f"global batch {global_batch}")
    iters = iterations or MESH_SUITE_ITERS
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results: Dict[str, Any] = {"device_counts": list(counts), "global_batch": global_batch,
                               "iterations": iters, "rows": {}}
    preds: Dict[int, np.ndarray] = {}
    with tempfile.TemporaryDirectory() as td:
        for n in counts:
            backend, what = _mesh_backend(n, device)
            out = os.path.join(td, f"mesh{n}")
            spec = {"global_batch": global_batch, "iterations": iters, "out": out,
                    "device": device, "backend": backend, "model": model_overrides or {}}
            spec_path = f"{out}.spec.json"
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            env = {k: v for k, v in os.environ.items() if not k.startswith("ROKO_")}
            if n > 1:
                import socket

                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                env.update(ROKO_COORDINATOR=f"127.0.0.1:{port}", ROKO_NUM_PROCESSES=str(n))
            cmd = [sys.executable, "-c", "import sys; from roko_tpu_torch.benchmark import "
                   "_mesh_child; _mesh_child(sys.argv[1])", spec_path]
            procs = [subprocess.Popen(cmd, cwd=repo_root, env={**env, "ROKO_PROCESS_ID": str(r)},
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for r in range(n)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=child_budget_s)[0])
            finally:
                for p in procs:
                    p.kill()
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    raise RuntimeError(f"mesh suite child (rank {r} of {n}) rc={p.returncode}; "
                                       f"log tail:\n{logs[r][-800:] if r < len(logs) else ''}")
            ranks = []
            for r in range(n):
                with open(f"{out}.rank{r}.json") as f:
                    ranks.append(json.load(f))
            preds[n] = np.concatenate([np.load(f"{out}.rank{r}.npy") for r in range(n)])
            wall = max(rk["wall_s"] for rk in ranks)
            results["rows"][str(n)] = {
                "devices": n, "global_batch": global_batch,
                "per_device_batch": global_batch // n, "iterations": iters, "backend": what,
                "wall_s": wall, "windows_per_sec": iters * global_batch / max(wall, 1e-9),
                "preds_sha256": hashlib.sha256(np.ascontiguousarray(preds[n]).tobytes()
                                               ).hexdigest(),
                "launches_by_rank": [rk["launches"] for rk in ranks],
            }
    base = counts[0]
    for n in counts[1:]:
        differ = int((preds[n] != preds[base]).sum())
        if differ:
            results["rows"][str(n)]["columns_differing"] = differ
    results["byte_identical"] = len({r["preds_sha256"] for r in results["rows"].values()}) == 1
    results["backend"] = "; ".join(f"{n}: {results['rows'][str(n)]['backend']}" for n in counts)
    results["efficiency_vs_devices"] = base
    base_wps = results["rows"][str(base)]["windows_per_sec"]
    results["scaling_efficiency"] = {
        str(n): results["rows"][str(n)]["windows_per_sec"] / base_wps for n in counts[1:]}
    return results


def ported_errors(result: Dict[str, Any]) -> List[str]:
    """The errors in rows of the ported suites of a bench result, as
    ``"path.to.row: error"``: every ``error`` or ``*_error`` entry of
    ``detail`` outside :data:`UNPORTED_SUITES`, the train suite's
    :data:`UNPORTED_TRAIN_ROWS` and the ``--compare`` block."""
    found: List[str] = []

    def walk(node: Any, path: str) -> None:
        if not isinstance(node, dict):
            return
        for key, value in node.items():
            where = f"{path}.{key}" if path else key
            if key == "error" or key.endswith("_error"):
                found.append(f"{where}: {value}")
            else:
                walk(value, where)

    detail = result.get("detail") or {}
    for key, value in detail.items():
        if key in UNPORTED_SUITES or key == "vs_previous":
            continue
        if key == "train" and isinstance(value, dict):
            walk({k: v for k, v in value.items() if k not in UNPORTED_TRAIN_ROWS}, key)
        else:
            walk({key: value}, "")
    return found


def _git_rev() -> str:
    """Short sha of the measured tree; 'unknown' outside a git checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _measure(args, model_overrides: Optional[Dict] = None) -> Dict[str, Any]:
    """Run the suites in this process on ``args.device`` and return the
    result object: the inference suite, the train suite with ``--train``,
    the unported suites as errors, the torch reference on the host CPU and
    the environment. Raises when ``args.device`` is cuda and there is no
    card."""
    import torch

    from roko_tpu_torch.infer import resolve_device

    dev = resolve_device(args.device)
    t_start = time.perf_counter()

    def _stamp(suite: str) -> None:
        print(f"[bench] +{time.perf_counter() - t_start:7.1f}s {suite}", file=sys.stderr,
              flush=True)

    bench_iters = args.bench_iterations
    _stamp("inference suite (batch sweep)")
    detail = run_inference_suite(args.batch, iters=bench_iters, device=dev,
                                 model_overrides=model_overrides)
    if args.train:
        _stamp("train suite")
        detail["train"] = run_train_suite(args.batch or BATCH, iters=bench_iters, device=dev,
                                          model_overrides=model_overrides)
    mesh_devices = parse_counts(getattr(args, "mesh_devices", None))
    if mesh_devices:
        _stamp(f"mesh suite (ranks {mesh_devices})")
        try:
            detail["mesh"] = run_mesh_suite(mesh_devices, iterations=bench_iters,
                                            device=dev.type, model_overrides=model_overrides)
        except Exception as e:  # report, never swallow
            detail["mesh"] = {"error": _error(e)}
    for key, (item, why) in UNPORTED_SUITES.items():
        detail[key] = {"error": f"not ported yet (ROADMAP queue item {item}): {why}"}
    _stamp("torch reference")
    ref_windows_per_sec = bench_torch_reference()
    detail["env"] = {
        "backend": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "git": _git_rev(),
    }
    return _assemble_result(detail, ref_windows_per_sec)


def _assemble_result(detail: Dict[str, Any], ref_windows_per_sec: float) -> Dict[str, Any]:
    """The result's top-level shape, the reference's."""
    from roko_tpu_torch import constants as C

    # the ratio of the two numbers the detail records, so that it can be
    # recomputed from them
    ref = detail["torch_cpu_ref_windows_per_sec"] = round(ref_windows_per_sec, 1)
    windows_per_sec = detail["windows_per_sec"]
    return {
        "metric": "polished_bases_per_sec_per_chip",
        "value": round(windows_per_sec * C.WINDOW_STRIDE, 1),
        "unit": "bases/s",
        "vs_baseline": round(windows_per_sec / ref, 2),
        "detail": detail,
    }


def compare_to_previous(
    result: Dict[str, Any], prev: Dict[str, Any], noise_band_pct: float = NOISE_BAND_PCT,
) -> Dict[str, Any]:
    """Attach a ``detail.vs_previous`` block comparing this result's
    headline metrics with a previous one's, as the reference's does, on the
    keys the port's suites write: ``value``, ``vs_baseline``, the sweep's
    best ``windows_per_sec`` and its ``kernels`` column, each kind's
    ``kernels`` row and the precision column. Each metric gets its current,
    previous and delta_pct, ``noise`` when the delta is inside the band,
    and ``regression`` for a drop beyond it. A suite ported later adds its
    pairs here."""
    cur_d = result.get("detail") or {}
    prev_d = prev.get("detail") or {}
    pairs: Dict[str, Tuple[Any, Any]] = {
        "value": (result.get("value"), prev.get("value")),
        "vs_baseline": (result.get("vs_baseline"), prev.get("vs_baseline")),
    }
    for col in ("windows_per_sec", "kernels_windows_per_sec"):
        pairs[col] = (cur_d.get(col), prev_d.get(col))
    for kind, row in (cur_d.get("model_kinds") or {}).items():
        prow = (prev_d.get("model_kinds") or {}).get(kind) or {}
        pairs[f"model_kinds.{kind}.kernels_windows_per_sec"] = (
            (row or {}).get("kernels_windows_per_sec"), prow.get("kernels_windows_per_sec"))
    for kind, row in (cur_d.get("precision") or {}).items():
        prow = (prev_d.get("precision") or {}).get(kind) or {}
        for col in ("f32_windows_per_sec", "bf16_windows_per_sec", "int8_windows_per_sec"):
            pairs[f"precision.{kind}.{col}"] = ((row or {}).get(col), prow.get(col))
    # the mesh rows: windows/s at each rank count on the same global work
    for n, row in ((cur_d.get("mesh") or {}).get("rows") or {}).items():
        prow = ((prev_d.get("mesh") or {}).get("rows") or {}).get(n) or {}
        pairs[f"mesh.{n}.windows_per_sec"] = ((row or {}).get("windows_per_sec"),
                                              prow.get("windows_per_sec"))
    metrics: Dict[str, Any] = {}
    for name, (cur, old) in pairs.items():
        if not isinstance(cur, (int, float)) or not isinstance(old, (int, float)) or not old:
            continue
        delta_pct = 100.0 * (cur - old) / old
        row = {"current": cur, "previous": old, "delta_pct": round(delta_pct, 2),
               "noise": abs(delta_pct) < noise_band_pct}
        if delta_pct <= -noise_band_pct:
            row["regression"] = True
        metrics[name] = row
    block = {
        "noise_band_pct": noise_band_pct,
        "iterations": cur_d.get("iterations"),
        "previous_iterations": prev_d.get("iterations"),
        "compute_dtype": cur_d.get("compute_dtype"),
        "previous_compute_dtype": prev_d.get("compute_dtype"),
        "metrics": metrics,
    }
    cur_dtype, prev_dtype = block["compute_dtype"], block["previous_compute_dtype"]
    if cur_dtype is not None and prev_dtype != cur_dtype:
        block["regime_change"] = (
            f"headline compute dtype is {cur_dtype!r} but the previous "
            f"artifact's was {prev_dtype!r}"
            + (" (absent = pre-precision-plane artifact; its CPU "
               "headline measured emulated bfloat16)" if prev_dtype is None else "")
            + " — deltas reflect the dtype change, not a code regression"
        )
    result.setdefault("detail", {})["vs_previous"] = block
    return block


def _apply_compare(result: Dict[str, Any], compare_path: str) -> None:
    """``--compare``: an unreadable previous result is reported inside the
    result, never allowed to void it."""
    try:
        with open(compare_path) as f:
            prev = json.load(f)
    except (OSError, ValueError) as e:
        result.setdefault("detail", {})["vs_previous"] = {
            "error": f"could not read {compare_path!r}: {e}"[:300]
        }
        return
    block = compare_to_previous(result, prev)
    block["file"] = compare_path


def _emit(result: Dict[str, Any], out_path) -> None:
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    print(json.dumps(result), flush=True)


def _given(value: Any) -> bool:
    """Whether an unported suite's flag asks for its suite: set, and not 0
    (the reference's off value; a ladder of "0" is off too)."""
    if value is None or value is False:
        return False
    if isinstance(value, str):
        return value.strip() not in ("", "0", "off")
    return value != 0


def unported_flag(args: argparse.Namespace) -> Optional[str]:
    """The usage error for the first flag of ``args`` that asks for a
    suite the port lacks, naming its ROADMAP queue item; None if none
    does."""
    for attr, (flag, item) in UNPORTED_FLAGS.items():
        if not _given(getattr(args, attr, None)):
            continue
        if item is None:
            return (f"bench {flag}: the port always measures in process; the probe and CPU "
                    "fallback the flag skips are deliberately not ported")
        return f"bench {flag} is not ported yet (queue item {item} of ROADMAP.md)"
    return None


def add_mesh_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh-devices", default=None,
                   help="mesh suite: rank counts that split one fixed global batch of "
                   f"{MESH_SUITE_GLOBAL_BATCH}, e.g. 1,2,4 (windows/s, scaling efficiency and "
                   "byte-identity of the class ids across counts); 0 or absent: off")


def add_unported_flags(p: argparse.ArgumentParser) -> None:
    """The reference's flags of unported suites, so that they parse and
    :func:`unported_flag` can name their queue item."""
    p.add_argument("--features", action="store_true", help="not ported yet (queue item A11b)")
    for flag, kind, item in (("--e2e-draft", int, "A11b"), ("--pipeline-draft", int, "A11b"),
                             ("--cascade-draft", int, "A10"),
                             ("--coldstart-ladder", str, "A9.3"), ("--input-rows", int, "A11b"),
                             ("--fleet-workers", str, "A9")):
        p.add_argument(flag, type=kind, default=None, help=f"not ported yet (queue item {item})")
    p.add_argument("--in-process", action="store_true",
                   help="deliberately not ported: bench always measures in process")


def main(argv: Optional[List[str]] = None, model_overrides: Optional[Dict] = None) -> int:
    """``python -m roko_tpu_torch bench``: prints the result line, writes it
    to ``--out``; returns 1 when a row of a ported suite holds an error.
    ``model_overrides`` (for tests) replaces fields of every suite's model
    config."""
    ap = argparse.ArgumentParser(prog="python -m roko_tpu_torch bench")
    ap.add_argument("--train", action="store_true", help="also time training steps")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"exact batch to bench (default: sweep {SWEEP_BATCHES} on a card)")
    ap.add_argument("--out", default=None, help="write the full result dict to this JSON file")
    ap.add_argument("--bench-iterations", type=int, default=None,
                    help="fixed-work mode: pin the timed iteration count of the suites "
                    "(recorded in the result)")
    ap.add_argument("--compare", default=None, metavar="BENCH_JSON",
                    help="previous result to compare against: adds detail.vs_previous with "
                    f"moves inside the {NOISE_BAND_PCT:.0f}%% band flagged noise=true, and "
                    "defaults the run to fixed-work --bench-iterations")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default cuda; no card is an error)")
    add_mesh_flag(ap)
    add_unported_flags(ap)
    args = ap.parse_args(argv)
    msg = unported_flag(args)
    if msg:
        ap.error(msg)
    if args.compare and args.bench_iterations is None:
        args.bench_iterations = ITERS
    result = _measure(args, model_overrides)
    if args.compare:
        _apply_compare(result, args.compare)
    _emit(result, args.out)
    errors = ported_errors(result)
    if errors:
        print("bench: rows of ported suites failed:\n  " + "\n  ".join(errors),
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
