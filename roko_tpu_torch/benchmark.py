"""Benchmarks of the port: ``python -m roko_tpu_torch bench``.

Counterpart of ``roko_tpu/benchmark.py`` for the suites that run on the
port's modules: the inference batch sweep (:383), the per-kind rows, the
recurrence alone (:178), the precision column (:215), with
``--train`` the train suite (:575), with ``--mesh-devices`` the mesh
suite (:2163, the same global batch split over 1, 2 and 4 processes,
``parallel/``), and with ``--serve-mix`` the serve suite (:2402, the
deadline, continuous and ragged batchers under one mixed-size closed-loop
schedule, and the autoscaler's row, ``serve/``), with ``--coldstart-ladder``
the coldstart suite (:2069, time to first prediction of four start modes,
each a child process: cold build directory, cold with the rungs at once,
warm build cache, kernel bundle; ``compile/``) and with
``--fleet-workers`` the fleet suite (:2809, a supervised fleet of serve
processes under closed-loop load, and a worker SIGKILLed under it, and
with ``--serve-mix`` too its mixed-size phase, :3047, both batchers on
one seeded schedule; ``serve/fleet.py``). Driver contract, as the reference's:
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
    "input": ("A11b", "it writes an HDF5 corpus, and the card machine has no h5py"),
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
    "input_rows": ("--input-rows", "A11b"),
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
    rank) and builds ONE ``PolishSession`` over the ranks with the fixed
    global batch as its one rung (``roko_tpu/benchmark.py:2168-2230``).
    Rank 0 warms it and predicts the batch once outside the clock, then
    ``iterations`` times on the clock; the other ranks follow. Between the
    two, rank 0 stops the followers' loop, so every rank zeroes its kernel
    launch counts before the timed dispatches. Rank 0 writes the time and
    the class ids of the whole batch, every rank its launches."""
    import dataclasses

    import torch

    from roko_tpu_torch import constants as C
    from roko_tpu_torch.config import ModelConfig, RokoConfig
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.models import fused_gru as fg
    from roko_tpu_torch.models import fused_lingru as fl
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.parallel import distributed
    from roko_tpu_torch.parallel.mesh import make_mesh
    from roko_tpu_torch.serve.session import PolishSession

    with open(spec_path) as f:
        spec = json.load(f)
    dev = resolve_device(spec["device"])
    distributed.initialize(device=dev, backend=spec.get("backend"))
    dev = distributed.device_of_rank(dev)
    mesh = make_mesh()
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in (spec.get("model") or {}).items()}
    cfg = dataclasses.replace(ModelConfig(), **over)
    model = RokoModel(cfg, generator=torch.Generator().manual_seed(0))
    gb = int(spec["global_batch"])
    session = PolishSession(model, RokoConfig(model=cfg), device=dev, mesh=mesh, ladder=(gb,))
    session.warmup()
    rng = np.random.default_rng(0)  # the same windows in every count
    x = rng.integers(0, C.FEATURE_VOCAB, (gb, cfg.window_rows, cfg.window_cols)).astype(np.uint8)
    counters = {"gru_fwd": (fg.gru_recurrence, "launches"),
                "lingru_fwd": (fl.lingru_scan, "launches"),
                "gru_fwd_bf16": (fg.gru_recurrence, "launches_bf16"),
                "lingru_fwd_bf16": (fl.lingru_scan, "launches_bf16")}
    iters = int(spec["iterations"])
    out: Dict[str, Any] = {"mesh_dp": session.dp}
    if session.leader:
        preds = session.predict(x)  # the proving dispatch, outside the clock
        session.stop()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        for _ in range(iters):
            session.predict(x)
        out["wall_s"] = time.perf_counter() - t0
        session.stop()
        np.save(f"{spec['out']}.rank0.npy", preds)
    else:
        session.follow()  # the warmup and the proving dispatch
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        session.follow()
    out["launches"] = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
    with open(f"{spec['out']}.rank{mesh.rank}.json", "w") as f:
        json.dump(out, f)
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
    group of that many child processes running ONE polishing session over
    them (rank 0 dispatches, the others follow; ``serve/session.py``).
    The reference simulated devices on the CPU; the port's ranks are real
    processes, and on a machine with fewer cards than ranks they share
    the cards through gloo, which adds no silicon: the ideal efficiency
    is then 1.0, as on the reference's simulated devices.

    Rows: ``devices`` (ranks), ``mesh_dp``, ``per_device_batch``,
    ``wall_s`` (rank 0's, its session's global dispatches, the host
    collectives included), ``windows_per_sec``, ``preds_sha256`` of the
    class ids of the whole global batch as rank 0 gathered them,
    ``backend`` and each rank's kernel launches. ``scaling_efficiency``
    is windows/s at N over windows/s at the smallest count
    (``efficiency_vs_devices``), and
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
            preds[n] = np.load(f"{out}.rank0.npy")
            wall = ranks[0]["wall_s"]
            results["rows"][str(n)] = {
                "devices": n, "mesh_dp": ranks[0]["mesh_dp"], "global_batch": global_batch,
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


#: coldstart suite: the ladder the reference measures by default (:1978)
DEFAULT_COLDSTART_LADDER = (2, 4, 6, 8)


def _child_model(spec: Dict[str, Any]):
    """(RokoConfig, RokoModel) of a suite child: the default config with
    the spec's model overrides, seeded weights."""
    import dataclasses

    import torch

    from roko_tpu_torch.config import ModelConfig, RokoConfig
    from roko_tpu_torch.models.model import RokoModel

    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in (spec.get("model") or {}).items()}
    cfg = RokoConfig(model=dataclasses.replace(ModelConfig(), **over))
    return cfg, RokoModel(cfg.model, generator=torch.Generator().manual_seed(0))


def _coldstart_child(spec_path: str) -> None:
    """One start of :func:`run_coldstart_suite`, in a process of its own
    (the kernel build directory comes from the ``ROKO_COMPILE_CACHE`` the
    parent set): ``export`` writes the bundle; ``measure`` builds a
    session (from the bundle when the spec names one), warms its ladder
    and predicts one batch, timing both."""
    import dataclasses

    from roko_tpu_torch import constants as C
    from roko_tpu_torch.compile import cache_counters, enable_persistent_cache, export_bundle
    from roko_tpu_torch.config import CompileConfig
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.serve.session import PolishSession

    t_start = time.perf_counter()
    with open(spec_path) as f:
        spec = json.load(f)
    ladder = tuple(spec["ladder"])
    cfg, model = _child_model(spec)
    cfg = dataclasses.replace(
        cfg, serve=dataclasses.replace(cfg.serve, ladder=ladder),
        compile=CompileConfig(bundle_dir=spec.get("bundle"),
                              parallel_warmup=spec.get("parallel", True)))
    dev = resolve_device(spec["device"])
    if spec["mode"] == "export":
        t0 = time.perf_counter()
        export_bundle(spec["bundle_out"], cfg, ladder=ladder, device=dev, log=lambda m: None)
        out: Dict[str, Any] = {"export_s": round(time.perf_counter() - t0, 3)}
    else:
        enable_persistent_cache(cfg.compile)
        session = PolishSession(model, cfg, device=dev)
        t0 = time.perf_counter()
        session.warmup(parallel=spec.get("parallel", True))
        warmup_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        x = rng.integers(0, C.FEATURE_VOCAB, (ladder[0], C.WINDOW_ROWS, C.WINDOW_COLS)
                         ).astype(np.uint8)
        t1 = time.perf_counter()
        session.predict(x)
        first_s = time.perf_counter() - t1
        hits, misses = cache_counters()
        from roko_tpu_torch.kernels import forward_launches

        out = {
            "launches": forward_launches(),
            "warmup_s": round(warmup_s, 3),
            "first_predict_s": round(first_s, 3),
            # params ready -> first prediction back on the host
            "ttfp_s": round(warmup_s + first_s, 3),
            # the child's own start (torch import and card init included)
            "process_ttfp_s": round(time.perf_counter() - t_start, 3),
            "warmup": session.warmup_report.as_dict(),
            "compile_cache_hits": hits, "compile_cache_misses": misses,
        }
    tmp = spec["out"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, spec["out"])


def run_coldstart_suite(
    ladder=DEFAULT_COLDSTART_LADDER,
    child_budget_s: float = 900.0,
    device: str = "cuda",
    model_overrides: Optional[Dict] = None,
) -> Dict[str, Any]:
    """Time to first prediction of the same serve ladder under four start
    modes, each in a fresh child process (``roko_tpu/benchmark.py:2069``):

    - ``cold``          — an empty kernel build directory
      (``ROKO_COMPILE_CACHE=<tmp>``, never the shared one), the rungs
      warmed one by one: nvcc runs for every library the model launches;
    - ``cold_parallel`` — the cache off (a fresh directory), the rungs
      warmed at once; ``kernels.build`` starts one nvcc per source
      together (a model of one kind and dtype launches one library);
    - ``warm_cache``    — the second start on ``cold``'s directory: the
      libraries load, no nvcc;
    - ``aot``           — the kernel bundle, with the cache off: its
      libraries load, no nvcc (``export_seconds`` is what writing it
      cost, once, in a child of its own on ``cold``'s directory).

    Each row has ``ttfp_s`` (warmup + first predict), ``process_ttfp_s``
    (the child's start included), the warmup report and the build cache's
    hits and misses; ``speedup_*`` is ``cold``'s ttfp over the mode's."""
    import tempfile

    results: Dict[str, Any] = {"ladder": list(ladder), "device": device}
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as td:
        cache = os.path.join(td, "kernel-cache")
        bundle = os.path.join(td, "bundle")

        def child(tag: str, mode: str, cache_env: str, use_bundle: bool, parallel: bool = True):
            spec = {"mode": mode, "ladder": list(ladder), "out": os.path.join(td, f"{tag}.json"),
                    "bundle_out": bundle, "parallel": parallel, "device": device,
                    "model": model_overrides or {}}
            if use_bundle:
                spec["bundle"] = bundle
            spec_path = os.path.join(td, f"{tag}.spec.json")
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            env = dict(os.environ, ROKO_COMPILE_CACHE=cache_env)
            cmd = [sys.executable, "-c", "import sys; from roko_tpu_torch.benchmark import "
                   "_coldstart_child; _coldstart_child(sys.argv[1])", spec_path]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=repo_root, env=env, capture_output=True, text=True,
                                  timeout=child_budget_s)
            if proc.returncode != 0:
                raise RuntimeError(f"coldstart child {tag} rc={proc.returncode}; log tail:\n"
                                   f"{(proc.stdout + proc.stderr)[-800:]}")
            with open(spec["out"]) as f:
                row = json.load(f)
            row["spawn_to_result_s"] = round(time.perf_counter() - t0, 3)
            return row

        results["cold"] = child("cold", "measure", cache, False, parallel=False)
        results["cold_parallel"] = child("coldp", "measure", "off", False)
        results["warm_cache"] = child("warm", "measure", cache, False)
        # the export on cold's directory: its library is found built
        results["export_seconds"] = child("export", "export", cache, False)["export_s"]
        results["aot"] = child("aot", "measure", "off", True)
    for key in ("cold_parallel", "warm_cache", "aot"):
        denom = results[key]["ttfp_s"]
        if denom > 0:
            results[f"speedup_{key}"] = round(results["cold"]["ttfp_s"] / denom, 2)
    return results


#: fleet suite (:2326-2330): closed-loop requests a client, clients, and
#: windows a request
FLEET_ITERS = 25
FLEET_CLIENTS = 3
FLEET_REQUEST_WINDOWS = 8


class _FleetBench:
    """What the fleet suite's phases share, inside one temporary
    directory: the config (one rung of :data:`FLEET_REQUEST_WINDOWS`, fast
    heartbeats), the seeded checkpoint, one request of that size, the
    seeded stream its payloads come from (the reference's draws, in its
    order), and supervised fleets of real ``serve`` worker processes, one
    rank each (on a card they share it, ``devices_per_worker`` 0).
    ``state_dict`` replaces the seeded weights."""

    def __init__(self, td: str, device: str, model_overrides: Optional[Dict],
                 startup_budget_s: float, state_dict: Optional[Dict] = None):
        import dataclasses

        import torch

        from roko_tpu_torch import constants as C

        cfg, model = _child_model({"model": model_overrides or {}})
        self.cfg = dataclasses.replace(
            cfg,
            serve=dataclasses.replace(cfg.serve, ladder=(FLEET_REQUEST_WINDOWS,),
                                      max_delay_ms=5.0),
            fleet=dataclasses.replace(cfg.fleet, heartbeat_interval_s=0.25,
                                      heartbeat_timeout_s=5.0, stable_after_s=1.0,
                                      restart_base_delay_s=0.1,
                                      spawn_deadline_s=startup_budget_s))
        self.td, self.device, self.startup_budget_s = td, device, startup_budget_s
        self.rng = rng = np.random.default_rng(0)
        self.rows, self.cols = self.cfg.model.window_rows, self.cfg.model.window_cols
        self.stride = self.cfg.window.stride
        n_win = FLEET_REQUEST_WINDOWS
        self.x = rng.integers(0, C.FEATURE_VOCAB, (n_win, self.rows, self.cols)).astype(np.uint8)
        self.positions = self.positions_of(n_win)
        self.draft = "".join(rng.choice(list("ACGT"), (n_win - 1) * self.stride + self.cols + 10))
        self.ckpt = os.path.join(td, "model.pth")
        torch.save(model.state_dict() if state_dict is None else state_dict, self.ckpt)
        self.cfg_path = self.write_worker_cfg(self.cfg, "worker-config.json")

    def positions_of(self, n: int) -> np.ndarray:
        positions = np.zeros((n, self.cols, 2), np.int64)
        for i in range(n):
            positions[i, :, 0] = np.arange(i * self.stride, i * self.stride + self.cols)
        return positions

    def write_worker_cfg(self, cfg, name: str) -> str:
        """The workers' config file (``fleet.workers`` 0: no recursion)."""
        import dataclasses

        path = os.path.join(self.td, name)
        with open(path, "w") as f:
            f.write(dataclasses.replace(
                cfg, fleet=dataclasses.replace(cfg.fleet, workers=0)).to_json())
        return path

    def start(self, n: int, run_cfg=None, worker_cfg_path: Optional[str] = None, tag: str = ""):
        """A fleet of ``n`` ready workers and its front end:
        ``(fleet, server, thread, ready seconds)``."""
        import dataclasses
        import threading

        from roko_tpu_torch.serve.fleet import Fleet
        from roko_tpu_torch.serve.supervisor import make_front_server, worker_command

        fcfg = dataclasses.replace(run_cfg or self.cfg,
                                   fleet=dataclasses.replace(self.cfg.fleet, workers=n))
        fleet = Fleet(fcfg, worker_command(self.ckpt, worker_cfg_path or self.cfg_path,
                                           self.device),
                      runtime_dir=os.path.join(self.td, f"fleet-{tag}{n}"), log=lambda m: None)
        fleet.start()
        # the front end binds only once the workers are ready
        deadline = time.monotonic() + self.startup_budget_s
        t0 = time.perf_counter()
        while fleet.ready_count() < n:
            if time.monotonic() > deadline:
                fleet.stop(rolling=False)
                raise RuntimeError(
                    f"fleet of {n} not ready within {self.startup_budget_s:.0f}s")
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        server = make_front_server(fleet, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return fleet, server, thread, ready_s

    @staticmethod
    def stop(fleet, server, thread) -> None:
        server.shutdown()
        server.server_close()
        thread.join(10.0)
        fleet.stop(rolling=False)


def run_fleet_suite(
    worker_counts=(1, 2),
    iterations: int = FLEET_ITERS,
    clients: int = FLEET_CLIENTS,
    device: str = "cuda",
    model_overrides: Optional[Dict] = None,
    startup_budget_s: float = 600.0,
    mix: Optional[str] = None,
) -> Dict[str, Any]:
    """Saturation and fault tolerance of the serving fleet
    (``roko_tpu/benchmark.py:2809``): fixed-work closed-loop load
    (``clients`` threads, ``iterations`` polish requests each) against a
    supervised fleet of real ``serve`` worker processes at each worker
    count, with req/s, p99 and mean latency and the 1 -> 2 worker scaling
    efficiency; then the same load with one worker SIGKILLed a quarter of
    the way in, where ``client_errors`` must stay 0 (failover) and the
    worker must rejoin. On a card the workers share it
    (``devices_per_worker`` 0). ``mix`` (an explicit ``--serve-mix``
    spec, checked before any fleet starts) adds the mixed-size phase at
    the top worker count (:func:`run_fleet_mixed_phase`):
    ``results["mixed"]``."""
    import tempfile
    import threading

    from roko_tpu_torch.serve.client import PolishClient

    # a typo'd --serve-mix fails here, not after minutes of measurement
    if mix:
        _parse_mix(mix)
    results: Dict[str, Any] = {"iterations": iterations, "clients": clients,
                               "windows_per_request": FLEET_REQUEST_WINDOWS, "device": device,
                               "workers": {}}

    with tempfile.TemporaryDirectory() as td:
        fb = _FleetBench(td, device, model_overrides, startup_budget_s)

        def drive(port: int, per_client: int, mid_action=None):
            """Closed-loop fixed work; ``mid_action(done)`` fires after
            every completed request (the kill phase hooks it)."""
            lat: list = []
            errors: list = []
            lock = threading.Lock()

            def one_client():
                client = PolishClient(f"http://127.0.0.1:{port}", timeout=300.0)
                for _ in range(per_client):
                    t0 = time.perf_counter()
                    try:
                        client.polish(fb.draft, fb.positions, fb.x, retries=8)
                    except Exception as e:
                        with lock:
                            errors.append(_error(e)[:200])
                    else:
                        with lock:
                            lat.append(time.perf_counter() - t0)
                    if mid_action is not None:
                        with lock:
                            done = len(lat) + len(errors)
                        mid_action(done)

            threads = [threading.Thread(target=one_client, daemon=True) for _ in range(clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return time.perf_counter() - t0, lat, errors

        for n in worker_counts:
            fleet, server, thread, ready_s = fb.start(n)
            try:
                port = server.server_address[1]
                drive(port, 1)  # untimed: first-dispatch costs off the clock
                wall, lat, errors = drive(port, iterations)
                row: Dict[str, Any] = {
                    "ready_s": round(ready_s, 3),
                    "req_per_s": round(clients * iterations / wall, 2),
                    "p99_s": round(float(np.percentile(lat, 99)), 4) if lat else None,
                    "mean_s": round(float(np.mean(lat)), 4) if lat else None,
                    "client_errors": len(errors),
                }
                if errors:
                    row["errors"] = errors[:5]
                results["workers"][str(n)] = row
            finally:
                fb.stop(fleet, server, thread)
        r1 = results["workers"].get("1", {}).get("req_per_s")
        r2 = results["workers"].get("2", {}).get("req_per_s")
        if r1 and r2:
            results["scaling_efficiency"] = round(r2 / (2 * r1), 3)

        # forced fault: SIGKILL one worker mid-load at the top count;
        # failover must keep client_errors at 0
        n_kill = max(worker_counts)
        if n_kill >= 2:
            fleet, server, thread, _ = fb.start(n_kill)
            try:
                port = server.server_address[1]
                drive(port, 1)
                total = clients * iterations
                killed = threading.Event()

                def kill_at_quarter(done: int) -> None:
                    if not killed.is_set() and done >= max(2, total // 4):
                        killed.set()
                        fleet.workers[0].proc.kill()

                wall, lat, errors = drive(port, iterations, mid_action=kill_at_quarter)
                rejoined = False
                deadline = time.monotonic() + startup_budget_s
                while time.monotonic() < deadline:
                    if fleet.ready_count() == n_kill:
                        rejoined = True
                        break
                    time.sleep(0.2)
                kill_row: Dict[str, Any] = {
                    "workers": n_kill,
                    "req_per_s_during_kill": round(total / wall, 2),
                    "p99_s": round(float(np.percentile(lat, 99)), 4) if lat else None,
                    "client_errors": len(errors),
                    "failovers": fleet.counter("failovers"),
                    "restarts": fleet.counter("restarts"),
                    "worker_rejoined": rejoined,
                }
                if errors:
                    kill_row["errors"] = errors[:5]
                results["forced_kill"] = kill_row
            finally:
                fb.stop(fleet, server, thread)

        if mix:
            results["mixed"] = run_fleet_mixed_phase(
                mix, max(worker_counts), iterations=iterations, clients=clients, bench=fb)
    return results


def run_fleet_mixed_phase(
    mix: str,
    workers: int = 2,
    iterations: int = FLEET_ITERS,
    clients: int = FLEET_CLIENTS,
    device: str = "cuda",
    model_overrides: Optional[Dict] = None,
    startup_budget_s: float = 600.0,
    bench: Optional[_FleetBench] = None,
    state_dict: Optional[Dict] = None,
) -> Dict[str, Any]:
    """The fleet suite's mixed-size phase (``roko_tpu/benchmark.py:
    3047-3199``): one seeded schedule of ``clients x iterations`` request
    sizes (:func:`_mix_schedule`) driven closed-loop through a fleet of
    ``workers`` real one-rank workers on the ladder
    ``sorted({FLEET_REQUEST_WINDOWS, largest size})``, once under the
    ``deadline`` batcher and once under ``continuous``: after one untimed
    request of each class, each mode's :func:`_mixed_latency_row` (req/s,
    p50 and p99 by size class) with ``client_errors``, and the
    ``padding_efficiency`` of the timed pass, the deltas of the workers'
    ``roko_serve_fill_windows_total`` over ``roko_serve_fill_padded_total``
    as the front's ``/metrics`` passes them through by worker, summed over
    the workers. Called by :func:`run_fleet_suite` with its ``bench``
    (the payloads continue its seeded stream), or alone (``state_dict``:
    the weights, default the seeded ones)."""
    import dataclasses
    import tempfile
    import threading
    import urllib.request

    from roko_tpu_torch import constants as C
    from roko_tpu_torch.serve.client import PolishClient

    mix_parsed = _parse_mix(mix)
    if bench is None:
        with tempfile.TemporaryDirectory() as td:
            return run_fleet_mixed_phase(
                mix, workers, iterations, clients,
                bench=_FleetBench(td, device, model_overrides, startup_budget_s, state_dict))
    fb, rng = bench, bench.rng
    large = max(s for s, _ in mix_parsed)
    mixed_ladder = tuple(sorted({FLEET_REQUEST_WINDOWS, large}))
    schedule = _mix_schedule(mix_parsed, clients * iterations)
    payloads = {}
    for size, _ in mix_parsed:
        mpos = fb.positions_of(size)
        mx = rng.integers(0, C.FEATURE_VOCAB, (size, fb.rows, fb.cols)).astype(np.uint8)
        payloads[size] = (mpos, mx)
    mixed_draft = "".join(rng.choice(list("ACGT"), (large - 1) * fb.stride + fb.cols + 10))
    out: Dict[str, Any] = {"mix": mix, "workers": workers, "requests": len(schedule),
                           "modes": {}}

    def drive_mixed(port: int, sched):
        work = list(sched)
        lat: Dict[int, list] = {s: [] for s, _ in mix_parsed}
        errors: list = []
        lock = threading.Lock()

        def one_client():
            client = PolishClient(f"http://127.0.0.1:{port}", timeout=300.0)
            while True:
                with lock:
                    if not work:
                        return
                    size = work.pop()
                mpos, mx = payloads[size]
                t0 = time.perf_counter()
                try:
                    client.polish(mixed_draft, mpos, mx, retries=8)
                except Exception as e:
                    with lock:
                        errors.append(_error(e)[:200])
                else:
                    with lock:
                        lat[size].append(time.perf_counter() - t0)

        threads = [threading.Thread(target=one_client, daemon=True) for _ in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0, lat, errors

    def scrape_fill(port: int) -> Dict[str, list]:
        """{worker: [windows, padded]} from the front's per-worker
        passthrough of the fill counters."""
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            text = r.read().decode()
        fill: Dict[str, list] = {}
        for line in text.splitlines():
            for i, name in enumerate(("roko_serve_fill_windows_total{",
                                      "roko_serve_fill_padded_total{")):
                if line.startswith(name):
                    wid = line.split('worker="')[1].split('"')[0]
                    fill.setdefault(wid, [0, 0])[i] = int(float(line.rsplit(" ", 1)[1]))
        return fill

    for mode in ("deadline", "continuous"):
        mode_cfg = dataclasses.replace(
            fb.cfg, serve=dataclasses.replace(fb.cfg.serve, ladder=mixed_ladder, batching=mode))
        fleet, server, thread, _ = fb.start(
            workers, run_cfg=mode_cfg,
            worker_cfg_path=fb.write_worker_cfg(mode_cfg, f"worker-{mode}.json"),
            tag=f"mix-{mode}-")
        try:
            port = server.server_address[1]
            drive_mixed(port, [s for s, _ in mix_parsed])  # untimed calibration, one a class
            fill0 = scrape_fill(port)
            wall, lat, errors = drive_mixed(port, schedule)
            row = _mixed_latency_row(wall, len(schedule), lat)
            row["client_errors"] = len(errors)
            if errors:
                row["errors"] = errors[:5]
            # the timed pass's own padding: the lifetime ratio would fold
            # in the calibration's heavily padded dispatches
            fill1 = scrape_fill(port)
            windows = sum(w - fill0.get(wid, [0, 0])[0] for wid, (w, _) in fill1.items())
            padded = sum(p - fill0.get(wid, [0, 0])[1] for wid, (_, p) in fill1.items())
            if padded > 0:
                row["padding_efficiency"] = round(windows / padded, 4)
            out["modes"][mode] = row
        finally:
            fb.stop(fleet, server, thread)
    return out


#: mixed-size serve suite (``roko_tpu/benchmark.py:2330-2339``): windows a
#: request : percent of requests, the card's mix and the CPU's (a
#: 256-window request would bury the scheduling signal in raw compute on
#: the host), total requests a batching mode (--bench-iterations
#: overrides) and closed-loop clients
SERVE_MIX_DEFAULT_TPU = "4:90,256:10"
SERVE_MIX_DEFAULT_CPU = "4:90,64:10"
SERVE_SUITE_REQUESTS = 48
SERVE_SUITE_CLIENTS = 6

#: rows of the reference's serve suite with no counterpart in the port
UNPORTED_SERVE_ROWS: Dict[str, str] = {}


def _parse_mix(spec: str):
    """``"4:90,256:10"`` -> ``((4, 90.0), (256, 10.0))``; the percents
    must sum to about 100."""
    out = []
    try:
        for part in spec.split(","):
            size, pct = part.split(":")
            out.append((int(size), float(pct)))
    except ValueError:
        raise ValueError(f"bad --serve-mix {spec!r}; want SIZE:PCT[,SIZE:PCT...] like "
                         "4:90,256:10") from None
    if not out or any(s <= 0 or p < 0 for s, p in out):
        raise ValueError(f"bad --serve-mix {spec!r}: sizes must be positive")
    total = sum(p for _, p in out)
    if not 99.0 <= total <= 101.0:
        raise ValueError(f"--serve-mix percents sum to {total:g}, want ~100")
    return tuple(out)


def _mix_schedule(mix, total_requests: int, seed: int = 0):
    """The request-size schedule: counts rounded from the percents (each
    named class at least once), shuffled with a fixed seed, so every
    batching mode replays the same work."""
    sizes = []
    for size, pct in mix:
        count = max(1, round(total_requests * pct / 100.0)) if pct else 0
        sizes += [size] * count
    np.random.default_rng(seed).shuffle(sizes)
    return sizes


def _mixed_latency_row(wall: float, n_scheduled: int, lat: Dict[int, list]) -> Dict[str, Any]:
    """One mixed-size row: ``req_per_s`` counts the COMPLETED requests,
    with p50 and p99 by size class."""
    completed = sum(len(v) for v in lat.values())
    row: Dict[str, Any] = {
        "wall_s": round(wall, 3),
        "requests_scheduled": n_scheduled,
        "req_per_s": round(completed / wall, 2) if wall else 0.0,
        "size_classes": {},
    }
    for size, samples in sorted(lat.items()):
        if samples:
            row["size_classes"][str(size)] = {
                "requests": len(samples),
                "p50_s": round(float(np.percentile(samples, 50)), 4),
                "p99_s": round(float(np.percentile(samples, 99)), 4),
            }
    return row


def run_serve_suite(
    mix_spec: str,
    iterations: int = SERVE_SUITE_REQUESTS,
    clients: int = SERVE_SUITE_CLIENTS,
    device="cuda",
    model_overrides: Optional[Dict] = None,
) -> Dict[str, Any]:
    """The serve suite (``roko_tpu/benchmark.py:2402-2806``): the same
    seeded mixed-size schedule driven closed loop by ``clients`` threads
    against one warm :class:`PolishSession` under the deadline, continuous
    and ragged batchers, each row with req/s, p50 and p99 by size class,
    ``padding_efficiency`` (real windows over the rows or slots
    dispatched), ``byte_identical`` (every reply equal to a solo
    ``session.predict``) and ``client_errors``; then
    ``small_p99_improvement`` (deadline p99 over continuous p99 of the
    smallest class), the ``ragged`` headline, the ``precision`` A/B
    (int8 weights in the continuous mode, each variant against its own
    solo predicts) and ``tenant_mix`` (a weighted interactive tenant
    beside a bulk flood, fair share on and off), and ``autoscale`` (the
    fleet's :class:`~roko_tpu_torch.serve.supervisor.Autoscaler` on the
    continuous batcher's real backlog through idle, flood and drain)."""
    import dataclasses
    import threading

    import torch

    from roko_tpu_torch import constants as C
    from roko_tpu_torch.config import ModelConfig, RokoConfig, ServeConfig, TenantConfig
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.serve.batcher import MicroBatcher
    from roko_tpu_torch.serve.metrics import ServeMetrics
    from roko_tpu_torch.serve.scheduler import ContinuousBatcher, RaggedBatcher
    from roko_tpu_torch.serve.session import PolishSession

    dev = resolve_device(device)
    mix = _parse_mix(mix_spec)
    large = max(size for size, _ in mix)
    # the flagship ladder's shape at suite scale: a bottom rung, a middle
    # one and a top rung sized to the large class, the same for every mode
    ladder = tuple(sorted({min(8, large), min(32, large), large}))
    cfg = RokoConfig(model=ModelConfig(**(model_overrides or {})),
                     serve=ServeConfig(ladder=ladder))
    model = RokoModel(cfg.model, generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    session = PolishSession(model, cfg, device=dev)
    session.warmup()

    rng = np.random.default_rng(0)
    rows, cols = cfg.model.window_rows, cfg.model.window_cols
    payloads = {size: rng.integers(0, C.FEATURE_VOCAB, (size, rows, cols)).astype(np.uint8)
                for size, _ in mix}
    expected = {size: session.predict(x) for size, x in payloads.items()}
    schedule = _mix_schedule(mix, iterations)

    def drive(mode: str, session=session, expected=expected) -> Dict[str, Any]:
        metrics = ServeMetrics()
        metrics.size_classes = ladder
        if mode in ("continuous", "ragged"):
            cls = RaggedBatcher if mode == "ragged" else ContinuousBatcher
            batcher = cls(session, metrics=metrics, max_queue=clients * 2)
        else:
            batcher = MicroBatcher(session, metrics=metrics, max_queue=clients * 2)
        lat: Dict[int, list] = {size: [] for size, _ in mix}
        mismatches: list = []
        errors: list = []
        lock = threading.Lock()
        work = list(schedule)

        def one_client():
            while True:
                with lock:
                    if not work:
                        return
                    size = work.pop()
                t0 = time.perf_counter()
                try:
                    preds = batcher.predict(payloads[size], timeout=600.0)
                except Exception as e:
                    # counted, so byte_identical cannot pass vacuously
                    with lock:
                        errors.append(_error(e)[:200])
                    continue
                dt = time.perf_counter() - t0
                ok = np.array_equal(preds, expected[size])
                with lock:
                    lat[size].append(dt)
                    if not ok:
                        mismatches.append(size)

        try:
            # untimed calibration: one request a class warms the
            # throughput EMA; its heavily padded steps are left out of
            # padding_efficiency
            for size in payloads:
                batcher.predict(payloads[size], timeout=600.0)
            cal_windows, cal_padded = metrics.fill_totals()
            threads = [threading.Thread(target=one_client, daemon=True)
                       for _ in range(clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
        finally:
            batcher.stop()
        fill_windows, fill_padded = metrics.fill_totals()
        padded = fill_padded - cal_padded
        row = _mixed_latency_row(wall, len(schedule), lat)
        row["padding_efficiency"] = (
            round((fill_windows - cal_windows) / padded, 4) if padded else 0.0)
        row["byte_identical"] = not mismatches and not errors
        row["client_errors"] = len(errors)
        if errors:
            row["errors"] = errors[:5]
        return row

    results: Dict[str, Any] = {
        "mix": mix_spec, "iterations": len(schedule), "clients": clients,
        "ladder": list(ladder), "modes": {},
    }
    for mode in ("deadline", "continuous", "ragged"):
        results["modes"][mode] = drive(mode)
    small = str(min(size for size, _ in mix))
    try:
        d = results["modes"]["deadline"]["size_classes"][small]["p99_s"]
        c = results["modes"]["continuous"]["size_classes"][small]["p99_s"]
        if c > 0:
            results["small_p99_improvement"] = round(d / c, 3)
    except KeyError:
        pass
    rg = results["modes"].get("ragged") or {}
    co = results["modes"].get("continuous") or {}
    ragged_row: Dict[str, Any] = {
        "padding_efficiency": rg.get("padding_efficiency"),
        "continuous_padding_efficiency": co.get("padding_efficiency"),
        "req_per_s": rg.get("req_per_s"),
        "continuous_req_per_s": co.get("req_per_s"),
        "byte_identical": rg.get("byte_identical"),
    }
    if rg.get("req_per_s") and co.get("req_per_s"):
        ragged_row["req_per_s_vs_continuous"] = round(rg["req_per_s"] / co["req_per_s"], 3)
    results["ragged"] = ragged_row

    # the precision A/B: the same schedule, continuous mode, sessions that
    # differ only in precision, each reply against its own solo predicts
    resolved = session.model.cfg
    base_tag = resolved.compute_dtype + (f"+{resolved.quantize}" if resolved.quantize else "")
    variants: Dict[str, Tuple[str, Optional[str]]] = {}
    if resolved.quantize != "int8" and resolved.kind != "transformer":
        variants["float32+int8"] = ("float32", "int8")
    if resolved.compute_dtype != "float32" or resolved.quantize:
        variants["float32"] = ("float32", None)
    prec: Dict[str, Any] = {"baseline": base_tag,
                            "modes": {base_tag: results["modes"]["continuous"]}}
    results["precision"] = prec
    for tag, (vdtype, vquant) in variants.items():
        try:
            vcfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, compute_dtype=vdtype, quantize=vquant))
            vmodel = RokoModel(vcfg.model)
            vmodel.load_state_dict(state, strict=True)
            vsession = PolishSession(vmodel, vcfg, device=dev)
            vsession.warmup()
            vexpected = {size: vsession.predict(x) for size, x in payloads.items()}
            prec["modes"][tag] = drive("continuous", session=vsession, expected=vexpected)
        except Exception as e:  # report, never swallow
            prec["modes"][tag] = {"error": _error(e)}
    base_rps = prec["modes"][base_tag].get("req_per_s")
    int8_tag = base_tag if resolved.quantize == "int8" else "float32+int8"
    int8_rps = (prec["modes"].get(int8_tag) or {}).get("req_per_s")
    f32_rps = ((prec["modes"].get("float32") or {}).get("req_per_s")
               or (base_rps if base_tag == "float32" else None))
    if int8_rps and f32_rps:
        prec["int8_req_per_s_vs_f32"] = round(int8_rps / f32_rps, 3)

    # the tenant mix: an interactive tenant (small requests, weight 4)
    # beside a bulk flood (large requests), fair share on against every
    # request in the default tenant, on the same fixed work
    small_sz = min(size for size, _ in mix)
    n_inter = max(6, len(schedule) // 2)
    n_bulk = max(3, len(schedule) // 3)

    def drive_tenants(fair: bool) -> Dict[str, Any]:
        metrics = ServeMetrics()
        metrics.size_classes = ladder
        tenants = ((TenantConfig("interactive", weight=4.0), TenantConfig("bulk", weight=1.0))
                   if fair else ())
        batcher = ContinuousBatcher(session, metrics=metrics, max_queue=clients * 4,
                                    tenants=tenants)
        work = {"interactive": [small_sz] * n_inter, "bulk": [large] * n_bulk}
        lat: Dict[str, list] = {"interactive": [], "bulk": []}
        errors: list = []
        lock = threading.Lock()

        def one_client(tname: str):
            while True:
                with lock:
                    if not work[tname]:
                        return
                    size = work[tname].pop()
                t0 = time.perf_counter()
                try:
                    preds = batcher.submit(payloads[size],
                                           tenant=tname if fair else None).result(600.0)
                except Exception as e:
                    with lock:
                        errors.append(_error(e)[:200])
                    continue
                dt = time.perf_counter() - t0
                ok = np.array_equal(preds, expected[size])
                with lock:
                    lat[tname].append(dt)
                    if not ok:
                        errors.append(f"mismatch:{tname}")

        try:
            for size in payloads:  # untimed EMA calibration
                batcher.submit(payloads[size]).result(600.0)
            threads = [threading.Thread(target=one_client, args=(t,), daemon=True)
                       for t in ("interactive", "interactive", "bulk", "bulk", "bulk")]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
        finally:
            batcher.stop()
        row: Dict[str, Any] = {"fair_share": fair, "wall_s": round(wall, 3),
                               "client_errors": len(errors), "tenants": {}}
        for tname, samples in sorted(lat.items()):
            if samples:
                row["tenants"][tname] = {
                    "requests": len(samples),
                    "req_per_s": round(len(samples) / wall, 2),
                    "p50_s": round(float(np.percentile(samples, 50)), 4),
                    "p99_s": round(float(np.percentile(samples, 99)), 4),
                }
        return row

    tmix: Dict[str, Any] = {"fair": drive_tenants(True), "unfair": drive_tenants(False)}
    try:
        off = tmix["unfair"]["tenants"]["interactive"]["p99_s"]
        on = tmix["fair"]["tenants"]["interactive"]["p99_s"]
        if on > 0:
            tmix["interactive_p99_improvement"] = round(off / on, 3)
        off_b = tmix["unfair"]["tenants"]["bulk"]["req_per_s"]
        on_b = tmix["fair"]["tenants"]["bulk"]["req_per_s"]
        if off_b > 0:
            tmix["bulk_req_per_s_retained"] = round(on_b / off_b, 3)
    except KeyError:
        pass
    results["tenant_mix"] = tmix

    # the autoscale row (:2734): the supervisor's Autoscaler driven by the
    # continuous batcher's real backlog through a load step (idle, flood,
    # drain), with a stand-in actuator for the worker processes: the
    # decision loop's worker-count trajectory beside the measured req/s
    from roko_tpu_torch.config import FleetConfig
    from roko_tpu_torch.serve.supervisor import Autoscaler

    fc = FleetConfig(workers=2, min_workers=1, max_workers=3,
                     autoscale_up_backlog=float(large), autoscale_down_backlog=1.0,
                     autoscale_idle_s=3.0, autoscale_cooldown_s=1.0, autoscale_ema_beta=0.3)
    metrics = ServeMetrics()
    metrics.size_classes = ladder
    batcher = ContinuousBatcher(session, metrics=metrics, max_queue=max(64, clients * 8))

    class _ScaleProbe:
        """Autoscaler actuator stand-in: real backlog, counted workers."""
        fleet_cfg = fc
        jobs_parked = False
        workers = [0] * fc.workers

        def backlog_windows(self):
            return batcher.backlog_windows()

        def scale_to(self, n, reason=""):
            self.workers = [0] * n
            return n

    probe = _ScaleProbe()
    fake_now = [0.0]
    scaler = Autoscaler(probe, log=lambda m: None, clock=lambda: fake_now[0])
    trajectory = []

    def run_phase(name: str, futures, ticks: int) -> Dict[str, Any]:
        t0 = time.perf_counter()
        for _ in range(ticks):
            fake_now[0] += 1.0
            scaler.tick()
            trajectory.append(len(probe.workers))
            time.sleep(0.01)
        done = [f.result(600.0) for f in futures]
        wall = time.perf_counter() - t0
        return {"phase": name, "requests": len(done),
                "req_per_s": round(len(done) / wall, 2) if wall else 0.0,
                "workers_after": len(probe.workers)}

    auto: Dict[str, Any] = {"min_workers": 1, "max_workers": 3, "phases": []}
    try:
        auto["phases"].append(run_phase("idle", [], ticks=2))
        flood = [batcher.submit(payloads[large]) for _ in range(max(8, len(schedule) // 4))]
        auto["phases"].append(run_phase("flood", flood, ticks=6))
        fake_now[0] += fc.autoscale_idle_s
        auto["phases"].append(run_phase("drain", [], ticks=8))
    finally:
        batcher.stop()
    auto["worker_trajectory"] = trajectory
    auto["scaled_up"] = max(trajectory) > fc.workers
    auto["scaled_down"] = trajectory[-1] < max(trajectory)
    results["autoscale"] = auto
    return results


def ported_errors(result: Dict[str, Any]) -> List[str]:
    """The errors in rows of the ported suites of a bench result, as
    ``"path.to.row: error"``: every ``error`` or ``*_error`` entry of
    ``detail`` outside :data:`UNPORTED_SUITES`, the train suite's
    :data:`UNPORTED_TRAIN_ROWS`, the serve suite's
    :data:`UNPORTED_SERVE_ROWS` and the ``--compare`` block."""
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
        if key in ("train", "serve") and isinstance(value, dict):
            skip = UNPORTED_TRAIN_ROWS if key == "train" else UNPORTED_SERVE_ROWS
            walk({k: v for k, v in value.items() if k not in skip}, key)
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


def cascade_corpus(draft_len: int, coverage: int = 20, workers: Optional[int] = None):
    """The cascade suite's sim corpus, extracted in memory through the
    region stream (the reference writes it to HDF5; the windows are the
    same): ``(contigs, batches of 512)`` for ``run_inference``."""
    import os
    import random
    import tempfile

    from roko_tpu_torch.features.pipeline import open_region_stream
    from roko_tpu_torch.io.bam import write_sorted_bam
    from roko_tpu_torch.io.fasta import write_fasta
    from roko_tpu_torch.sim import random_seq, simulate_reads

    rng = random.Random(0)
    draft = random_seq(rng, draft_len)
    records = simulate_reads(rng, draft, 0, coverage=coverage,
                             read_len=min(3000, max(100, draft_len // 4)))
    with tempfile.TemporaryDirectory() as td:
        fasta, bam = os.path.join(td, "draft.fasta"), os.path.join(td, "reads.bam")
        write_fasta(fasta, [("ctg", draft)])
        write_sorted_bam(bam, [("ctg", draft_len)], records)
        with open_region_stream(fasta, bam, workers=workers or max(1, os.cpu_count() or 1),
                                seed=0, log=lambda *a, **k: None) as stream:
            blocks = [r for r in stream.results if r is not None and len(r[1])]
    positions = np.concatenate([b[1] for b in blocks])
    examples = np.concatenate([b[2] for b in blocks])
    batches = [(["ctg"] * len(positions[i:i + BATCH]), positions[i:i + BATCH],
                examples[i:i + BATCH]) for i in range(0, len(positions), BATCH)]
    return {"ctg": draft}, batches


def run_cascade_suite(
    draft_len: int = 40_000, coverage: int = 20, threshold: float = 0.05,
    device="cuda", model_overrides: Optional[Dict] = None,
) -> Dict[str, Any]:
    """The cascade suite (``roko_tpu/benchmark.py:1740-1860``): one sim
    corpus through the plain ``run_inference`` (the reference row), the
    cascade at threshold 0 (every window escalates: its FASTA must be the
    plain one's, sha256 for sha256), and the cascade at ``threshold``
    twice over one on-disk window cache (cold, then warm: the warm hit
    rate is what a distributed polish's second worker sees). Rows:
    windows/s of both paths, the speedup, ``escalation_pct``, the cold
    and warm cache hit rates."""
    import dataclasses
    import hashlib
    import os
    import tempfile

    import torch

    from roko_tpu_torch.config import CascadeConfig, ModelConfig, RokoConfig
    from roko_tpu_torch.infer import run_inference
    from roko_tpu_torch.models.model import RokoModel

    def _sha(polished: Dict[str, str]) -> str:
        h = hashlib.sha256()
        for name in sorted(polished):
            h.update(name.encode() + b"\x00" + polished[name].encode() + b"\x00")
        return h.hexdigest()

    quiet = lambda *a, **k: None  # noqa: E731
    contigs, batches = cascade_corpus(draft_len, coverage)
    n = sum(len(b[0]) for b in batches)
    out: Dict[str, Any] = {"draft_len": draft_len, "coverage": coverage,
                           "threshold": threshold, "windows": n}
    cfg = RokoConfig(model=ModelConfig(**(model_overrides or {})))
    model = RokoModel(cfg.model, generator=torch.Generator().manual_seed(0))

    def run(c: RokoConfig, stats=None):
        t0 = time.perf_counter()
        got = run_inference(iter(batches), contigs, model, device=device, log=quiet, cfg=c,
                            cascade_stats=stats)
        return got, time.perf_counter() - t0

    run(cfg)  # the kernels' build and first launch stay out of the rows
    ref, ref_s = run(cfg)
    out["reference_windows_per_sec"] = round(n / ref_s, 1)
    zero, _ = run(dataclasses.replace(cfg, cascade=CascadeConfig(enabled=True, threshold=0.0)))
    out["threshold0_identical"] = _sha(zero) == _sha(ref)
    with tempfile.TemporaryDirectory() as td:
        casc = dataclasses.replace(cfg, cascade=CascadeConfig(
            enabled=True, threshold=threshold, cache_dir=os.path.join(td, "wcache")))
        cold: Dict[str, Any] = {}
        _, casc_s = run(casc, cold)
        out["cascade_windows_per_sec"] = round(n / casc_s, 1)
        out["speedup_vs_reference"] = round(ref_s / casc_s, 2)
        out["escalation_pct"] = round(100.0 * cold.get("escalation_fraction", 0.0), 1)
        out["cold_cache_hit_rate"] = round(cold.get("cache_hit_rate", 0.0), 3)
        warm: Dict[str, Any] = {}
        run(casc, warm)  # a fresh router over the SAME on-disk cache
        out["cache_hit_rate"] = round(warm.get("cache_hit_rate", 0.0), 3)
    return out


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
    serve_mix = getattr(args, "serve_mix", None)
    if serve_mix == "default":
        serve_mix = SERVE_MIX_DEFAULT_TPU if dev.type == "cuda" else SERVE_MIX_DEFAULT_CPU
    if serve_mix in ("0", "off", ""):
        serve_mix = None
    if serve_mix:
        _stamp(f"serve suite (mixed sizes {serve_mix}, three batching modes)")
        try:
            detail["serve"] = run_serve_suite(
                serve_mix, iterations=bench_iters or SERVE_SUITE_REQUESTS, device=dev,
                model_overrides=model_overrides)
        except Exception as e:  # report, never swallow
            detail["serve"] = {"error": _error(e)}
    coldstart = parse_counts(getattr(args, "coldstart_ladder", None))
    if coldstart:
        _stamp(f"coldstart suite (ladder {coldstart})")
        try:
            detail["coldstart"] = run_coldstart_suite(coldstart, device=dev.type,
                                                      model_overrides=model_overrides)
        except Exception as e:  # report, never swallow
            detail["coldstart"] = {"error": _error(e)}
    fleet_workers = parse_counts(getattr(args, "fleet_workers", None))
    if fleet_workers:
        # an explicit --serve-mix also runs the fleet suite's mixed-size
        # phase (roko_tpu/benchmark.py:1183-1200); without one the suite
        # keeps its flat single-size cost
        _stamp(f"fleet suite (workers {fleet_workers}"
               + (f", mixed sizes {serve_mix})" if serve_mix else ")"))
        try:
            detail["fleet"] = run_fleet_suite(fleet_workers,
                                              iterations=bench_iters or FLEET_ITERS,
                                              device=dev.type, model_overrides=model_overrides,
                                              mix=serve_mix)
        except Exception as e:  # report, never swallow
            detail["fleet"] = {"error": _error(e)}
    cascade_draft = getattr(args, "cascade_draft", None)
    if cascade_draft:
        _stamp(f"cascade suite (tier router + window cache, draft {cascade_draft})")
        try:
            detail["cascade"] = run_cascade_suite(cascade_draft, device=dev,
                                                  model_overrides=model_overrides)
        except Exception as e:  # report, never swallow
            detail["cascade"] = {"error": _error(e)}
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
    # the cascade rows: the plain and the cascaded throughput, and routing
    for col in ("reference_windows_per_sec", "cascade_windows_per_sec", "escalation_pct",
                "cache_hit_rate"):
        pairs[f"cascade.{col}"] = ((cur_d.get("cascade") or {}).get(col),
                                   (prev_d.get("cascade") or {}).get(col))
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


def add_fleet_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--coldstart-ladder", default=None, metavar="RUNGS",
                   help="coldstart suite: the serve ladder whose time to first prediction "
                   "is measured in four start modes, each in a child process (cold, "
                   "cold_parallel, warm_cache, aot), e.g. 32,128,512; 0 or absent: off")
    p.add_argument("--fleet-workers", default=None, metavar="COUNTS",
                   help="fleet suite: worker counts of a supervised fleet of serve "
                   "processes under closed-loop load, with a SIGKILL phase at the largest, "
                   "e.g. 1,2; 0 or absent: off")


def add_serve_mix_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--serve-mix", nargs="?", const="default", default=None,
                   metavar="SIZE:PCT,...",
                   help="serve suite: windows a request and its percent of the requests, e.g. "
                   f"2:50,8:50; bare: {SERVE_MIX_DEFAULT_TPU} on a card, "
                   f"{SERVE_MIX_DEFAULT_CPU} on the CPU; 0, off or absent: off. With "
                   "--fleet-workers the fleet suite runs the same mix through its workers "
                   "under both the deadline and continuous batchers")


def add_cascade_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cascade-draft", type=int, default=None, metavar="BASES",
                   help="cascade suite: draft length of its sim corpus (the plain path's and "
                   "the cascade's windows/s, escalation %%, cold and warm cache hit rates, "
                   "threshold-0 byte identity); 0 or absent: off")


def add_unported_flags(p: argparse.ArgumentParser) -> None:
    """The reference's flags of unported suites, so that they parse and
    :func:`unported_flag` can name their queue item."""
    p.add_argument("--features", action="store_true", help="not ported yet (queue item A11b)")
    for flag, kind, item in (("--e2e-draft", int, "A11b"), ("--pipeline-draft", int, "A11b"),
                             ("--input-rows", int, "A11b")):
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
    add_fleet_flags(ap)
    add_cascade_flag(ap)
    add_unported_flags(ap)
    add_serve_mix_flag(ap)
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
