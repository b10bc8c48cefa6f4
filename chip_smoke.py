#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``roko_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``roko_tpu_torch/csrc`` (one
nvcc per source, started together), holds each kernel against its plain
PyTorch version at the shapes its path gives it and times both, then
drives the port's two main paths with the default model at full width:

- inference: polishes a synthetic contig through
  ``roko_tpu_torch.infer.run_inference`` (random weights from a numpy
  seed, carried in through the JAX weights bridge);
- training: one train step through the kernels against the plain
  recurrence, then ``roko_tpu_torch.training.loop.train`` for two epochs
  over an in-memory labelled corpus with a held-out val set and the guard
  on, its checkpoints verified, and the best one polishing the contig.

Each path runs with the launch counts set to 0 just before it and read
just after, and fails unless every kernel of the path launched. Prints
JSON lines; the last line is ``{"ok": true, "device": {...}}``. Any failed
phase exits non-zero without that line. Needs one CUDA card, nvcc and
nvidia-smi; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel check shapes: the main path's (T=90 columns, H=128, both
# directions, batch 512) first, then ragged ones that exercise masking
MAIN_SHAPE = dict(B=512, T=90, IN=500, H=128, S=2)
EXTRA_SHAPES = (
    dict(B=5, T=90, IN=24, H=16, S=2),
    dict(B=13, T=7, IN=256, H=128, S=1),
)
ATOL = RTOL = 1e-4  # f32 kernel vs f32 loop: summation order only
PATH_BATCHES = 8
PATH_BATCH_SIZE = 512
SEED = 0
# gru_bwd check shapes: the train path's (batch 128, first layer) first
TRAIN_SHAPE = dict(B=128, T=90, IN=500, H=128, S=2)
BWD_EXTRA_SHAPES = (
    dict(B=5, T=90, IN=24, H=16, S=2),
    dict(B=13, T=7, IN=256, H=128, S=1),
    dict(B=9, T=33, IN=64, H=512, S=2),
)
# the train path: windows of the in-memory corpus, held-out share, epochs
TRAIN_WINDOWS = 4096
TRAIN_VAL_FRACTION = 0.1
TRAIN_EPOCHS = 2
TRAIN_BATCH = 128
# batches of 512 windows the trained checkpoint polishes
TRAINED_POLISH_BATCHES = 4
# one full-width train step through the kernels vs the plain recurrence:
# each gradient is a sum over 128 x 90 columns through 3 layers of 90
# steps, so f32 rounding of the two summation orders grows with the
# gradient's own size; the gate is relative to its largest entry
STEP_RTOL = 1e-4
STEP_ATOL_OF_MAX = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str):
    """(f32 FLOP/s without tensor cores, memory bytes/s) from NVIDIA's
    H100 data sheet: the SXM part unless the name says PCIe."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12
    return 67e12, 3.35e12


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def uniform(rng, bound, shape):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def jax_layout_gru_layer(rng, in_size: int, hidden: int):
    b = 1.0 / math.sqrt(hidden)
    return {
        d: {
            "w_ih": uniform(rng, b, (in_size, 3 * hidden)),
            "w_hh": uniform(rng, b, (hidden, 3 * hidden)),
            "b_ih": uniform(rng, b, (3 * hidden,)),
            "b_hh": uniform(rng, b, (3 * hidden,)),
        }
        for d in ("fwd", "bwd")
    }


def jax_layout_params(rng, cfg):
    """Random params in the JAX package's tree layout."""

    def dense(i, o):
        b = 1.0 / math.sqrt(i)
        return {"kernel": uniform(rng, b, (i, o)), "bias": uniform(rng, b, (o,))}

    return {
        "embedding": rng.standard_normal((cfg.embed_vocab, cfg.embed_dim)).astype(np.float32),
        "fc1": dense(cfg.window_rows, cfg.read_mlp[0]),
        "fc2": dense(cfg.read_mlp[0], cfg.read_mlp[1]),
        "head": dense(2 * cfg.hidden_size, cfg.num_classes),
        "gru": tuple(
            jax_layout_gru_layer(
                rng, cfg.gru_in_size if k == 0 else 2 * cfg.hidden_size, cfg.hidden_size
            )
            for k in range(cfg.num_layers)
        ),
    }


def synthetic_contig(rng, n_windows: int, C):
    """A random ACGT draft and its windows: consecutive (pos, ins) columns
    with some insertion slots, 90 columns a window at stride 30, and random
    feature codes."""
    n_cols = (n_windows - 1) * C.WINDOW_STRIDE + C.WINDOW_COLS
    cols = []
    pos = 0
    while len(cols) < n_cols:
        cols.append((pos, 0))
        ins = 0
        while ins < C.MAX_INS and rng.random() < 0.1:
            ins += 1
            cols.append((pos, ins))
        pos += 1
    cols = np.asarray(cols[:n_cols], np.int64)
    draft = "".join(rng.choice(list("ACGT"), size=pos))
    starts = np.arange(n_windows) * C.WINDOW_STRIDE
    positions = cols[starts[:, None] + np.arange(C.WINDOW_COLS)]  # [N, 90, 2]
    examples = rng.integers(
        0, C.FEATURE_VOCAB, (n_windows, C.WINDOW_ROWS, C.WINDOW_COLS), dtype=np.uint8
    )
    return draft, positions, examples


def layer_inputs(torch, shape, dev, rng):
    """x, per-direction weights, and the recurrence's xp, w_hh, b_hh."""
    B, T, IN, H, S = (shape[k] for k in ("B", "T", "IN", "H", "S"))
    layer = jax_layout_gru_layer(rng, IN, H)
    dirs = [layer["fwd"], layer["bwd"]][:S]
    x = torch.from_numpy(rng.standard_normal((B, T, IN), dtype=np.float32)).to(dev)
    t = {k: [torch.from_numpy(d[k]).to(dev) for d in dirs] for k in dirs[0]}
    xp = (x @ torch.cat(t["w_ih"], 1) + torch.cat(t["b_ih"])).contiguous()
    w_hh = torch.stack(t["w_hh"]).contiguous()
    b_hh = torch.stack(t["b_hh"]).contiguous()
    return x, t, xp, w_hh, b_hh


def cudnn_gru(torch, t, IN, H, S, dev):
    """One cuDNN GRU layer holding the same weights (a yardstick only)."""
    ref = torch.nn.GRU(IN, H, batch_first=True, bidirectional=S == 2).to(dev)
    with torch.no_grad():
        for s, suffix in enumerate(["", "_reverse"][:S]):
            getattr(ref, f"weight_ih_l0{suffix}").copy_(t["w_ih"][s].t())
            getattr(ref, f"weight_hh_l0{suffix}").copy_(t["w_hh"][s].t())
            getattr(ref, f"bias_ih_l0{suffix}").copy_(t["b_ih"][s])
            getattr(ref, f"bias_hh_l0{suffix}").copy_(t["b_hh"][s])
    return ref


def bound(torch, flops: float, nbytes: float) -> dict:
    peak_flops, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return dict(flop=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def check_kernel(torch, fg, shape, dev, rng, *, timed: bool):
    """gru_fwd vs gru_recurrence_plain at ``shape`` on the card; with
    ``timed``, also the kernel's, the plain loop's and cuDNN's times."""
    B, T, IN, H, S = (shape[k] for k in ("B", "T", "IN", "H", "S"))
    x, t, xp, w_hh, b_hh = layer_inputs(torch, shape, dev, rng)

    got = fg.gru_recurrence(xp, w_hh, b_hh)
    want = fg.gru_recurrence_plain(xp, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
        fail(f"gru_fwd disagrees with the plain loop at {shape}: max |d| {err}")
    row = {"shape": shape, "max_abs_err": err}
    if not timed:
        return row

    # cuDNN's GRU with the same weights: a yardstick only, and it also
    # runs the input product that gru_fwd leaves outside
    ref = cudnn_gru(torch, t, IN, H, S, dev)
    with torch.no_grad():
        lib_out, _ = ref(x)
        row["library_max_abs_err"] = (lib_out - got).abs().max().item()
        row["library_ms"] = cuda_ms(torch, lambda: ref(x), iters=20)
    row["ms"] = cuda_ms(torch, lambda: fg.gru_recurrence(xp, w_hh, b_hh), iters=20)
    row["plain_ms"] = cuda_ms(
        torch, lambda: fg.gru_recurrence_plain(xp, w_hh, b_hh), iters=3, warmup=1
    )
    flops = 2.0 * T * S * B * H * 3 * H  # step matmuls, one FMA = 2 operations
    nbytes = 4.0 * (xp.numel() + w_hh.numel() + b_hh.numel() + got.numel())
    row.update(bound(torch, flops, nbytes))
    return row


def check_bwd_kernel(torch, fg, shape, dev, rng, *, timed: bool):
    """gru_bwd vs gru_recurrence_backward_plain at ``shape`` on the card,
    and two launches bitwise equal; with ``timed``, also the kernel's, the
    plain loop's and cuDNN's backward times."""
    B, T, IN, H, S = (shape[k] for k in ("B", "T", "IN", "H", "S"))
    x, t, xp, w_hh, b_hh = layer_inputs(torch, shape, dev, rng)
    with torch.no_grad():
        out = fg.gru_recurrence_plain(xp, w_hh, b_hh)
    dy = torch.from_numpy(rng.standard_normal((B, T, S * H), dtype=np.float32)).to(dev)
    args = (xp, w_hh, b_hh, out, dy)
    got = fg.gru_recurrence_backward(*args)
    want = fg.gru_recurrence_backward_plain(*args)
    again = fg.gru_recurrence_backward(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w, a in zip(("dxp", "dw_hh", "db_hh"), got, want, again):
        errs[name] = (g - w).abs().max().item()
        if not torch.allclose(g, w, atol=ATOL, rtol=RTOL):
            fail(f"gru_bwd {name} disagrees with the plain loop at {shape}: max |d| {errs[name]}")
        if not torch.equal(g, a):
            fail(f"gru_bwd {name} differs between two launches at {shape}")
    row = {"shape": shape, "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
           "bitwise_repeatable": True, "splits": fg.bwd_splits(B, T, H, S)}
    if not timed:
        return row

    # cuDNN's GRU backward with the same weights: a yardstick only; it
    # also runs the dx and dW_ih products that stay outside gru_bwd
    ref = cudnn_gru(torch, t, IN, H, S, dev)
    xr = x.clone().requires_grad_(True)
    lib_out, _ = ref(xr)
    lib_inputs = [xr, *ref.parameters()]
    row["library_ms"] = cuda_ms(
        torch, lambda: torch.autograd.grad(lib_out, lib_inputs, dy, retain_graph=True), iters=20)
    row["ms"] = cuda_ms(torch, lambda: fg.gru_recurrence_backward(*args), iters=20)
    row["plain_ms"] = cuda_ms(
        torch, lambda: fg.gru_recurrence_backward_plain(*args), iters=3, warmup=1)
    # hp, dhp W_hh^T and h_prev^T dhp: three step products
    flops = 3 * 2.0 * T * S * B * H * 3 * H
    nbytes = 4.0 * (xp.numel() + out.numel() + dy.numel() + w_hh.numel() + b_hh.numel()
                    + got[0].numel() + got[1].numel() + got[2].numel())
    row.update(bound(torch, flops, nbytes))
    return row


def device_breakdown(torch, run):
    """Run ``run()`` under torch.profiler and sum the card's kernel time by
    kernel name and by kind; the busy share is the union of kernel
    intervals over the span from the first kernel's start to the last
    one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, by_kind = [], {}, {}
    for e in prof.events():
        # user annotations (the optimizer's step range) span kernels
        # already counted: kernels and copies only
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            ms = e.time_range.elapsed_us() / 1e3
            key = e.name[:80]
            total, n = by_name.get(key, (0.0, 0))
            by_name[key] = (total + ms, n + 1)
            low = e.name.lower()
            kind = ("gru_fwd" if "gru_fwd" in low else "gru_bwd" if "gru_bwd" in low
                    else "gemm" if "gemm" in low
                    else "memcpy" if low.startswith("memcpy") else "other")
            total, n = by_kind.get(kind, (0.0, 0))
            by_kind[kind] = (total + ms, n + 1)
    if not spans:
        return {"wall_ms": wall_ms, "device": "not measured (no device events traced)"}
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s = busy + (cur_e - cur_s), s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span_us = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "wall_ms": wall_ms,
        "device_span_ms": span_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "busy_share_of_span": busy / span_us,
        "kinds_ms_calls": {k: [ms, n] for k, (ms, n) in by_kind.items()},
        "kernels_ms_calls": {name: [ms, n] for name, (ms, n) in top},
    }


def step_parity(torch, dev, ds, fg, RokoModel, ModelConfig, loop):
    """One full-width train step (dropout off) through the kernels and
    through the plain recurrence: loss and every gradient."""
    model = RokoModel(ModelConfig(dropout=0.0), torch.Generator().manual_seed(SEED))
    model.to(dev).train()
    batch = next(ds.batches(TRAIN_BATCH, rng=np.random.default_rng(SEED)))
    x, y, w = loop.to_device(batch, dev)

    def grads(recurrence):
        model.zero_grad(set_to_none=True)
        loss, _, _ = loop.loss_and_stats(model(x, recurrence), y, w)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    loss_k, got = grads(fg.gru_recurrence)
    loss_p, want = grads(fg.gru_recurrence_plain)
    if not math.isfinite(loss_k) or abs(loss_k - loss_p) > STEP_RTOL * abs(loss_p) + 1e-6:
        fail(f"train step loss: kernels {loss_k}, plain recurrence {loss_p}")
    worst = {}
    for name, g in got.items():
        ref = want[name]
        scale = ref.abs().max().item()
        d = (g - ref).abs().max().item()
        worst[name] = [d, scale]
        if not torch.allclose(g, ref, rtol=STEP_RTOL, atol=STEP_ATOL_OF_MAX * scale):
            fail(f"train step gradient {name}: max |d| {d} against max |g| {scale}")
    top = max(worst, key=lambda n: worst[n][0] / max(worst[n][1], 1e-30))
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "params": len(got),
            "worst_relative": {"param": top, "max_abs_err": worst[top][0],
                               "max_abs_grad": worst[top][1]},
            "max_abs_err": max(v[0] for v in worst.values())}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from roko_tpu_torch import constants as C
        from roko_tpu_torch import kernels
        from roko_tpu_torch.config import ModelConfig
        from roko_tpu_torch.infer import VoteBoard, predict, run_inference
        from roko_tpu_torch.models import fused_gru as fg
        from roko_tpu_torch.models.convert import state_dict_from_jax
        from roko_tpu_torch.models.model import RokoModel
        from roko_tpu_torch.config import TrainConfig
        from roko_tpu_torch.training import loop
        from roko_tpu_torch.training.checkpoint import load_params, verify_manifest
        from roko_tpu_torch.training.data import InMemoryDataset
    except ImportError as e:
        fail(f"the port package roko_tpu_torch is not importable beside this script: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"device": {"name": name, "count": torch.cuda.device_count(), "nvidia_smi": card,
                     "torch": torch.__version__, "cuda": torch.version.cuda}})

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build()
    emit({"build": {"seconds": time.perf_counter() - t0, "kernels": built}})

    # -- kernels against their plain versions -------------------------------
    rng = np.random.default_rng(SEED)
    main_row = check_kernel(torch, fg, MAIN_SHAPE, dev, rng, timed=True)
    extra = [check_kernel(torch, fg, s, dev, rng, timed=False) for s in EXTRA_SHAPES]
    bwd_row = check_bwd_kernel(torch, fg, TRAIN_SHAPE, dev, rng, timed=True)
    bwd_extra = [check_bwd_kernel(torch, fg, s, dev, rng, timed=False) for s in BWD_EXTRA_SHAPES]
    emit({"kernel_check": {"gru_fwd": [main_row, *extra], "gru_bwd": [bwd_row, *bwd_extra],
                           "atol": ATOL, "rtol": RTOL, "card": card}})

    # -- the main path at full width ----------------------------------------
    cfg = ModelConfig()
    model = RokoModel(cfg)
    model.load_state_dict(state_dict_from_jax(jax_layout_params(rng, cfg)), strict=True)
    model.to(dev).eval()
    n_windows = PATH_BATCHES * PATH_BATCH_SIZE
    draft, positions, examples = synthetic_contig(rng, n_windows, C)
    contig = "synthetic"
    batches = [
        ([contig] * PATH_BATCH_SIZE, positions[i : i + PATH_BATCH_SIZE],
         examples[i : i + PATH_BATCH_SIZE])
        for i in range(0, n_windows, PATH_BATCH_SIZE)
    ]
    predict(model, batches[0][2], dev)  # warm-up: library handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    logs = []
    fg.gru_recurrence.launches = fg.gru_recurrence_backward.launches = 0
    t0 = time.perf_counter()
    polished = run_inference(iter(batches), {contig: draft}, model, device=dev,
                             log=logs.append)
    seconds = time.perf_counter() - t0
    launches = fg.gru_recurrence.launches
    if fg.gru_recurrence_backward.launches:
        fail("the inference path launched gru_bwd")
    peak_bytes = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers * len(batches):
        fail(f"gru_fwd launched {launches} times on the main path, expected "
             f"{cfg.num_layers} layers x {len(batches)} batches")

    # the same batches through the plain recurrence on the card
    kernel_board, plain_board = VoteBoard({contig: draft}), VoteBoard({contig: draft})
    logit_err, near_ties, mismatches = 0.0, 0, 0
    with torch.inference_mode():
        for names, pos, x in batches:
            xt = torch.from_numpy(x).to(dev)
            lk = model(xt)
            lp = model(xt, fg.gru_recurrence_plain)
            if lk.shape != (len(x), cfg.window_cols, cfg.num_classes):
                fail(f"logits shape {tuple(lk.shape)}")
            if not bool(torch.isfinite(lk).all()):
                fail("non-finite logits on the main path")
            logit_err = max(logit_err, (lk - lp).abs().max().item())
            if not torch.allclose(lk, lp, atol=ATOL, rtol=RTOL):
                fail(f"logits of kernel and plain recurrence differ: max |d| {logit_err}")
            top2 = lp.topk(2, dim=-1).values
            close = (top2[..., 0] - top2[..., 1]) < ATOL
            differ = lk.argmax(-1) != lp.argmax(-1)
            near_ties += int(close.sum())
            mismatches += int((differ & ~close).sum())
            kernel_board.add(names, pos, lk.argmax(-1).cpu().numpy())
            plain_board.add(names, pos, lp.argmax(-1).cpu().numpy())
    if mismatches:
        fail(f"{mismatches} argmax differences away from near-ties")
    if kernel_board.stitch(contig) != polished[contig]:
        fail("run_inference's stitch differs from the kernel logits' stitch")
    plain_same = plain_board.stitch(contig) == polished[contig]
    if not plain_same and near_ties == 0:
        fail("the plain recurrence's stitch differs with no near-ties")
    if not polished[contig] or set(polished[contig]) - set("ACGT"):
        fail("the polished contig is empty or holds letters other than ACGT")

    emit({"path": {
        "config": "ModelConfig() (kind=gru, 3 layers, hidden 128, full width)",
        "batches": len(batches), "batch_size": PATH_BATCH_SIZE, "windows": n_windows,
        "draft_len": len(draft), "polished_len": len(polished[contig]),
        "seconds": seconds, "windows_per_s": n_windows / seconds,
        "bases_per_s": n_windows * C.WINDOW_STRIDE / seconds,
        "gru_fwd_launches": launches, "peak_device_bytes": peak_bytes,
        "logits_max_abs_err_vs_plain": logit_err, "near_ties": near_ties,
        "plain_stitch_identical": plain_same, "log": logs, "card": card,
    }})
    # where the device time of the main path goes (a second, traced run)
    emit({"breakdown": {**device_breakdown(
        torch, lambda: run_inference(iter(batches), {contig: draft}, model, device=dev,
                                     log=lambda s: None)), "card": card}})

    # -- the train path at full width ----------------------------------------
    X = rng.integers(0, C.FEATURE_VOCAB, (TRAIN_WINDOWS, C.WINDOW_ROWS, C.WINDOW_COLS),
                     dtype=np.uint8)
    corpus = InMemoryDataset(X, (X.sum(axis=1) % C.NUM_CLASSES).astype(np.int32))
    emit({"train_step_check": {**step_parity(torch, dev, corpus, fg, RokoModel, ModelConfig,
                                             loop),
                               "rtol": STEP_RTOL, "atol_of_max_grad": STEP_ATOL_OF_MAX,
                               "batch": TRAIN_BATCH, "card": card}})

    out_dir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, seed=SEED,
                       val_fraction=TRAIN_VAL_FRACTION)
    train_logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fg.gru_recurrence.launches = fg.gru_recurrence_backward.launches = 0
    t0 = time.perf_counter()
    result = loop.train(corpus, out_dir, model_cfg=cfg, train_cfg=tcfg, device=dev,
                        resume=False, log=train_logs.append)
    train_seconds = time.perf_counter() - t0
    train_fwd, train_bwd = fg.gru_recurrence.launches, fg.gru_recurrence_backward.launches
    train_peak = torch.cuda.max_memory_allocated()
    n_val = round(TRAIN_VAL_FRACTION * TRAIN_WINDOWS)
    eval_batches = -(-n_val // TRAIN_BATCH)
    if len(result.history) != TRAIN_EPOCHS:
        fail(f"train ran {len(result.history)} epochs, expected {TRAIN_EPOCHS}")
    if train_bwd != cfg.num_layers * result.step:
        fail(f"gru_bwd launched {train_bwd} times in training, expected "
             f"{cfg.num_layers} layers x {result.step} steps")
    if train_fwd != cfg.num_layers * (result.step + TRAIN_EPOCHS * eval_batches):
        fail(f"gru_fwd launched {train_fwd} times in training, expected {cfg.num_layers} "
             f"layers x ({result.step} steps + {TRAIN_EPOCHS} x {eval_batches} eval batches)")
    losses = [h["train_loss"] for h in result.history]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    manifests = {}
    for ckpt in sorted(os.listdir(out_dir)):
        status, detail = verify_manifest(os.path.join(out_dir, ckpt))
        manifests[ckpt] = status
        if status != "ok":
            fail(f"checkpoint {ckpt} fails verification: {detail}")
    if "latest" not in manifests or len(manifests) < 2:
        fail(f"expected latest and numbered checkpoints, found {sorted(manifests)}")
    train_secs = sum(h["seconds"] for h in result.history)

    # the best checkpoint polishes the synthetic contig
    trained = RokoModel(cfg)
    trained.load_state_dict(load_params(out_dir), strict=True)
    fg.gru_recurrence.launches = 0
    polished_t = run_inference(iter(batches[:TRAINED_POLISH_BATCHES]), {contig: draft},
                               trained, device=dev, log=lambda s: None)[contig]
    if not polished_t or set(polished_t) - set("ACGT"):
        fail("the trained checkpoint's polish is empty or holds letters other than ACGT")
    if fg.gru_recurrence.launches != cfg.num_layers * TRAINED_POLISH_BATCHES:
        fail("polishing with the trained checkpoint did not run through gru_fwd")
    emit({"train": {
        "config": "ModelConfig() (kind=gru, 3 layers, hidden 128, dropout 0.2, full width)",
        "windows": TRAIN_WINDOWS, "val_fraction": TRAIN_VAL_FRACTION, "batch": TRAIN_BATCH,
        "epochs": TRAIN_EPOCHS, "steps": result.step, "seconds": train_seconds,
        "train_loop_seconds": train_secs, "steps_per_s": result.step / train_secs,
        "windows_per_s": result.step * TRAIN_BATCH / train_secs,
        "history": result.history, "guard": result.guard_counters,
        "gru_fwd_launches": train_fwd, "gru_bwd_launches": train_bwd,
        "eval_batches_per_epoch": eval_batches, "peak_device_bytes": train_peak,
        "checkpoints": manifests, "trained_polish_len": len(polished_t),
        "log": train_logs, "card": card,
    }})

    # where the device time of train steps goes (traced, not counted)
    step_model = result.model.train()
    optimizer = loop.make_optimizer(step_model, tcfg.lr)
    step_batches = [loop.to_device(b, dev) for _, b in zip(
        range(6), corpus.batches(TRAIN_BATCH, rng=np.random.default_rng(1)))]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def train_steps(bs):
        for x, y, w in bs:
            loss, finite = loop.grad_step(step_model, x, y, w, gen)
            if bool(finite):
                optimizer.step()

    train_steps(step_batches[:1])  # warm-up
    emit({"train_breakdown": {**device_breakdown(torch, lambda: train_steps(step_batches[1:])),
                              "steps": len(step_batches) - 1, "card": card}})

    def kernel_row(name, source, replaces, replaces_also, row, by_path):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_also": replaces_also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape": row["shape"], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }

    emit({"kernels": [
        kernel_row("gru_fwd", "roko_tpu_torch/csrc/gru_fwd.cu",
                   "roko_tpu/models/pallas_gru.py:126", "roko_tpu/models/pallas_gru.py:171",
                   main_row, {"inference": launches, "train": train_fwd}),
        kernel_row("gru_bwd", "roko_tpu_torch/csrc/gru_bwd.cu",
                   "roko_tpu/models/pallas_gru.py:200", "roko_tpu/models/pallas_gru.py:305",
                   bwd_row, {"inference": 0, "train": train_bwd}),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
