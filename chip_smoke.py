#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``roko_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --fwd-only ROOT   # gru_fwd alone, from ROOT's port
    python3 chip_smoke.py --bwd-only ROOT   # gru_bwd alone, from ROOT's port
    python3 chip_smoke.py --lingru-only ROOT   # both lingru scans, from ROOT's port

Builds every CUDA kernel of the port from ``roko_tpu_torch/csrc`` (one
nvcc per source, started together), holds each kernel against its plain
PyTorch version at the shapes its path gives it and times both, then
drives the port's main paths with the default model at full width, once
for ``kind="gru"`` and once for ``kind="lingru"``:

- inference: polishes a synthetic contig through
  ``roko_tpu_torch.infer.run_inference`` (random weights from a numpy
  seed, carried in through the JAX weights bridge);
- training: one train step through the kernels against the plain
  recurrence, then ``roko_tpu_torch.training.loop.train`` for two epochs
  over an in-memory labelled corpus with a held-out val set and the guard
  on, its checkpoints verified, and the best one polishing the contig.

Each path runs with every launch count set to 0 just before it and read
just after, and fails unless each kernel of the path launched as often as
the path should launch it, and no other kernel did. Prints JSON lines;
the last line is ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line. Needs one CUDA card, nvcc and nvidia-smi;
imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel check shapes: the main path's (T=90 columns, H=128, both
# directions, batch 512) first, then ragged ones that exercise masking
MAIN_SHAPE = dict(B=512, T=90, IN=500, H=128, S=2)
EXTRA_SHAPES = (
    dict(B=5, T=90, IN=24, H=16, S=2),
    dict(B=13, T=7, IN=256, H=128, S=1),
)
# gru_fwd beyond those: the widest hidden size, which streams W_hh from L2
FWD_STREAMING_SHAPE = dict(B=9, T=33, IN=64, H=512, S=2)
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
# lingru kernel check shapes (B, T, H): lingru_fwd timed at the inference
# batch, lingru_bwd at the train batch, then the other batch and ragged ones
LIN_INFER_SHAPE = dict(B=512, T=90, H=128)
LIN_TRAIN_SHAPE = dict(B=128, T=90, H=128)
LIN_EXTRA_SHAPES = (
    dict(B=5, T=90, H=16),
    dict(B=11, T=40, H=12),
    dict(B=1, T=1, H=4),
    dict(B=9, T=33, H=512),
)
# operations per (row, step, direction, channel), f32, as the kernels do
# them: sigmoid 4 (negate, exp, add, divide), tanh 1, the update 3; the
# backward adds g, da, dz, dc, both gate derivatives and e
LIN_FWD_OPS = 8
LIN_BWD_OPS = 20
LIN_NO_LIBRARY = "no single PyTorch call computes a gated affine scan"
# device-time kinds of the port's kernels, by name; "lingru_fwd" holds
# "gru_fwd", so the lingru names come first
KERNEL_KINDS = ("lingru_fwd", "lingru_bwd", "gru_fwd", "gru_bwd")


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


def jax_layout_lingru_layer(rng, in_size: int, hidden: int):
    b = 1.0 / math.sqrt(in_size)
    return {
        d: {
            "w_zx": uniform(rng, b, (in_size, hidden)),
            "w_cx": uniform(rng, b, (in_size, hidden)),
            "b_z": rng.standard_normal(hidden).astype(np.float32),
            "b_c": rng.standard_normal(hidden).astype(np.float32),
        }
        for d in ("fwd", "bwd")
    }


def jax_layout_params(rng, cfg):
    """Random params of ``cfg.kind`` in the JAX package's tree layout."""

    def dense(i, o):
        b = 1.0 / math.sqrt(i)
        return {"kernel": uniform(rng, b, (i, o)), "bias": uniform(rng, b, (o,))}

    layer = jax_layout_gru_layer if cfg.kind == "gru" else jax_layout_lingru_layer
    return {
        "embedding": rng.standard_normal((cfg.embed_vocab, cfg.embed_dim)).astype(np.float32),
        "fc1": dense(cfg.window_rows, cfg.read_mlp[0]),
        "fc2": dense(cfg.read_mlp[0], cfg.read_mlp[1]),
        "head": dense(2 * cfg.hidden_size, cfg.num_classes),
        cfg.kind: tuple(
            layer(rng, cfg.gru_in_size if k == 0 else 2 * cfg.hidden_size, cfg.hidden_size)
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
    """gru_fwd vs gru_recurrence_plain at ``shape`` on the card, and two
    launches bitwise equal; with ``timed``, also the resident variant
    forced to each rows a block (bitwise equal), a digest of the output
    (equal digests of two trees on the same inputs mean equal bits), and
    the kernel's, the plain loop's and cuDNN's times."""
    B, T, IN, H, S = (shape[k] for k in ("B", "T", "IN", "H", "S"))
    x, t, xp, w_hh, b_hh = layer_inputs(torch, shape, dev, rng)

    got = fg.gru_recurrence(xp, w_hh, b_hh)
    want = fg.gru_recurrence_plain(xp, w_hh, b_hh)
    again = fg.gru_recurrence(xp, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
        fail(f"gru_fwd disagrees with the plain loop at {shape}: max |d| {err}")
    if not torch.equal(got, again):
        fail(f"gru_fwd differs between two launches at {shape}")
    row = {"shape": shape, "max_abs_err": err, "bitwise_repeatable": True,
           **launch_plan(torch, fg, "fwd", shape, dev)}
    if not timed:
        return row

    if row.get("variant") == "resident":
        for rows in fg.RESIDENT_ROWS:
            if not torch.equal(got, fg._gru_fwd_kernel(xp, w_hh, b_hh, rows=rows)):
                fail(f"gru_fwd at {rows} rows a block differs from "
                     f"{row['rows_per_block']} rows at {shape}")
        row["bitwise_equal_across_rows"] = list(fg.RESIDENT_ROWS)
    row["output_sha256"] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()

    # cuDNN's GRU with the same weights: a yardstick only, and it also
    # runs the input product that gru_fwd leaves outside
    ref = cudnn_gru(torch, t, IN, H, S, dev)
    with torch.no_grad():
        lib_out, _ = ref(x)
        row["library_max_abs_err"] = (lib_out - got).abs().max().item()
        row["library_ms"] = cuda_ms(torch, lambda: ref(x), iters=20)
    row["ms"] = cuda_ms(torch, lambda: fg.gru_recurrence(xp, w_hh, b_hh), iters=20)
    row["ms_by_kernel"] = kernel_split(
        torch, lambda: fg.gru_recurrence(xp, w_hh, b_hh), 20, FWD_PARTS)
    row["plain_ms"] = cuda_ms(
        torch, lambda: fg.gru_recurrence_plain(xp, w_hh, b_hh), iters=3, warmup=1
    )
    flops = 2.0 * T * S * B * H * 3 * H  # step matmuls, one FMA = 2 operations
    nbytes = 4.0 * (xp.numel() + w_hh.numel() + b_hh.numel() + got.numel())
    row.update(bound(torch, flops, nbytes))
    return row


def kernel_split(torch, fn, iters: int, parts) -> dict:
    """Device milliseconds a call of ``fn()`` spends in each of ``parts``
    (``(key, substring of the kernel name)``): ``device_breakdown`` of
    ``iters`` calls after one warm-up, each part's kernel time summed and
    divided by ``iters``, with the number and names of the traced kernels
    of each part."""
    fn()
    torch.cuda.synchronize()
    # a trace now and then holds no device events at all: trace again
    for _ in range(3):
        traced = device_breakdown(torch, lambda: [fn() for _ in range(iters)])
        if "kernels_ms_calls" in traced:
            break
    else:
        return {"device": traced["device"]}
    split = {"traced_calls": iters, "kernels_traced": {}, "kernel_names": {}}
    for key, sub in parts:
        hits = {n: v for n, v in traced["kernels_ms_calls"].items() if sub in n}
        split[key] = sum(ms for ms, _ in hits.values()) / iters
        split["kernels_traced"][key] = sum(n for _, n in hits.values())
        split["kernel_names"][key] = sorted(
            re.search(r"\w*gru_(fwd|bwd)\w*(<[\d, ]+>)?", n).group(0) for n in hits)
    return split


# gru_bwd's three kernels and gru_fwd's one, by a substring of their names
BWD_PARTS = (("recurrence", "gru_bwd_rec"), ("dw", "gru_bwd_dw"), ("reduce", "gru_bwd_reduce"))
FWD_PARTS = (("recurrence", "gru_fwd"),)


def launch_plan(torch, fg, kernel: str, shape, dev) -> dict:
    """How gru_``kernel`` (``"fwd"`` or ``"bwd"``) launches at ``shape``
    on this card (``fg.fwd_plan``, ``fg.bwd_plan``); empty for a tree
    whose kernel has no plan (one variant, 8 rows)."""
    plan_of = getattr(fg, f"{kernel}_plan", None)
    if plan_of is None:
        return {}
    B, T, H, S = (shape[k] for k in ("B", "T", "H", "S"))
    plan = plan_of(B, T, H, S, torch.cuda.get_device_properties(dev).multi_processor_count)
    return {"variant": plan["variant"], "rows_per_block": plan["rows"],
            "blocks": plan["blocks"], "threads_per_block": plan["threads"],
            "smem_bytes_per_block": plan["smem_bytes"]}


def check_bwd_kernel(torch, fg, shape, dev, rng, *, timed: bool):
    """gru_bwd vs gru_recurrence_backward_plain at ``shape`` on the card,
    and two launches bitwise equal; with ``timed``, also the resident
    recurrence forced to each rows a block (bitwise equal), and the
    kernel's (split by sub-kernel), the plain loop's and cuDNN's backward
    times."""
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
           "bitwise_repeatable": True, "splits": fg.bwd_splits(B, T, H, S),
           **launch_plan(torch, fg, "bwd", shape, dev)}
    if not timed:
        return row

    if row.get("variant") == "resident":
        for rows in fg.BWD_ROWS:
            forced = fg._gru_bwd_kernel(*args, rows=rows)
            for name, g, f in zip(("dxp", "dw_hh", "db_hh"), got, forced):
                if not torch.equal(g, f):
                    fail(f"gru_bwd {name} at {rows} rows a block differs from "
                         f"{row['rows_per_block']} rows at {shape}")
        row["bitwise_equal_across_rows"] = list(fg.BWD_ROWS)

    # cuDNN's GRU backward with the same weights: a yardstick only; it
    # also runs the dx and dW_ih products that stay outside gru_bwd
    ref = cudnn_gru(torch, t, IN, H, S, dev)
    xr = x.clone().requires_grad_(True)
    lib_out, _ = ref(xr)
    lib_inputs = [xr, *ref.parameters()]
    row["library_ms"] = cuda_ms(
        torch, lambda: torch.autograd.grad(lib_out, lib_inputs, dy, retain_graph=True), iters=20)
    row["ms"] = cuda_ms(torch, lambda: fg.gru_recurrence_backward(*args), iters=20)
    row["ms_by_kernel"] = kernel_split(
        torch, lambda: fg.gru_recurrence_backward(*args), 20, BWD_PARTS)
    row["plain_ms"] = cuda_ms(
        torch, lambda: fg.gru_recurrence_backward_plain(*args), iters=3, warmup=1)
    # hp, dhp W_hh^T and h_prev^T dhp: three step products
    flops = 3 * 2.0 * T * S * B * H * 3 * H
    nbytes = 4.0 * (xp.numel() + out.numel() + dy.numel() + w_hh.numel() + b_hh.numel()
                    + got[0].numel() + got[1].numel() + got[2].numel())
    row.update(bound(torch, flops, nbytes))
    return row


def lingru_plan(torch, fl, kernel: str, shape, dev) -> dict:
    """How lingru_``kernel`` (``"fwd"`` or ``"bwd"``) launches at ``shape``
    on this card (``fl.scan_plan``); empty for a tree whose kernel has no
    plan (one streaming variant)."""
    if kernel not in getattr(fl, "SCAN_DEFAULT", {}):
        return {}
    B, T, H = (shape[k] for k in ("B", "T", "H"))
    plan = fl.scan_plan(B, T, H, torch.cuda.get_device_properties(dev).multi_processor_count,
                        kernel)
    return {"variant": plan["variant"], "steps_per_stage": plan["steps"],
            "stages": plan["stages"], "blocks": plan["blocks"],
            "threads_per_block": plan["threads"], "smem_bytes_per_block": plan["smem_bytes"],
            "waves": plan["waves"]}


def lingru_inputs(torch, kernel: str, fl, shape, dev, rng):
    """The arguments of lingru_``kernel`` at ``shape``: p, and for the
    backward the plain forward's h and a gradient dy."""
    B, T, H = (shape[k] for k in ("B", "T", "H"))
    p = torch.from_numpy(rng.standard_normal((B, T, 4 * H), dtype=np.float32)).to(dev)
    if kernel == "fwd":
        return (p,)
    dy = torch.from_numpy(rng.standard_normal((B, T, 2 * H), dtype=np.float32)).to(dev)
    return p, fl.lingru_scan_plain(p), dy


def check_lingru(torch, fl, kernel: str, shape, dev, rng, *, timed: bool, sweep: bool = False):
    """lingru_``kernel`` vs its plain loop at ``shape`` on the card, two
    launches bitwise equal, and a staged launch bitwise equal at every
    (steps, stages) of ``fl.scan_choices`` and to the streaming variant;
    with ``timed``, also a digest of the output (equal digests of two
    trees on the same inputs mean equal bits), the kernel's device time
    from a trace and the plain loop's time; with ``sweep``, the device
    time of every (steps, stages) and of the streaming variant."""
    B, T, H = (shape[k] for k in ("B", "T", "H"))
    args = lingru_inputs(torch, kernel, fl, shape, dev, rng)
    if kernel == "fwd":
        run, plain = fl.lingru_scan, fl.lingru_scan_plain
    else:
        run, plain = fl.lingru_scan_backward, fl.lingru_scan_backward_plain
    got = run(*args)
    want = plain(*args)
    again = run(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
        fail(f"lingru_{kernel} disagrees with the plain loop at {shape}: max |d| {err}")
    if not torch.equal(got, again):
        fail(f"lingru_{kernel} differs between two launches at {shape}")
    row = {"shape": shape, "max_abs_err": err, "bitwise_repeatable": True,
           **lingru_plan(torch, fl, kernel, shape, dev)}
    forced = getattr(fl, f"_lingru_{kernel}_kernel", None)
    plans = fl.scan_choices(kernel, H) if row.get("variant") == "staged" else []
    for n, m in plans:
        if not torch.equal(got, forced(*args, steps=n, stages=m)):
            fail(f"lingru_{kernel} at {n} steps x {m} stages differs from "
                 f"{row['steps_per_stage']} x {row['stages']} at {shape}")
    if plans:
        if not torch.equal(got, forced(*args, variant="streaming")):
            fail(f"lingru_{kernel}'s staged and streaming variants differ at {shape}")
        row["bitwise_equal_across_plans"] = plans
        row["bitwise_equal_to_streaming"] = True
    if not timed:
        return row
    row["output_sha256"] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    parts = (("scan", f"lingru_{kernel}"),)
    # a launch takes less device time than the wrapper's host time, so CUDA
    # events around back-to-back calls time the host; the kernel's own time
    # is its device time in a trace
    row["ms_events"] = cuda_ms(torch, lambda: run(*args), iters=50)
    row["ms_by_kernel"] = kernel_split(torch, lambda: run(*args), 20, parts)
    row["ms"] = row["ms_by_kernel"].get("scan", row["ms_events"])
    row["ms_from"] = "trace" if "scan" in row["ms_by_kernel"] else "events"
    row["plain_ms"] = cuda_ms(torch, lambda: plain(*args), iters=3, warmup=1)
    row["library_ms"], row["library_note"] = None, LIN_NO_LIBRARY
    if sweep and plans:
        row["ms_by_plan"] = {f"{n}x{m}": kernel_split(
            torch, lambda: forced(*args, steps=n, stages=m), 20, parts).get("scan")
            for n, m in plans}
        row["ms_streaming"] = kernel_split(
            torch, lambda: forced(*args, variant="streaming"), 20, parts).get("scan")
    ops = LIN_FWD_OPS if kernel == "fwd" else LIN_BWD_OPS
    row.update(bound(torch, ops * B * T * 2 * H,
                     4.0 * (sum(a.numel() for a in args) + got.numel())))
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
            kind = next((k for k in KERNEL_KINDS if k in low), None)
            if kind is None:
                kind = ("gemm" if "gemm" in low
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


def step_parity(torch, port, dev, ds, cfg, kernel, plain):
    """One full-width train step of ``cfg`` (dropout off) through the
    kernels (``kernel``) and through the plain recurrence (``plain``):
    loss and every gradient."""
    model = port.RokoModel(cfg, torch.Generator().manual_seed(SEED))
    model.to(dev).train()
    batch = next(ds.batches(TRAIN_BATCH, rng=np.random.default_rng(SEED)))
    x, y, w = port.loop.to_device(batch, dev)

    def grads(recurrence):
        model.zero_grad(set_to_none=True)
        loss, _, _ = port.loop.loss_and_stats(model(x, recurrence), y, w)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    loss_k, got = grads(kernel)
    loss_p, want = grads(plain)
    if not math.isfinite(loss_k) or abs(loss_k - loss_p) > STEP_RTOL * abs(loss_p) + 1e-6:
        fail(f"{cfg.kind} train step loss: kernels {loss_k}, plain recurrence {loss_p}")
    worst = {}
    for name, g in got.items():
        ref = want[name]
        scale = ref.abs().max().item()
        d = (g - ref).abs().max().item()
        worst[name] = [d, scale]
        if not torch.allclose(g, ref, rtol=STEP_RTOL, atol=STEP_ATOL_OF_MAX * scale):
            fail(f"{cfg.kind} train step gradient {name}: max |d| {d} against max |g| {scale}")
    top = max(worst, key=lambda n: worst[n][0] / max(worst[n][1], 1e-30))
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "params": len(got),
            "worst_relative": {"param": top, "max_abs_err": worst[top][0],
                               "max_abs_grad": worst[top][1]},
            "max_abs_err": max(v[0] for v in worst.values()),
            "rtol": STEP_RTOL, "atol_of_max_grad": STEP_ATOL_OF_MAX, "batch": TRAIN_BATCH}


class Counts:
    """The launch counts of the port's kernels, by kernel name."""

    def __init__(self, fg, fl):
        self.wrappers = {"gru_fwd": fg.gru_recurrence, "gru_bwd": fg.gru_recurrence_backward,
                         "lingru_fwd": fl.lingru_scan, "lingru_bwd": fl.lingru_scan_backward}

    def zero(self) -> None:
        for wrapper in self.wrappers.values():
            wrapper.launches = 0

    def expect(self, what: str, want: dict) -> dict:
        """The counts; fails unless they are ``want``, and 0 for every
        kernel ``want`` does not name."""
        got = {name: w.launches for name, w in self.wrappers.items()}
        want = {name: want.get(name, 0) for name in got}
        if got != want:
            fail(f"{what}: kernel launches {got}, expected {want}")
        return got


def drive_inference(torch, port, model, plain, batches, contig, draft, dev, counts, fwd):
    """Polish the synthetic contig with ``model`` through ``run_inference``,
    counted: ``fwd`` launches once per layer and batch, no other kernel
    does. Then the same batches' logits through the kernels against the
    plain recurrence ``plain``, and the stitch against both."""
    cfg = model.cfg
    port.predict(model, batches[0][2], dev)  # warm-up: library handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    logs = []
    counts.zero()
    t0 = time.perf_counter()
    polished = port.run_inference(iter(batches), {contig: draft}, model, device=dev,
                                  log=logs.append)
    seconds = time.perf_counter() - t0
    launches = counts.expect(f"the {cfg.kind} inference path",
                             {fwd: cfg.num_layers * len(batches)})
    peak_bytes = torch.cuda.max_memory_allocated()

    # the same batches through the plain recurrence on the card
    kernel_board = port.VoteBoard({contig: draft})
    plain_board = port.VoteBoard({contig: draft})
    logit_err, near_ties, mismatches = 0.0, 0, 0
    with torch.inference_mode():
        for names, pos, x in batches:
            xt = torch.from_numpy(x).to(dev)
            lk = model(xt)
            lp = model(xt, plain)
            if lk.shape != (len(x), cfg.window_cols, cfg.num_classes):
                fail(f"logits shape {tuple(lk.shape)}")
            if not bool(torch.isfinite(lk).all()):
                fail(f"non-finite logits on the {cfg.kind} inference path")
            logit_err = max(logit_err, (lk - lp).abs().max().item())
            if not torch.allclose(lk, lp, atol=ATOL, rtol=RTOL):
                fail(f"{cfg.kind} logits of kernel and plain recurrence differ: "
                     f"max |d| {logit_err}")
            top2 = lp.topk(2, dim=-1).values
            close = (top2[..., 0] - top2[..., 1]) < ATOL
            differ = lk.argmax(-1) != lp.argmax(-1)
            near_ties += int(close.sum())
            mismatches += int((differ & ~close).sum())
            kernel_board.add(names, pos, lk.argmax(-1).cpu().numpy())
            plain_board.add(names, pos, lp.argmax(-1).cpu().numpy())
    if mismatches:
        fail(f"{cfg.kind}: {mismatches} argmax differences away from near-ties")
    if kernel_board.stitch(contig) != polished[contig]:
        fail(f"{cfg.kind}: run_inference's stitch differs from the kernel logits' stitch")
    plain_same = plain_board.stitch(contig) == polished[contig]
    if not plain_same and near_ties == 0:
        fail(f"{cfg.kind}: the plain recurrence's stitch differs with no near-ties")
    if not polished[contig] or set(polished[contig]) - set("ACGT"):
        fail(f"{cfg.kind}: the polished contig is empty or holds letters other than ACGT")

    n_windows = sum(len(b[0]) for b in batches)
    return {
        "config": f"ModelConfig(kind={cfg.kind!r}) ({cfg.num_layers} layers, hidden "
                  f"{cfg.hidden_size}, full width)",
        "batches": len(batches), "batch_size": len(batches[0][0]), "windows": n_windows,
        "draft_len": len(draft), "polished_len": len(polished[contig]),
        "seconds": seconds, "windows_per_s": n_windows / seconds,
        "bases_per_s": n_windows * port.C.WINDOW_STRIDE / seconds,
        f"{fwd}_launches": launches[fwd], "peak_device_bytes": peak_bytes,
        "logits_max_abs_err_vs_plain": logit_err, "near_ties": near_ties,
        "plain_stitch_identical": plain_same, "log": logs,
    }


def drive_train(torch, port, cfg, corpus, batches, contig, draft, dev, counts, fwd, bwd,
                out_name):
    """``loop.train`` of ``cfg`` on the in-memory corpus, counted (``bwd``
    once per layer and step, ``fwd`` once per layer and step or eval
    batch), its checkpoints verified under ``build/out_name``, and the best
    one polishing the synthetic contig through ``fwd``. Returns the
    record, the result and the train config."""
    out_dir = os.path.join(ROOT, "build", out_name)
    shutil.rmtree(out_dir, ignore_errors=True)
    tcfg = port.TrainConfig(batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, seed=SEED,
                            val_fraction=TRAIN_VAL_FRACTION)
    train_logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    t0 = time.perf_counter()
    result = port.loop.train(corpus, out_dir, model_cfg=cfg, train_cfg=tcfg, device=dev,
                             resume=False, log=train_logs.append)
    train_seconds = time.perf_counter() - t0
    n_val = round(TRAIN_VAL_FRACTION * TRAIN_WINDOWS)
    eval_batches = -(-n_val // TRAIN_BATCH)
    launches = counts.expect(
        f"{cfg.kind} training ({cfg.num_layers} layers, {result.step} steps, "
        f"{TRAIN_EPOCHS} x {eval_batches} eval batches)",
        {fwd: cfg.num_layers * (result.step + TRAIN_EPOCHS * eval_batches),
         bwd: cfg.num_layers * result.step})
    train_peak = torch.cuda.max_memory_allocated()
    if len(result.history) != TRAIN_EPOCHS:
        fail(f"{cfg.kind} train ran {len(result.history)} epochs, expected {TRAIN_EPOCHS}")
    losses = [h["train_loss"] for h in result.history]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{cfg.kind} train losses not finite and falling: {losses}")
    manifests = {}
    for ckpt in sorted(os.listdir(out_dir)):
        status, detail = port.verify_manifest(os.path.join(out_dir, ckpt))
        manifests[ckpt] = status
        if status != "ok":
            fail(f"checkpoint {ckpt} fails verification: {detail}")
    if "latest" not in manifests or len(manifests) < 2:
        fail(f"expected latest and numbered checkpoints, found {sorted(manifests)}")
    train_secs = sum(h["seconds"] for h in result.history)

    # the best checkpoint polishes the synthetic contig; a model trained on
    # random labels may vote GAP everywhere, so the polish may be empty,
    # but it must be the stitch of that model's own votes
    trained = port.RokoModel(cfg)
    trained.load_state_dict(port.load_params(out_dir), strict=True)
    polish_batches = batches[:TRAINED_POLISH_BATCHES]
    counts.zero()
    polished_t = port.run_inference(iter(polish_batches), {contig: draft},
                                    trained, device=dev, log=lambda s: None)[contig]
    counts.expect(f"polishing with the trained {cfg.kind} checkpoint",
                  {fwd: cfg.num_layers * len(polish_batches)})
    board = port.VoteBoard({contig: draft})
    for names, pos, x in polish_batches:
        board.add(names, pos, port.predict(trained, x, dev).cpu().numpy())
    if set(polished_t) - set("ACGT") or polished_t != board.stitch(contig):
        fail(f"the trained {cfg.kind} checkpoint's polish holds letters other than ACGT "
             "or is not the stitch of its votes")
    record = {
        "config": f"ModelConfig(kind={cfg.kind!r}) ({cfg.num_layers} layers, hidden "
                  f"{cfg.hidden_size}, dropout {cfg.dropout}, full width)",
        "windows": TRAIN_WINDOWS, "val_fraction": TRAIN_VAL_FRACTION, "batch": TRAIN_BATCH,
        "epochs": TRAIN_EPOCHS, "steps": result.step, "seconds": train_seconds,
        "train_loop_seconds": train_secs, "steps_per_s": result.step / train_secs,
        "windows_per_s": result.step * TRAIN_BATCH / train_secs,
        "history": result.history, "guard": result.guard_counters,
        f"{fwd}_launches": launches[fwd], f"{bwd}_launches": launches[bwd],
        "eval_batches_per_epoch": eval_batches, "peak_device_bytes": train_peak,
        "checkpoints": manifests, "trained_polish_len": len(polished_t),
        "log": train_logs,
    }
    return record, result, tcfg


def train_breakdown(torch, port, result, corpus, tcfg, dev):
    """Where the device time of train steps goes (traced, not counted):
    five steps of the trained model after one warm-up step."""
    loop = port.loop
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
    return {**device_breakdown(torch, lambda: train_steps(step_batches[1:])),
            "steps": len(step_batches) - 1}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def one_kernel(torch, flag: str, root: str) -> None:
    """Only gru_bwd (``--bwd-only``), only gru_fwd (``--fwd-only``) or only
    the lingru scans (``--lingru-only``), from the port package under
    ``root`` (this tree's or an unpacked copy of another commit's): built,
    checked against the plain loops and timed, gru_bwd at the train shape
    split by sub-kernel, gru_fwd and both lingru scans at the inference
    and the train batch (the scans also at every steps and stages of their
    plan). Two trees compare within one call as parent, change, change,
    parent."""
    sys.path.insert(0, os.path.abspath(root))
    try:
        from roko_tpu_torch import kernels
        from roko_tpu_torch.models import fused_gru as fg
        from roko_tpu_torch.models import fused_lingru as fl
    except ImportError as e:
        fail(f"no importable roko_tpu_torch under {root}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    name = flag[2:-5]
    names = ["lingru_fwd", "lingru_bwd"] if name == "lingru" else [f"gru_{name}"]
    built = kernels.build(names)
    dev, rng = torch.device("cuda", 0), np.random.default_rng(SEED)
    if name == "bwd":
        result = check_bwd_kernel(torch, fg, TRAIN_SHAPE, dev, rng, timed=True)
    elif name == "fwd":
        result = {"rows": [check_kernel(torch, fg, s, dev, rng, timed=True)
                           for s in (MAIN_SHAPE, TRAIN_SHAPE)]}
    else:
        result = {f"lingru_{k}": [check_lingru(torch, fl, k, s, dev, rng, timed=True, sweep=True)
                                  for s in (LIN_INFER_SHAPE, LIN_TRAIN_SHAPE)]
                  for k in ("fwd", "bwd")}
    emit({f"{name}_only": {"root": root, "package": os.path.dirname(kernels.__file__),
                           "ptxas": {n: built.get(n, {}).get("ptxas") for n in names},
                           **result, "card": card}})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if sys.argv[1:2] in (["--bwd-only"], ["--fwd-only"], ["--lingru-only"]) and len(sys.argv) == 3:
        return one_kernel(torch, sys.argv[1], sys.argv[2])
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}; usage: chip_smoke.py "
             "[--bwd-only ROOT | --fwd-only ROOT | --lingru-only ROOT]")
    sys.path.insert(0, ROOT)
    try:
        from roko_tpu_torch import constants as C
        from roko_tpu_torch import kernels
        from roko_tpu_torch.config import ModelConfig, TrainConfig
        from roko_tpu_torch.infer import VoteBoard, predict, run_inference
        from roko_tpu_torch.models import fused_gru as fg
        from roko_tpu_torch.models import fused_lingru as fl
        from roko_tpu_torch.models.convert import state_dict_from_jax
        from roko_tpu_torch.models.model import RokoModel
        from roko_tpu_torch.training import loop
        from roko_tpu_torch.training.checkpoint import load_params, verify_manifest
        from roko_tpu_torch.training.data import InMemoryDataset
    except ImportError as e:
        fail(f"the port package roko_tpu_torch is not importable beside this script: {e}")
    port = types.SimpleNamespace(
        C=C, TrainConfig=TrainConfig, VoteBoard=VoteBoard, predict=predict,
        run_inference=run_inference, RokoModel=RokoModel, loop=loop,
        load_params=load_params, verify_manifest=verify_manifest,
    )
    counts = Counts(fg, fl)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
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
    # gru_fwd at the train batch and the streaming width draw from a stream
    # of their own, so the later phases see the inputs they saw before
    fwd_rng = np.random.default_rng(SEED + 2)
    fwd_train_row = check_kernel(torch, fg, TRAIN_SHAPE, dev, fwd_rng, timed=True)
    extra.append(check_kernel(torch, fg, FWD_STREAMING_SHAPE, dev, fwd_rng, timed=False))
    for row in (main_row, fwd_train_row):
        traced = row["ms_by_kernel"].get("kernel_names", {}).get("recurrence", [])
        if row["variant"] != "resident" or not all("resident" in n for n in traced):
            fail(f"gru_fwd at {row['shape']} ran {row['variant']} ({traced}), not the "
                 "resident kernel")
    if extra[-1]["variant"] != "streaming":
        fail(f"gru_fwd at {FWD_STREAMING_SHAPE} ran {extra[-1]['variant']}, not streaming")
    bwd_row = check_bwd_kernel(torch, fg, TRAIN_SHAPE, dev, rng, timed=True)
    bwd_extra = [check_bwd_kernel(torch, fg, s, dev, rng, timed=False) for s in BWD_EXTRA_SHAPES]
    traced = bwd_row["ms_by_kernel"].get("kernel_names", {}).get("recurrence", [])
    if bwd_row["variant"] != "resident" or not all("resident" in n for n in traced):
        fail(f"the train shape's gru_bwd ran {bwd_row['variant']} ({traced}), not the "
             "resident recurrence")
    # the lingru phases draw from a stream of their own, so the gru phases
    # see the same inputs as before lingru was ported
    lin_rng = np.random.default_rng(SEED + 1)
    lin_fwd_row = check_lingru(torch, fl, "fwd", LIN_INFER_SHAPE, dev, lin_rng, timed=True)
    lin_fwd_train_row = check_lingru(torch, fl, "fwd", LIN_TRAIN_SHAPE, dev, lin_rng, timed=True)
    lin_fwd_extra = [check_lingru(torch, fl, "fwd", s, dev, lin_rng, timed=False)
                     for s in LIN_EXTRA_SHAPES]
    lin_bwd_row = check_lingru(torch, fl, "bwd", LIN_TRAIN_SHAPE, dev, lin_rng, timed=True)
    lin_bwd_extra = [check_lingru(torch, fl, "bwd", s, dev, lin_rng, timed=False)
                     for s in (LIN_INFER_SHAPE, *LIN_EXTRA_SHAPES)]
    # the full-width shapes run the staged scans
    for kernel, rows in (("lingru_fwd", (lin_fwd_row, lin_fwd_train_row)),
                         ("lingru_bwd", (lin_bwd_row, lin_bwd_extra[0]))):
        for row in rows:
            traced = row.get("ms_by_kernel", {}).get("kernel_names", {}).get("scan", [])
            if row.get("variant") != "staged" or not all("staged" in n for n in traced):
                fail(f"{kernel} at {row['shape']} ran {row.get('variant')} ({traced}), not the "
                     "staged kernel")
    emit({"kernel_check": {"gru_fwd": [main_row, fwd_train_row, *extra],
                           "gru_bwd": [bwd_row, *bwd_extra],
                           "lingru_fwd": [lin_fwd_row, lin_fwd_train_row, *lin_fwd_extra],
                           "lingru_bwd": [lin_bwd_row, *lin_bwd_extra],
                           "atol": ATOL, "rtol": RTOL, "card": card}})

    # -- the inference paths at full width ----------------------------------
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
    path = drive_inference(torch, port, model, fg.gru_recurrence_plain, batches, contig,
                           draft, dev, counts, "gru_fwd")
    launches = path["gru_fwd_launches"]
    emit({"path": {**path, "card": card}})
    # where the device time of the main path goes (a second, traced run)
    emit({"breakdown": {**device_breakdown(
        torch, lambda: run_inference(iter(batches), {contig: draft}, model, device=dev,
                                     log=lambda s: None)), "card": card}})

    lin_cfg = ModelConfig(kind="lingru")
    lin_model = RokoModel(lin_cfg)
    lin_model.load_state_dict(state_dict_from_jax(jax_layout_params(lin_rng, lin_cfg)),
                              strict=True)
    lin_model.to(dev).eval()
    lin_path = drive_inference(torch, port, lin_model, fl.lingru_scan_plain, batches, contig,
                               draft, dev, counts, "lingru_fwd")
    emit({"lingru_path": {**lin_path, "card": card}})
    emit({"lingru_breakdown": {**device_breakdown(
        torch, lambda: run_inference(iter(batches), {contig: draft}, lin_model, device=dev,
                                     log=lambda s: None)), "card": card}})

    # -- the train paths at full width ----------------------------------------
    X = rng.integers(0, C.FEATURE_VOCAB, (TRAIN_WINDOWS, C.WINDOW_ROWS, C.WINDOW_COLS),
                     dtype=np.uint8)
    corpus = InMemoryDataset(X, (X.sum(axis=1) % C.NUM_CLASSES).astype(np.int32))
    emit({"train_step_check": {**step_parity(
        torch, port, dev, corpus, ModelConfig(dropout=0.0), fg.gru_recurrence,
        fg.gru_recurrence_plain), "card": card}})
    train, result, tcfg = drive_train(torch, port, cfg, corpus, batches, contig, draft, dev,
                                      counts, "gru_fwd", "gru_bwd", "chip_smoke_train")
    train_fwd, train_bwd = train["gru_fwd_launches"], train["gru_bwd_launches"]
    emit({"train": {**train, "card": card}})
    emit({"train_breakdown": {**train_breakdown(torch, port, result, corpus, tcfg, dev),
                              "card": card}})

    emit({"lingru_train_step_check": {**step_parity(
        torch, port, dev, corpus, ModelConfig(kind="lingru", dropout=0.0), fl.lingru_scan,
        fl.lingru_scan_plain), "card": card}})
    lin_train, lin_result, _ = drive_train(
        torch, port, lin_cfg, corpus, batches, contig, draft, dev, counts, "lingru_fwd",
        "lingru_bwd", "chip_smoke_train_lingru")
    emit({"lingru_train": {**lin_train, "card": card}})
    emit({"lingru_train_breakdown": {
        **train_breakdown(torch, port, lin_result, corpus, tcfg, dev), "card": card}})

    def timing(row):
        return {
            "shape": row["shape"], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{k: row[k] for k in ("ms_from", "library_note", "variant", "rows_per_block",
                                   "steps_per_stage", "stages", "blocks", "waves",
                                   "smem_bytes_per_block", "ms_by_kernel") if k in row},
        }

    def kernel_row(name, source, replaces, replaces_also, row, by_path, **also):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_also": replaces_also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **timing(row), **{k: timing(r) for k, r in also.items()},
        }

    emit({"kernels": [
        kernel_row("gru_fwd", "roko_tpu_torch/csrc/gru_fwd.cu",
                   "roko_tpu/models/pallas_gru.py:126", "roko_tpu/models/pallas_gru.py:171",
                   main_row, {"inference": launches, "train": train_fwd},
                   at_train_batch=fwd_train_row),
        kernel_row("gru_bwd", "roko_tpu_torch/csrc/gru_bwd.cu",
                   "roko_tpu/models/pallas_gru.py:200", "roko_tpu/models/pallas_gru.py:305",
                   bwd_row, {"inference": 0, "train": train_bwd}),
        kernel_row("lingru_fwd", "roko_tpu_torch/csrc/lingru_fwd.cu",
                   "roko_tpu/models/pallas_lingru.py:90", None, lin_fwd_row,
                   {"inference": lin_path["lingru_fwd_launches"],
                    "train": lin_train["lingru_fwd_launches"]},
                   at_train_batch=lin_fwd_train_row),
        kernel_row("lingru_bwd", "roko_tpu_torch/csrc/lingru_bwd.cu",
                   "roko_tpu/models/pallas_lingru.py:121", None, lin_bwd_row,
                   {"inference": 0, "train": lin_train["lingru_bwd_launches"]}),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
