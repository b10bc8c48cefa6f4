#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``roko_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the inference path from ``roko_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the main path's
shapes and times both, then polishes a synthetic contig through the port's
main path (``roko_tpu_torch.infer.run_inference``) with the default model at
full width (random weights from a numpy seed, carried in through the JAX
weights bridge) and checks that the path ran through the kernels. Prints
JSON lines; the last line is ``{"ok": true, "device": {...}}``. Any failed
phase exits non-zero without that line. Needs one CUDA card, nvcc and
nvidia-smi; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
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


def check_kernel(torch, fg, shape, dev, rng, *, timed: bool):
    """gru_fwd vs gru_recurrence_plain at ``shape`` on the card; with
    ``timed``, also the kernel's, the plain loop's and cuDNN's times."""
    B, T, IN, H, S = (shape[k] for k in ("B", "T", "IN", "H", "S"))
    layer = jax_layout_gru_layer(rng, IN, H)
    dirs = [layer["fwd"], layer["bwd"]][:S]
    x = torch.from_numpy(rng.standard_normal((B, T, IN), dtype=np.float32)).to(dev)
    t = {k: [torch.from_numpy(d[k]).to(dev) for d in dirs] for k in dirs[0]}
    xp = (x @ torch.cat(t["w_ih"], 1) + torch.cat(t["b_ih"])).contiguous()
    w_hh = torch.stack(t["w_hh"]).contiguous()
    b_hh = torch.stack(t["b_hh"]).contiguous()

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
    ref = torch.nn.GRU(IN, H, batch_first=True, bidirectional=S == 2).to(dev)
    with torch.no_grad():
        for s, suffix in enumerate(["", "_reverse"][:S]):
            getattr(ref, f"weight_ih_l0{suffix}").copy_(t["w_ih"][s].t())
            getattr(ref, f"weight_hh_l0{suffix}").copy_(t["w_hh"][s].t())
            getattr(ref, f"bias_ih_l0{suffix}").copy_(t["b_ih"][s])
            getattr(ref, f"bias_hh_l0{suffix}").copy_(t["b_hh"][s])
        lib_out, _ = ref(x)
        row["library_max_abs_err"] = (lib_out - got).abs().max().item()
        row["library_ms"] = cuda_ms(torch, lambda: ref(x), iters=20)
    row["ms"] = cuda_ms(torch, lambda: fg.gru_recurrence(xp, w_hh, b_hh), iters=20)
    row["plain_ms"] = cuda_ms(
        torch, lambda: fg.gru_recurrence_plain(xp, w_hh, b_hh), iters=3, warmup=1
    )
    flops = 2.0 * T * S * B * H * 3 * H  # step matmuls, one FMA = 2 operations
    nbytes = 4.0 * (xp.numel() + w_hh.numel() + b_hh.numel() + got.numel())
    peak_flops, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    row.update(
        flop=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )
    return row


def device_breakdown(torch, run):
    """Run ``run()`` under torch.profiler and sum the card's kernel time by
    kernel name; the busy share is the union of kernel intervals over the
    span from the first kernel's start to the last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, by_kind = [], {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            ms = e.time_range.elapsed_us() / 1e3
            key = e.name[:80]
            total, n = by_name.get(key, (0.0, 0))
            by_name[key] = (total + ms, n + 1)
            low = e.name.lower()
            kind = ("gru_fwd" if "gru_fwd" in low else "gemm" if "gemm" in low
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
    emit({"kernel_check": {"gru_fwd": [main_row, *extra], "atol": ATOL, "rtol": RTOL,
                           "card": card}})

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
    fg.gru_recurrence.launches = 0
    t0 = time.perf_counter()
    polished = run_inference(iter(batches), {contig: draft}, model, device=dev,
                             log=logs.append)
    seconds = time.perf_counter() - t0
    launches = fg.gru_recurrence.launches
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
    emit({"kernels": [{
        "name": "gru_fwd",
        "route": "cuda",
        "source": "roko_tpu_torch/csrc/gru_fwd.cu",
        "replaces": "roko_tpu/models/pallas_gru.py:126",
        "replaces_also": "roko_tpu/models/pallas_gru.py:171",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
