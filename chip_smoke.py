#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``roko_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --fwd-only ROOT   # gru_fwd alone, from ROOT's port
    python3 chip_smoke.py --bwd-only ROOT   # gru_bwd alone, from ROOT's port
    python3 chip_smoke.py --fwd-bf16-only ROOT   # gru_fwd_bf16 alone, from ROOT's port
    python3 chip_smoke.py --bwd-bf16-only ROOT   # gru_bwd_bf16 alone, from ROOT's port
    python3 chip_smoke.py --lingru-only ROOT   # both lingru scans, from ROOT's port
    python3 chip_smoke.py --lingru-bf16-only ROOT   # both bf16 lingru scans, from ROOT's port
    python3 chip_smoke.py --train-plane-only   # the train_plane phase alone
    python3 chip_smoke.py --mesh-only          # the mesh phase alone
    python3 chip_smoke.py --tp-sp-only         # the tp_sp phase alone
    python3 chip_smoke.py --serve-only         # the serve phase alone
    python3 chip_smoke.py --coldstart-only     # the coldstart phase alone
    python3 chip_smoke.py --fleet-only         # the fleet phase alone
    python3 chip_smoke.py --cascade-only       # the cascade phase alone
    python3 chip_smoke.py --distpolish-only    # polish --distributed alone
    python3 chip_smoke.py --federation-only    # the federation phase alone
    python3 chip_smoke.py --mesh-serve-only    # the mesh_serve phase alone
    python3 chip_smoke.py --quality-only       # the quality phase alone
    python3 chip_smoke.py --fleet-mesh-only    # the fleet_mesh phase alone
    python3 chip_smoke.py --fleet-mix-only     # the fleet_mix phase alone
    python3 chip_smoke.py --mesh-child SPEC    # one rank of the mesh, tp_sp or mesh_serve phase

Builds every CUDA kernel of the port from ``roko_tpu_torch/csrc`` (one
nvcc per source, started together), holds each kernel against its plain
PyTorch version at the shapes its path gives it and times both, then
drives the port's main paths with the default model at full width, once
for ``kind="gru"`` and once for ``kind="lingru"`` (and ``kind="transformer"``,
which launches no kernel, in a phase of its own):

- inference: polishes a synthetic contig through
  ``roko_tpu_torch.infer.run_inference`` (random weights from a numpy
  seed, carried in through the JAX weights bridge);
- polish (gru only): a 500 kb simulated project (draft FASTA + reads
  BAM), the native extractor built with g++ and held bitwise against the
  Python one on a 20 kb sub-region, the region fan-out over 4 threads,
  and the windows through the same inference path; with h5py on the
  machine, also ``python -m roko_tpu_torch polish --staged`` in a
  subprocess, its FASTA byte-equal to the in-memory polish;
- stream_polish: the default ``polish`` engine, ``run_streaming_polish``,
  on the same project, once with each model: 4 extraction threads
  feeding the continuous batcher and a warm session on the card (ladder
  32 / 128 / 512, batch 512), its FASTA byte-equal to the in-memory
  staged stitch of the same windows with the same model; for gru also
  ``gru_fwd`` and ``lingru_fwd`` held at every rung, a traced second run
  for the card's busy share, the stream's wall time over the serial
  extraction + inference (cold and warm fan-out), and the assess tool
  (native aligner) on the sim draft against its truth;
- precision: the bfloat16 kernels (``gru_fwd_bf16``, ``lingru_fwd_bf16``,
  ``gru_bwd_bf16``, ``lingru_bwd_bf16``) held against their plain bf16
  versions and timed beside the f32 ones (and cuDNN's bf16 GRU), the bf16
  scans staged at full width and bitwise equal at every plan,
  ``gru_bwd_bf16``'s weight-gradient pass timed on its own beside
  ``torch.bmm`` of the same operands (``dw_pass``); inference
  of the synthetic windows in bf16 (gru and lingru) and in int8 with f32
  compute (gru), each beside f32 in windows/s and argmax agreement; and
  the polish project streamed in bf16, its FASTA byte-equal to the bf16
  staged stitch and compared with the f32 one;
- training, in f32 and then in bf16 compute for each kind: one train step
  through the kernels against the plain recurrence, then
  ``roko_tpu_torch.training.loop.train`` for two epochs over an in-memory
  labelled corpus with a held-out val set and the guard on, its
  checkpoints verified, and the best one polishing the contig; the bf16
  run through the bf16 kernels alone, its windows/s and losses printed
  beside the f32 run's;
- transformer: ``kind="transformer"`` at full width (3 layers, d_model
  256, 8 heads, mlp_ratio 4; random weights from a numpy seed in the JAX
  layout, through the weights bridge), which runs plain matrix products
  and none of the kernels: the synthetic windows through
  ``run_inference`` in f32 and bf16 with windows/s, the f32 logits of 64
  windows against the same model on the host CPU (rtol 1e-4, atol 1e-5;
  argmax equal where the top-two gap exceeds 1e-4), bf16's argmax
  agreement with f32 and largest logit delta; the polish project
  streamed, byte-equal to its staged stitch; ``train`` for two epochs in
  f32 and in bf16, checkpoints verified, the best polishing, windows/s
  and losses beside the gru runs'; every launch count 0 on each path;
- quality: the end-to-end quality loop of
  ``roko_tpu_torch/examples/synthetic_e2e.py`` on true labels, in the
  uniform and then the homopolymer error regime: the 12 kb / 30x sim
  project, its training windows and labels built in memory (what
  ``features --Y`` writes to HDF5) into ``loop.train`` (full-width gru
  f32, batch 64, lr 3e-3, 25 epochs, 10 % held out, early stopping), the
  best checkpoint polishing the inference windows through
  ``run_inference`` (the ``VoteBoard`` stitch of its own votes, every
  batch's logits against the plain recurrence), and ``assess_fastas``
  against the truth; ``gru_fwd``, ``gru_bwd`` and ``gru_fwd_bf16`` held
  against their plain loops at the path's batch sizes; the draft's error
  rate must be BASELINE.md's 1.2083 % / 4.2167 % to the printed digits and
  the polish under a third of it; the uniform checkpoint also polishes in bf16 and
  int8, printed with their error rates and Q (``--quality-only`` runs this
  phase alone);
- train_plane: the training data plane and run controls, gru f32 at full
  width on an in-memory corpus of 2048 windows at batch 128: run A two
  epochs saving ``latest`` every 5 steps, the same from a RokoConfig JSON
  file, run B stopped by its log hook at epoch 1 step 8 and resumed (at
  epoch 1, batch 5; the same batches from there on, and the same
  parameters, bitwise when the card's train step repeats bitwise, else
  within 1e-4 of each tensor's largest entry with the nondeterministic
  gradient named), one epoch of each of 2 shards (a step batch of 64,
  disjoint rows whose union is the 1-shard epoch), the engine's readahead
  against none, and ``trace_dir`` traces of train and inference holding
  ``gru_fwd`` and ``gru_bwd`` device time (``--train-plane-only`` runs
  this phase alone); with h5py on the machine also ``train --no-memory
  --save-every-steps 5`` on the corpus written to HDF5;
- bench: ``python -m roko_tpu_torch bench --train`` in this process
  (``benchmark.main`` at a pinned iteration count: the inference sweep at
  batch 512 and 2048, the per-kind rows, the recurrence alone, the
  precision column, the train rows, ``train_transformer`` among them),
  its JSON line printed, failing on an error in any row of a ported suite
  or a ``train_transformer`` row without windows/s; before it, the kernels at the
  shapes its suites give them that no earlier phase launches (batch 2048;
  hidden 256, the f32 streaming recurrences, at batch 512), each held
  against its plain version; its mesh suite (``--mesh-devices 1,2``:
  one global batch of 128 on one session over 1 and 2 child processes
  sharing the card) runs in those processes, whose launches it reports by
  rank;
- mesh: data parallelism across processes, the ranks joined by
  ``ROKO_*`` as a user's would be: (a) an NCCL group of one rank, a dp
  train step (all-reduced through NCCL) against the plain step; (b) two
  gloo ranks sharing the card (NCCL refuses two ranks on one card), gru
  f32 at full width, global batch 128: one dp step with dropout on
  against one rank's step at the same batch and masks, one epoch of
  ``train`` with shards = ranks, the replicas' parameters bitwise equal,
  each rank's ``gru_fwd``/``gru_bwd`` launches and windows/s beside a
  one-rank epoch; (c) their contig-split inference of 4 synthetic contigs,
  FASTA byte-identical to one rank's; (d) the bench's mesh suite
  byte-identical across 1 and 2 ranks. NCCL across cards is not run:
  the machine has one card. The mesh contigs' names are not in sorted
  order: one rank writes the draft's order, two ranks the names sorted;
- tp_sp: tensor and sequence parallelism of ``kind="transformer"`` at full
  width (dropout 0.2), gloo ranks sharing the card: (a) ring attention
  alone at sp 2 and 3 (T=90, B=128) against dense attention here, output
  and dq/dk/dv; (b) one train step at dp1 x tp2, dp1 x sp2 and dp2 x tp2
  against one rank's step at the global batch with the same masks, and
  every rank holding a part bitwise equal to its peers after 3 Adam steps;
  (c) the mesh contigs polished at tp2 and sp2 against one rank (FASTA,
  logits, argmax flips only where one rank's top-two gap is under the max
  |d logits|); (d) windows/s of each layout's step and inference beside
  one rank's; (e) the ring's transport per backend and one rotation's
  time. Every launch count stays 0 (the transformer runs no kernel);
- serve: the polishing service, ``kind="gru"`` at full width (random
  weights from a numpy seed through the weights bridge), the default
  ladder 32 / 128 / 512: (a) ``python -m roko_tpu_torch serve CKPT --port
  0 --announce F`` as a subprocess, /healthz polled out of ``warming``,
  7-, 300- and 700-window requests, each ``polished`` byte-equal to the
  port's staged stitch of the same windows on the card, and a
  ``/profilez?seconds=1`` capture taken under requests whose trace must
  hold ``gru_fwd`` kernels; (b) closed-loop mixed load in this process on
  one warm session through ``make_server`` and ``PolishClient``: the
  bench's schedule (``4:90,256:10``, 48 requests, 6 clients) under the
  deadline, continuous and ragged batchers, every reply byte-equal to the
  solo-predict stitch, with req/s, p50 and p99 by size class, padding
  efficiency and ``gru_fwd`` launches by mode; a ``kind="lingru"`` session
  the same way (continuous, 12 requests, ``lingru_fwd``); (c) the same in
  bf16 (continuous), each reply byte-equal to the bf16 staged stitch;
  (d) SIGTERM to the subprocess while a 700-window request's body is half
  sent: the request completes with 200, a new one gets 503, and the
  process exits 0 within ``drain_deadline_s``; (e) the warmup seconds and
  the subprocess's start-to-ready seconds (``--serve-only`` runs this
  phase alone);
- mesh_serve: ONE polishing session over two gloo ranks sharing the card
  (``serve/session.py`` on a ``parallel.mesh.Mesh``, the full-width gru
  f32 model of seed 0, its auto ladder 64 / 256 / 1024 = 2 x 32 / 128 /
  512): rank 0 serves the serve phase's mix through ``make_server`` under
  the continuous and then the ragged batcher on the same warm session,
  every reply byte-equal to this process's one-rank solo stitch (itself
  checked against the staged stitch), ``/healthz`` reporting ``mesh_dp``
  2 and ``devices`` 2; then the 100 kb project streams on a 2-rank session
  to this process's one-rank FASTA byte for byte. Each rank's ``gru_fwd``
  launches are 3 times the dispatches it ran. The line gives windows/s at
  dp 1 (this process) and dp 2 (the ranks), which measures sharing one
  card, not scaling, and the leader's host collectives' ms a dispatch
  (``--mesh-serve-only``);
- coldstart: ``benchmark.run_coldstart_suite`` at full width (gru, 3
  layers, h=128, f32; the ladder 32 / 128 / 512): time to the first
  prediction of four starts, each a child process: ``cold`` (an empty
  build directory through ``ROKO_COMPILE_CACHE``, nvcc runs),
  ``cold_parallel`` (the cache off, the rungs at once), ``warm_cache``
  (``cold``'s directory again) and ``aot`` (the kernel bundle, the cache
  off); fails unless ``cold`` ran nvcc and ``warm_cache`` and ``aot``
  ran none (``roko_compile_cache_misses`` 0) (``--coldstart-only``);
- fleet: the single-host fleet at full width: ``python -m roko_tpu_torch
  compile`` writes bundles v1 and v2 at once (weights of two seeds
  through the weights bridge), v1 checked in a fresh process, each
  registered with ``--params``; a lingru config loading v1 and a v1 whose manifest names
  another card each make ``serve`` exit non-zero naming ``model.kind``
  and ``device_kind``; ``serve --workers 2 --devices-per-worker 0
  --bundle v1`` as a subprocess (supervisor, two workers and the clients
  on the one card, the build cache off): the 7-, 300- and 700-window
  replies byte-equal to the staged stitch of v1's weights, every
  worker's ``roko_compile_cache_misses`` 0, req/s under closed-loop load,
  a worker SIGKILLed under load (every reply 200 and byte-equal, the
  worker back in rotation), ``python -m roko_tpu_torch rollout v2`` under
  load (no request fails, each reply v1's or v2's stitch, one worker at a
  time, every reply v2's after), and SIGTERM to the supervisor (rolling
  drain, exit 0, no worker process left); the workers' kernel launches
  come from the files they rewrite at their warmup's end, before each
  answered reply and at exit (``--fleet-only``). Before
  the drain, the ``distpolish`` line: a distributed polish job posted to
  that supervisor (``POST /job``) on the polish phase's project with
  span units, the worker of its first unit SIGKILLed mid-unit; it passes
  when ``GET /jobz`` says ``done``, at most one unit ran twice, the FASTA
  is the single-process polish's on the card byte for byte, the
  supervisor holds no context on the card (``nvidia-smi
  --query-compute-apps``, and its ``/dev/nvidia*`` handles), and the
  workers' files, read just before ``POST /job`` and at its end, show
  the job's windows served exactly once and ``gru_fwd`` launched 3 times
  a step that served them (the path's own count; the fleet's is the
  rest). ``--distpolish-only`` runs ``polish --distributed`` from the
  command line instead, on a 100 kb project with its own 2-worker
  fleet, counted the same way, in a session of its own; the
  coordinator's process group and the one its fleet's workers run in
  must both be empty at the end.
- the ``cascade`` line (``cascade/``, on the polish phase's windows and
  the gru model): threshold 0's FASTA the plain path's byte for byte;
  the majority tier at 0.05 over an on-disk cache, cold then warm
  (escalation share, windows/s beside the plain path's, the warm run's
  hit rate 1 with no launch, tier 1's host seconds beside tier 2's); the
  ``model`` tier with a registered lingru checkpoint (``lingru_fwd`` 3
  times a batch beside ``gru_fwd`` for the escalated batches, in one
  process; escalating every window, the plain path's FASTA), again at a
  threshold set from the median tier-1 confidence (the FASTA voted from
  the lingru model's argmax on the kept rows and the plain path's rows
  on the escalated ones), and a gru-only kernel bundle refused for it,
  naming the library; the logits of escalated subsets of 37 and 301 rows against
  the same rows of the full 512-row batch (the argmax that differ and the
  largest difference, recorded); and the bench's ``cascade`` rows
  (``--cascade-only`` runs it on a 100 kb project).
- the ``federation`` line (``serve/federation.py``, ``serve/transport.py``,
  ``datapipe/store.py``; ``--federation-only`` runs it alone), on the
  ``--distpolish-only`` project: a ``StubObjectStore`` on loopback holds
  the draft, the BAM and its BAI, and ``python -m roko_tpu_torch polish``
  reads them and writes its FASTA there (``s3://`` through
  ``--store-endpoint``) under ``ROKO_STORE_FAULTS`` at the storage gate's
  rates (seed 42): the FASTA read back is the single-process polish's byte
  for byte and retries were logged. Meanwhile a federation front in this
  process (its relays at ``ROKO_FED_FAULTS=drop:0.1,delay:0.2,
  duplicate:0.1``) and two host agents (``serve MODEL --host-agent --join
  ... --workers 1``, each in a session of its own) start; closed-loop
  ``/polish`` load through the front (every reply the staged stitch,
  ``X-Roko-Host`` naming both hosts), a ``front-h1`` partition pulse and
  a SIGKILL of h1's whole group under load (no client error, ``/healthz``
  degraded, h1's worker gone from ``nvidia-smi --query-compute-apps``),
  h1 started again (epoch one higher, routed to again), ``POST /job`` to
  h0 with ``s3://`` draft, BAM and output (the FASTA the single
  process's; ``gru_fwd`` 3 times each step of the job, from h0's worker
  files read just before and at its end), and SIGTERM to both agents
  (exit 0, no worker left). The host rollout and the host autoscaler are
  held on the CPU only.
- fleet_mesh (``--fleet-mesh-only``; :func:`drive_fleet_mesh`): ``serve
  --workers 1 --dp 2`` on shared cards, the supervisor starting its one
  worker as two gloo ranks of one session on the card; replies byte-equal
  to the staged stitch and a one-rank session's, each rank's ``gru_fwd``
  3 times its dispatches, the follower SIGKILLed and the worker restarted
  whole (the card's contexts counted), the rejoin seconds, the drain;
- fleet_mix (``--fleet-mix-only``; :func:`drive_fleet_mix`): the bench's
  mixed-size fleet phase on the serve phase's mix with 2 workers, 3
  clients x 25 requests, under the deadline and continuous batchers:
  req/s, p50 and p99 by size class, padding efficiency, 0 client errors.
  Ranks or workers sharing one card measure sharing, not scaling.

``--bwd-bf16-only`` also reads ROADMAP fault C2 against the reference's
own numbers (``tests/torch_golden/c2_bf16_bwd.npz``): the kernel, the
plain loop on the card and on the host CPU, and the order of
``torch.bmm``'s sums at that shape.

Each path runs with every launch count set to 0 just before it and read
just after, and fails unless each kernel of the path launched as often as
the path should launch it, and no other kernel did. Prints JSON lines;
the last line is ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line. Needs one CUDA card, nvcc and nvidia-smi;
imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import inspect
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
# the train_plane phase: the data plane and run controls on an in-memory
# corpus of 2048 windows at batch 128 (16 steps an epoch, 8 blocks of 256
# rows), two epochs, latest saved every 5 steps inside an epoch; run B is
# stopped by its log hook at epoch 1 step 8 and resumed (from batch 5);
# shards: one epoch of each of 2 shards at a step batch of 64
PLANE_WINDOWS = 2048
PLANE_EPOCHS = 2
PLANE_SAVE_EVERY = 5
PLANE_STOP = "epoch 1 step 8/16"
PLANE_RESUMED = "epoch 1, batch 5,"
PLANE_SHARDS = 2
# when the card's train step is not bitwise repeatable: each parameter of
# the resumed run within 1e-4 of its largest entry of the uninterrupted
# one's, epoch 1's summary train loss within 1e-5 relative
PLANE_PARAM_OF_MAX = 1e-4
PLANE_LOSS_RTOL = 1e-5
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
# the polish phase: a 500 kb sim project (its 500 694 bp draft makes 6
# regions of 100 kb), cut from a bacterial draft of about 5 Mb only to
# bound the pure-Python simulator's time; 4 extraction workers; a 20 kb
# sub-region for the native-vs-Python check
POLISH_GENOME_LEN = 500_000
POLISH_SIM_SEED = 7
POLISH_WORKERS = 4
# the fan-out timed again at these worker counts (windows counted, not
# kept): a process's first fan-out, the one a polish runs, is the timed one
POLISH_WORKER_SWEEP = (1, 2, 4, 8)
POLISH_CHECK_REGION = (200_000, 220_000)
# device-time kinds of the port's kernels: a kernel's kind is the first of
# these its name holds; "lingru_fwd_bf16" holds "lingru_fwd" and
# "gru_fwd_bf16", "lingru_fwd" holds "gru_fwd", so the longer come first
KERNEL_KINDS = ("lingru_fwd_bf16", "lingru_bwd_bf16", "lingru_fwd", "lingru_bwd",
                "gru_fwd_bf16", "gru_bwd_bf16", "gru_fwd", "gru_bwd")
# the precision phase: bf16 kernel vs its plain bf16 loop (both round every
# h to bf16 after f32 sums in another order, so a rounding may land one
# bf16 ulp apart and carry on), at the inference rungs
BF16_ATOL = 1e-2
BF16_GRU_BATCHES = (32, 128, 512)
# gru_fwd_bf16 forced to every rows a block on the first rows of its
# inputs: a batch that no rows a block divides
BF16_RAGGED_B = 37
BF16_LIN_BATCHES = (128, 512)
# the bf16 backward kernels vs their plain bf16 loops, at the train shape
# and a ragged one. dxp and dp: each within one bf16 ulp of the larger of
# the two values, plus 1e-4 of the largest entry (the f32 kernels' bar
# against their loops). gru_bwd_bf16 rounds dhp to bf16 as the operand
# that feeds the carry dh: where the f32 dhp of kernel and loop, summed in
# other orders, straddle a rounding, the operands differ by an ulp, and dh
# and every later step's dxp move a little; an entry that is a small
# difference (h_prev - n) moves by many of its own ulps. dW_hh and db_hh,
# f32 sums of those operands: within half a bf16 ulp (2e-3) of their
# largest entry.
BF16_BWD_OF_MAX = 1e-4
BF16_DW_OF_MAX = 2e-3
BF16_GRU_BWD_SHAPES = (TRAIN_SHAPE, dict(B=13, T=7, IN=256, H=128, S=1))
# --bwd-bf16-only also times gru_bwd_bf16 at the inference batch (8 rows a
# block, the widest mma tile). gru_bwd_bf16 at the train shape: the
# precision phase holds it to the bar on the inputs of the card test
# test_bf16_gru_bwd_kernel_matches_plain[128-90-128-2] as well (its seed),
# and reads on how many further seeded inputs its dxp lies beyond the bar:
# --bwd-bf16-only on this many, gated by C1's rule, the full run (read, not
# gated) on the first of them, since the plain bf16 loop, one product at a
# time, takes about half a second a seed on the card
BF16_GRU_BWD_WIDE_SHAPE = dict(TRAIN_SHAPE, B=512)
BF16_GRU_BWD_CARD_TEST_SEED = 3 * TRAIN_SHAPE["B"] + TRAIN_SHAPE["H"]
BF16_GRU_BWD_SEEDS = 100
BF16_GRU_BWD_SEEDS_READ = 20
# the bench phase: python -m roko_tpu_torch bench --train at this pinned
# iteration count; beside it, the kernels at the shapes its suites give them
# that no earlier phase launches, each held against its plain version: the
# inference sweep's widest batch, the stress train row (4 layers, hidden
# 256: the f32 streaming recurrences) at the train suite's batch, ...
#: windows of the transformer's f32 logits held against the same model on
#: the host CPU, and the bars
TRANSFORMER_CPU_WINDOWS = 64
TRANSFORMER_CPU_ATOL = 1e-5
TRANSFORMER_ARGMAX_GAP = 1e-4
BENCH_ITERS = 10

# the mesh phase, data parallelism across processes: ranks of one run share
# the card through gloo (NCCL refuses two ranks on one card; the NCCL group
# runs at world size 1). Training: gru f32 at full width, global batch
# TRAIN_BATCH, one epoch over MESH_TRAIN_WINDOWS windows cut into blocks of
# MESH_BLOCK rows, so that each rank's shard holds half of them (20 steps,
# 20 eval batches); inference: MESH_CONTIGS contigs of MESH_CONTIG_WINDOWS
# windows split by contig; the bench's mesh suite at MESH_DEVICES ranks
MESH_RANKS = 2
MESH_TRAIN_WINDOWS = 2560
#: all-reduces of the step's flat buffer timed alone in each rank
MESH_ALLREDUCE_REPS = 20
MESH_BLOCK = 64
MESH_CONTIGS = 4
#: the draft's order of the mesh contigs, not sorted by name: one rank
#: writes this order, several write the names sorted, as the reference does
MESH_CONTIG_ORDER = (2, 0, 3, 1)
MESH_CONTIG_WINDOWS = 256
# (the 4-rank group, ~30 s of process starts, was cut to keep the whole
# script well inside its time limit; the CPU tests hold 4-rank sessions)
MESH_DEVICES = "1,2"
#: a child rank that outlasts this fails the phase (every wait is bounded)
MESH_CHILD_TIMEOUT_S = 300
# the tp_sp phase, tensor and sequence parallelism of the transformer at
# full width (3 layers, d_model 256, 8 heads, mlp 1024): gloo ranks sharing
# the card, as the mesh phase's. Ring attention alone at T=90 and B=128 on
# sp = 2 and 3 ranks against dense attention; one train step (batch 128,
# dropout 0.2) and 3 Adam steps on each layout against one rank's step at
# the global batch; the mesh contigs' inference at tp=2 and sp=2.
TP_SP_LAYOUTS = {"tp2": dict(dp=1, tp=2), "sp2": dict(dp=1, sp=2),
                 "dp2tp2": dict(dp=2, tp=2)}
#: the launches of the phase: (ranks, the ring's sp, layouts); the ring
#: runs on the first sp ranks (at sp 3 of 4, on a group of its own, so that
#: the phase launches ranks twice, not three times)
TP_SP_RUNS = {"tp_pair": (2, 2, ("tp2", "sp2")), "tp_quad": (4, 3, ("dp2tp2",))}
TP_SP_INFER_LAYOUTS = ("tp2", "sp2")
TP_SP_DROPOUT = 0.2
TP_SP_ADAM_STEPS = 3
TP_SP_LR = 1e-3
TP_SP_TIMED_STEPS = 5
TP_SP_ROTATIONS = 20
#: ring attention against dense attention, f32: the reference's bars
#: (tests/test_ring.py), forward and q/k/v gradients
RING_FWD_TOL, RING_GRAD_TOL = 2e-5, 3e-5
# the serve phase: the bench's mixed schedule (``benchmark.SERVE_MIX_DEFAULT_TPU``,
# its request and client counts), the subprocess's request sizes (7, and
# two above the 128 and 512 rungs), the drained request's windows, the
# /profilez window, the lingru session's requests, and the subprocess's
# start bound
SERVE_MIX = "4:90,256:10"
SERVE_REQUESTS = 48
SERVE_CLIENTS = 6
SERVE_SIZES = (7, 300, 700)
SERVE_DRAIN_WINDOWS = 700
SERVE_PROFILE_S = 1.0
SERVE_LINGRU_REQUESTS = 12
SERVE_START_TIMEOUT_S = 300
# the mesh_serve phase: two gloo ranks sharing the card, its stream's batch
MESH_SERVE_RANKS = 2
MESH_SERVE_BATCH = 512
# the coldstart phase's ladder (the serve default) and the fleet phase's
# request sizes, closed-loop clients and load seconds, rollout bake, and
# the bound on a fleet's start, a worker's rejoin and a rollout
COLDSTART_LADDER = (32, 128, 512)
FLEET_SIZES = (7, 300, 700)
FLEET_CLIENTS = 3
FLEET_LOAD_S = 4.0
FLEET_BAKE_S = 2
FLEET_TIMEOUT_S = 300
# the fleet_mesh phase (--fleet-mesh-only): one worker whose session is
# this many gloo ranks sharing the card (shared cards, mesh dp 2)
FLEET_MESH_RANKS = 2
# the fleet_mix phase (--fleet-mix-only): the bench's mixed-size fleet
# phase with this many workers on the serve phase's mix
FLEET_MIX_WORKERS = 2
# the cascade phase: the working threshold, the odd subset sizes held
# against the full batch, the bench's draft, the project of --cascade-only
CASCADE_THRESHOLD = 0.05
CASCADE_SUBSETS = (37, 301)
CASCADE_BENCH_DRAFT = 40_000
# the on-disk cache writes and reads a file a window: its cold and warm
# runs take the first 5 batches (2 560 windows), not all of them
CASCADE_CACHE_BATCHES = 5
SMALL_PROJECT_LEN = 100_000
# the distributed polish: span units of one 100 kb region each; the 100 kb
# project of --distpolish-only is cut into 40 kb regions for span units
DIST_UNIT_BASES = 150_000
DIST_CLI_REGION = 40_000
DIST_CLI_UNIT_BASES = 50_000
# the federation phase (--federation-only): two host agents of one worker
# each behind a front whose relays drop, delay and duplicate at the chaos
# gate's rates; closed-loop clients of 7- and 300-window requests; the
# store polish under the storage gate's rates
FED_SIZES = (7, 300)
FED_CLIENTS = 3
FED_LOAD_S = 3.0
FED_KILL_LOAD_S = 3.0
FED_LEASE_TTL_S = 2.0
FED_FAULTS = "drop:0.1,delay:0.2,duplicate:0.1"
FED_DELAY_S = "0.02"
STORE_FAULTS = "timeout:0.1,http500:0.05,truncate:0.02,torn_write:0.02"
BENCH_WIDE_B = 2048
# the quality phase: roko_tpu_torch/examples/synthetic_e2e.py's recipe on
# the card, in each error regime. The draft's error rate must print the
# reference example's row of BASELINE.md to its digits (the simulator and
# assess are exact); the polish must be under a third of it (the bar of
# tests/test_end_to_end.py)
QUALITY_REGIMES = ("uniform", "homopolymer")
QUALITY_DRAFT_PCT = {"uniform": "1.2083", "homopolymer": "4.2167"}
QUALITY_REDUCTION = 3
#: the reference example's polished rows in BASELINE.md (JAX on a CPU),
#: printed beside the port's only for reference: torch draws other dropout
#: masks, so no identity is claimed
QUALITY_JAX_ROWS = {"uniform": {"error_pct": 0.0167, "q": 37.78},
                    "homopolymer": {"error_pct": 0.0833, "q": 30.79}}
BENCH_STRESS_SHAPE = dict(B=512, T=90, IN=500, H=256, S=2)
# ... and the train_gru row's first layer (the resident f32 backward)
BENCH_TRAIN_SHAPE = dict(TRAIN_SHAPE, B=512)
BF16_LIN_BWD_SHAPES = (LIN_TRAIN_SHAPE, dict(B=11, T=40, H=12))
# a full-width bf16 train step through the kernels vs the plain bf16
# recurrences: the loss at the f32 check's bar, each gradient within 1e-2
# of its largest entry. The f32 bar (1e-4) does not hold in bf16: every
# gradient is rounded to bf16 once (2^-8 relative), f32 sums in another
# order may straddle that rounding, and a dxp that lands one ulp apart in
# one layer carries into the layers below
BF16_STEP_ATOL_OF_MAX = 1e-2


#: (the line's first key, seconds since the script started) of each line
TIMELINE: list = []
_T0 = time.perf_counter()


def emit(obj) -> None:
    TIMELINE.append((next(iter(obj)), round(time.perf_counter() - _T0, 1)))
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@functools.lru_cache(maxsize=1)
def _package_benchmark():
    """``roko_tpu_torch/benchmark.py`` beside this script, loaded by its
    path, so that a ``--*-only ROOT`` run keeps ROOT's package as
    ``roko_tpu_torch``."""
    path = os.path.join(ROOT, "roko_tpu_torch", "benchmark.py")
    if not os.path.isfile(path):
        fail(f"no roko_tpu_torch/benchmark.py beside this script ({path})")
    spec = importlib.util.spec_from_file_location("chip_smoke_package_benchmark", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_peaks(name: str, ops: str = "f32"):
    """(FLOP/s, memory bytes/s) from NVIDIA's H100 data sheet, the
    package's ``benchmark.card_peaks``."""
    return _package_benchmark().card_peaks(name, ops)


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


def jax_layout_dense(rng, i: int, o: int):
    b = 1.0 / math.sqrt(i)
    return {"kernel": uniform(rng, b, (i, o)), "bias": uniform(rng, b, (o,))}


def jax_layout_encoder(rng, cfg):
    """The transformer's ``params["encoder"]`` as ``transformer_init``
    draws it: dense layers U(+-1/sqrt(in)), ``pos_embed`` 0.02 N(0, 1),
    layer norms scale 1 and bias 0."""
    d, m = cfg.d_model, cfg.mlp_ratio * cfg.d_model

    def norm():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def layer():
        qkvp = {name: jax_layout_dense(rng, d, d) for name in ("q", "k", "v", "proj")}
        return {"ln1": norm(), **qkvp, "ln2": norm(), "mlp_in": jax_layout_dense(rng, d, m),
                "mlp_out": jax_layout_dense(rng, m, d)}

    return {
        "in_proj": jax_layout_dense(rng, cfg.gru_in_size, d),
        "pos_embed": (0.02 * rng.standard_normal((cfg.window_cols, d))).astype(np.float32),
        "layers": tuple(layer() for _ in range(cfg.num_layers)),
        "ln_out": norm(),
    }


def jax_layout_params(rng, cfg):
    """Random params of ``cfg.kind`` in the JAX package's tree layout."""
    params = {
        "embedding": rng.standard_normal((cfg.embed_vocab, cfg.embed_dim)).astype(np.float32),
        "fc1": jax_layout_dense(rng, cfg.window_rows, cfg.read_mlp[0]),
        "fc2": jax_layout_dense(rng, cfg.read_mlp[0], cfg.read_mlp[1]),
        "head": jax_layout_dense(rng, 2 * cfg.hidden_size, cfg.num_classes),
    }
    if cfg.kind == "transformer":
        params["encoder"] = jax_layout_encoder(rng, cfg)
        return params
    layer = jax_layout_gru_layer if cfg.kind == "gru" else jax_layout_lingru_layer
    params[cfg.kind] = tuple(
        layer(rng, cfg.gru_in_size if k == 0 else 2 * cfg.hidden_size, cfg.hidden_size)
        for k in range(cfg.num_layers)
    )
    return params


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


def bound(torch, flops: float, nbytes: float, ops: str = "f32") -> dict:
    peak_flops, peak_bw = card_peaks(torch.cuda.get_device_name(0), ops)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return dict(flop=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes", ops_peak=ops)


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
    (``(key, substring of the kernel name)``, each one kernel a call):
    ``device_breakdown`` of ``iters`` calls after one warm-up, each part's
    kernel time summed and divided by the number of its kernels in the
    trace (a trace may miss the first calls' kernels), with that number
    and the kernels' names; a part with no kernel traced is left out."""
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
        n_traced = sum(n for _, n in hits.values())
        split["kernels_traced"][key] = n_traced
        if n_traced:
            split[key] = sum(ms for ms, _ in hits.values()) / n_traced
        split["kernel_names"][key] = sorted(
            re.search(r"\w*gru_(fwd|bwd)\w*(<[\d, ]+>)?", n).group(0) for n in hits)
    return split


# gru_bwd's three kernels and gru_fwd's one, by a substring of their names
BWD_PARTS = (("recurrence", "gru_bwd_rec"), ("dw", "gru_bwd_dw"), ("reduce", "gru_bwd_reduce"))
FWD_PARTS = (("recurrence", "gru_fwd"),)


def launch_plan(torch, fg, kernel: str, shape, dev, dtype=None) -> dict:
    """How gru_``kernel`` (``"fwd"`` or ``"bwd"``) launches at ``shape``
    on this card (``fg.fwd_plan``, ``fg.bwd_plan``), for ``dtype`` where the
    plan takes one; empty for a tree whose kernel has no plan (one variant,
    8 rows)."""
    plan_of = getattr(fg, f"{kernel}_plan", None)
    if plan_of is None:
        return {}
    B, T, H, S = (shape[k] for k in ("B", "T", "H", "S"))
    by_dtype = {} if dtype is None or "dtype" not in inspect.signature(plan_of).parameters else {
        "dtype": dtype}
    plan = plan_of(B, T, H, S, torch.cuda.get_device_properties(dev).multi_processor_count,
                   **by_dtype)
    return {"variant": plan["variant"], "rows_per_block": plan["rows"],
            "blocks": plan["blocks"], "threads_per_block": plan["threads"],
            "smem_bytes_per_block": plan["smem_bytes"],
            **({"dw_plan": plan["dw"]} if "dw" in plan else {})}


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


def bf16_scan_plans(fl) -> bool:
    """Whether the tree's bf16 lingru scans have a plan (staged or
    streaming); before, their one design launched as the f32 streaming
    variant does."""
    return "dtype" in inspect.signature(fl.scan_plan).parameters


def lingru_plan(torch, fl, kernel: str, shape, dev, dtype=None) -> dict:
    """How lingru_``kernel`` (``"fwd"`` or ``"bwd"``; its bf16 kernel for
    ``dtype`` bfloat16) launches at ``shape`` on this card
    (``fl.scan_plan``); empty for a tree whose kernel has no plan (one
    streaming variant)."""
    if kernel not in getattr(fl, "SCAN_DEFAULT", {}):
        return {}
    B, T, H = (shape[k] for k in ("B", "T", "H"))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if dtype is None:
        plan = fl.scan_plan(B, T, H, n_sm, kernel)
    elif bf16_scan_plans(fl):
        plan = fl.scan_plan(B, T, H, n_sm, kernel, dtype=dtype)
    else:
        plan = fl.scan_plan(B, T, H, n_sm, kernel, variant="streaming")
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


def lingru_bf16_plans(torch, fl, kernel: str, args, got, row, shape, *, sweep: bool) -> dict:
    """For a staged bf16 scan: ``lingru_{kernel}_bf16`` bitwise equal to
    ``got`` at every (steps, stages) of the bf16 ``fl.scan_choices`` and
    as its streaming variant; with ``sweep``, the device time of each of
    those launches. Empty where the tree's bf16 scans have no plan or
    ``row`` streams."""
    if row.get("variant") != "staged" or not bf16_scan_plans(fl):
        return {}
    forced = getattr(fl, f"_lingru_{kernel}_bf16_kernel")
    plans = fl.scan_choices(kernel, shape["H"], torch.bfloat16)
    for n, m in plans:
        if not torch.equal(got, forced(*args, steps=n, stages=m)):
            fail(f"lingru_{kernel}_bf16 at {n} steps x {m} stages differs from "
                 f"{row['steps_per_stage']} x {row['stages']} at {shape}")
    if not torch.equal(got, forced(*args, variant="streaming")):
        fail(f"lingru_{kernel}_bf16's staged and streaming variants differ at {shape}")
    out = {"bitwise_equal_across_plans": plans, "bitwise_equal_to_streaming": True}
    if sweep:
        parts = (("scan", f"lingru_{kernel}_bf16"),)
        out["ms_by_plan"] = {f"{n}x{m}": kernel_split(
            torch, lambda: forced(*args, steps=n, stages=m), 20, parts).get("scan")
            for n, m in plans}
        out["ms_streaming"] = kernel_split(
            torch, lambda: forced(*args, variant="streaming"), 20, parts).get("scan")
    return out


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
    spans, by_name, by_kind, port = [], {}, {}, {}
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
            if kind is not None:
                total, n = port.get(key, (0.0, 0))
                port[key] = (total + ms, n + 1)
            else:
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
        "port_kernels_ms_calls": {name: [ms, n] for name, (ms, n) in port.items()},
    }


def ran_staged(what: str, breakdown: dict, kinds) -> None:
    """Fails unless the traced ``breakdown`` holds a kernel of each of
    ``kinds`` and every one of them is a staged one."""
    names = breakdown.get("port_kernels_ms_calls", {})
    for kind in kinds:
        ran = [n for n in names if next((k for k in KERNEL_KINDS if k in n.lower()), None) == kind]
        if not ran or not all("staged" in n for n in ran):
            fail(f"{what}: {kind} ran {ran or 'no kernel in the trace'}, not the staged kernel")


def ran_bwd_bf16_mma(what: str, breakdown: dict) -> dict:
    """Fails unless the traced ``breakdown`` holds gru_bwd_bf16 and every
    launch of it ran the resident mma recurrence and the tensor-core
    weight-gradient pass (``gru_bwd_bf16_dw_mma``): one of each a launch,
    and no other recurrence or weight-gradient pass."""
    names = breakdown.get("port_kernels_ms_calls", {})
    calls = {part: {n: c for n, (_, c) in names.items() if f"gru_bwd_bf16_{part}" in n}
             for part in ("rec", "dw")}
    mma = sum(c for n, c in calls["rec"].items() if "gru_bwd_bf16_rec_resident_mma" in n)
    dw_mma = sum(c for n, c in calls["dw"].items() if "gru_bwd_bf16_dw_mma" in n)
    if not mma or mma != sum(calls["rec"].values()) or dw_mma != sum(
            calls["dw"].values()) or mma != dw_mma:
        fail(f"{what}: gru_bwd_bf16 ran the recurrences {calls['rec'] or 'none in the trace'} "
             f"and the weight-gradient passes {calls['dw'] or 'none in the trace'}, not the "
             "resident mma recurrence and the tensor-core pass, one of each a launch")
    return {"gru_bwd_bf16_rec_resident_mma_calls": mma, "gru_bwd_bf16_dw_mma_calls": dw_mma}


def step_parity(torch, port, dev, ds, cfg, kernel, plain, rtol=STEP_RTOL,
                atol_of_max=STEP_ATOL_OF_MAX):
    """One full-width train step of ``cfg`` (dropout off) through the
    kernels (``kernel``) and through the plain recurrence (``plain``):
    loss (at the f32 bar) and every gradient (at ``rtol`` and
    ``atol_of_max`` of its largest entry)."""
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
        if g.dtype != torch.float32 or not torch.allclose(g, ref, rtol=rtol,
                                                          atol=atol_of_max * scale):
            fail(f"{cfg.kind} {cfg.compute_dtype} train step gradient {name} ({g.dtype}): "
                 f"max |d| {d} against max |g| {scale}")
    top = max(worst, key=lambda n: worst[n][0] / max(worst[n][1], 1e-30))
    return {"compute_dtype": cfg.compute_dtype, "loss_kernels": loss_k, "loss_plain": loss_p,
            "params": len(got),
            "worst_relative": {"param": top, "max_abs_err": worst[top][0],
                               "max_abs_grad": worst[top][1]},
            "max_abs_err": max(v[0] for v in worst.values()),
            "rtol": rtol, "atol_of_max_grad": atol_of_max, "batch": TRAIN_BATCH}


class Counts:
    """The launch counts of the port's kernels, by kernel name: each
    kernel's (wrapper, attribute its wrapper counts on)."""

    def __init__(self, fg, fl):
        self.wrappers = {
            "gru_fwd": (fg.gru_recurrence, "launches"),
            "gru_bwd": (fg.gru_recurrence_backward, "launches"),
            "lingru_fwd": (fl.lingru_scan, "launches"),
            "lingru_bwd": (fl.lingru_scan_backward, "launches"),
            "gru_fwd_bf16": (fg.gru_recurrence, "launches_bf16"),
            "lingru_fwd_bf16": (fl.lingru_scan, "launches_bf16"),
            "gru_bwd_bf16": (fg.gru_recurrence_backward, "launches_bf16"),
            "lingru_bwd_bf16": (fl.lingru_scan_backward, "launches_bf16"),
        }

    def zero(self) -> None:
        for wrapper, attr in self.wrappers.values():
            setattr(wrapper, attr, 0)

    def expect(self, what: str, want: dict) -> dict:
        """The counts; fails unless they are ``want``, and 0 for every
        kernel ``want`` does not name."""
        got = {name: getattr(w, attr) for name, (w, attr) in self.wrappers.items()}
        want = {name: want.get(name, 0) for name in got}
        if got != want:
            fail(f"{what}: kernel launches {got}, expected {want}")
        return got


def drive_inference(torch, port, model, plain, batches, contig, draft, dev, counts, fwd):
    """Polish the synthetic contig with ``model`` through ``run_inference``,
    counted: ``fwd`` launches once per layer and batch, no other kernel
    does. Then the same batches' logits through the kernels against the
    plain recurrence ``plain`` (None: a bf16 model, whose kernel the
    caller holds against its plain loop at these batch sizes), and the
    stitch against both. Returns the record and the polished contig."""
    cfg = model.cfg
    port.predict(model, batches[0][2], dev)  # warm-up: library handles, allocator; int8 quantizes
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
            if lk.shape != (len(x), cfg.window_cols, cfg.num_classes):
                fail(f"logits shape {tuple(lk.shape)}")
            if not bool(torch.isfinite(lk).all()):
                fail(f"non-finite logits on the {cfg.kind} inference path")
            kernel_board.add(names, pos, lk.argmax(-1).cpu().numpy())
            if plain is None:
                continue
            lp = model(xt, plain)
            logit_err = max(logit_err, (lk - lp).abs().max().item())
            if not torch.allclose(lk, lp, atol=ATOL, rtol=RTOL):
                fail(f"{cfg.kind} logits of kernel and plain recurrence differ: "
                     f"max |d| {logit_err}")
            top2 = lp.topk(2, dim=-1).values
            close = (top2[..., 0] - top2[..., 1]) < ATOL
            differ = lk.argmax(-1) != lp.argmax(-1)
            near_ties += int(close.sum())
            mismatches += int((differ & ~close).sum())
            plain_board.add(names, pos, lp.argmax(-1).cpu().numpy())
    if mismatches:
        fail(f"{cfg.kind}: {mismatches} argmax differences away from near-ties")
    if kernel_board.stitch(contig) != polished[contig]:
        fail(f"{cfg.kind}: run_inference's stitch differs from the kernel logits' stitch")
    plain_same = None if plain is None else plain_board.stitch(contig) == polished[contig]
    if plain_same is False and near_ties == 0:
        fail(f"{cfg.kind}: the plain recurrence's stitch differs with no near-ties")
    if not polished[contig] or set(polished[contig]) - set("ACGT"):
        fail(f"{cfg.kind}: the polished contig is empty or holds letters other than ACGT")

    n_windows = sum(len(b[0]) for b in batches)
    record = {
        "config": f"ModelConfig(kind={cfg.kind!r}) ({cfg.num_layers} layers, hidden "
                  f"{cfg.hidden_size}, full width)",
        "batches": len(batches), "batch_size": len(batches[0][0]), "windows": n_windows,
        "draft_len": len(draft), "polished_len": len(polished[contig]),
        "seconds": seconds, "windows_per_s": n_windows / seconds,
        "bases_per_s": n_windows * port.C.WINDOW_STRIDE / seconds,
        f"{fwd}_launches": launches[fwd], "peak_device_bytes": peak_bytes,
        **({"logits_max_abs_err_vs_plain": logit_err, "near_ties": near_ties,
            "plain_stitch_identical": plain_same} if plain is not None else {}),
        "log": logs,
    }
    return record, polished[contig]


def drive_polish(torch, port, model, dev, counts, card):
    """The draft-to-FASTA path: a simulated project, the native extractor
    built and held bitwise against the Python one, the region fan-out,
    and the windows through ``drive_inference`` in batches of 512
    (``gru_fwd`` launches 3 times a batch). With h5py, also the CLI's
    ``polish --staged`` in a subprocess."""
    work = os.path.join(ROOT, "build", "chip_smoke_polish")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    paths = port.build_synthetic_project(work, genome_len=POLISH_GENOME_LEN,
                                         seed=POLISH_SIM_SEED)
    sim_s = time.perf_counter() - t0
    contig = paths["contig"]
    draft = port.read_fasta(paths["draft_fasta"])[0][1]

    # the toolchain first, then the build: a failure prints g++'s stderr
    toolchain = port.native_build.toolchain()
    print(json.dumps({"polish_toolchain": toolchain}), flush=True)
    t0 = time.perf_counter()
    try:
        library = str(port.native_build.build())
        port.native_binding.load()
    except Exception as e:  # the build's or the loader's message is the finding
        fail(f"the native extractor did not build or load: {e}")
    build_s = time.perf_counter() - t0
    if port.backend.selected() != "native":
        fail("the region jobs would not run the native extractor")

    # the native extractor against the Python one on a sub-region
    start, end = POLISH_CHECK_REGION
    seed = port.derive_region_seed(0, contig, start)
    t0 = time.perf_counter()
    n_pos, n_mat = port.native_binding.extract_windows_arrays(paths["reads_bam"], contig, start,
                                                              end, seed)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with port.BamReader(paths["reads_bam"]) as reader:
        py = list(port.extract_windows(reader, contig, start, end, seed))
    python_s = time.perf_counter() - t0
    if not (len(py) == len(n_pos) > 0
            and np.array_equal(np.stack([w.positions for w in py]), n_pos)
            and np.array_equal(np.stack([w.matrix for w in py]), n_mat)):
        fail(f"the native and Python extractors differ on {contig}:{start}-{end}")

    # the fan-out, then the windows in batches of 512
    logs = []
    t0 = time.perf_counter()
    with port.open_region_stream(paths["draft_fasta"], paths["reads_bam"],
                                 workers=POLISH_WORKERS, seed=0, log=logs.append) as stream:
        jobs = len(stream.jobs)
        blocks = [r for r in stream.results if r is not None]
    extract_s = time.perf_counter() - t0
    sweep = {}
    for workers in POLISH_WORKER_SWEEP:
        t0 = time.perf_counter()
        with port.open_region_stream(paths["draft_fasta"], paths["reads_bam"], workers=workers,
                                     seed=0, log=lambda s: None) as stream:
            n = sum(len(r[1]) for r in stream.results if r is not None)
        sweep[workers] = n / (time.perf_counter() - t0)
    positions = np.concatenate([b[1] for b in blocks])
    examples = np.concatenate([b[2] for b in blocks])
    n_windows = len(positions)
    batches = [([contig] * len(positions[i : i + PATH_BATCH_SIZE]),
                positions[i : i + PATH_BATCH_SIZE], examples[i : i + PATH_BATCH_SIZE])
               for i in range(0, n_windows, PATH_BATCH_SIZE)]
    path, _ = drive_inference(torch, port, model, port.gru_recurrence_plain, batches, contig,
                              draft, dev, counts, "gru_fwd")
    for _ in range(3):  # a trace now and then holds no device events: trace again
        traced = device_breakdown(torch, lambda: port.run_inference(
            iter(batches), {contig: draft}, model, device=dev, log=lambda s: None))
        if "device_busy_ms" in traced:
            break
    else:
        fail(f"the polish phase's inference traces hold no device time: {traced}")
    busy_ms = traced["device_busy_ms"]

    cli = "not run: no h5py on this machine"
    if importlib.util.find_spec("h5py") is not None:
        polished = port.run_inference(iter(batches), {contig: draft}, model, device=dev,
                                      log=lambda s: None)[contig]
        pth, out = os.path.join(work, "model.pth"), os.path.join(work, "polished.fasta")
        torch.save(model.state_dict(), pth)
        proc = subprocess.run(
            [sys.executable, "-m", "roko_tpu_torch", "polish", paths["draft_fasta"],
             paths["reads_bam"], pth, out, "--staged", "--t", str(POLISH_WORKERS),
             "--b", str(PATH_BATCH_SIZE), "--hidden-size", str(model.cfg.hidden_size),
             "--num-layers", str(model.cfg.num_layers), "--device", dev.type],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            fail(f"polish --staged failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
        if port.read_fasta(out) != [(contig, polished)]:
            fail("polish --staged's FASTA differs from the in-memory polish's stitch")
        cli = "FASTA byte-equal to the in-memory polish"

    return {
        "project": {"genome_len": POLISH_GENOME_LEN, "seed": POLISH_SIM_SEED, "coverage": 30,
                    "read_len": 400, "draft_len": len(draft), "regions": jobs,
                    "reduced": "500 kb draft instead of a ~5 Mb bacterial one, to bound the "
                               "pure-Python simulator's time"},
        "extractor": "native", "library": os.path.relpath(library, ROOT), "toolchain": toolchain,
        "build_seconds": build_s,
        "check_region": {"region": [start, end], "windows": len(py), "bitwise_equal": True,
                         "native_seconds": native_s, "python_seconds": python_s,
                         "native_windows_per_s": len(py) / native_s,
                         "python_windows_per_s": len(py) / python_s},
        "windows": n_windows, "workers": POLISH_WORKERS, "sim_seconds": sim_s,
        "extract_seconds": extract_s, "extract_windows_per_s": n_windows / extract_s,
        "extract_windows_per_s_again_by_workers": sweep,
        "host_cpus": {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))},
        "inference_seconds": path["seconds"], "inference_windows_per_s": path["windows_per_s"],
        "phase_seconds": sim_s + extract_s + path["seconds"],
        "phase_is": "sim + extraction + inference (build and checks left out)",
        "device_busy_ms_in_inference": busy_ms,
        "busy_share_of_phase": busy_ms / 1e3 / (sim_s + extract_s + path["seconds"]),
        "busy_share_of_extraction_and_inference": busy_ms / 1e3 / (extract_s + path["seconds"]),
        "busy_from": "a traced second run of the same batches",
        "gru_fwd_launches": path["gru_fwd_launches"], "batches": path["batches"],
        "path": {k: v for k, v in path.items() if k != "log"},
        "fanout_log": logs, "cli": cli, "card": card,
        # for the stream_polish phase, not printed
        "_stream_inputs": {"paths": paths, "contig": contig, "draft": draft,
                           "batches": batches},
    }


def stream_and_compare(torch, port, model, dev, counts, polish, kernel):
    """``run_streaming_polish`` on the polish phase's project with
    ``model`` through a warm session on the card with the ladder
    32 / 128 / 512, 4 extraction workers, batch 512, counted (``kernel``
    3 times a dispatched step, nothing else; with ``kernel`` None, no
    kernel at all). Its FASTA must be byte-equal to the stitch of the
    same windows' in-memory staged inference with the same model."""
    inputs = polish["_stream_inputs"]
    paths, contig, draft = inputs["paths"], inputs["contig"], inputs["draft"]
    work = os.path.dirname(paths["draft_fasta"])
    kind = model.cfg.kind
    tag = kind if model.cfg.compute_dtype == "float32" else f"{kind}_{model.cfg.compute_dtype}"
    staged_path = os.path.join(work, f"staged_{tag}.fasta")
    staged = port.run_inference(iter(inputs["batches"]), {contig: draft}, model, device=dev,
                                log=lambda s: None)
    port.write_fasta(staged_path, list(staged.items()))

    cfg = port.RokoConfig(model=model.cfg)
    ladder = port.tail_rungs(port.resolve_ladder(cfg.serve, 1), PATH_BATCH_SIZE, 1)
    session = port.PolishSession(model, cfg, device=dev, ladder=ladder)
    t0 = time.perf_counter()
    session.warmup()
    warmup_s = time.perf_counter() - t0
    session.dispatched_shapes.clear()

    out = os.path.join(work, f"stream_{tag}.fasta")
    timer, metrics, logs = port.StageTimer(), port.ServeMetrics(), []
    counts.zero()
    t0 = time.perf_counter()
    port.run_streaming_polish(paths["draft_fasta"], paths["reads_bam"], None, cfg,
                              session=session, out_path=out, workers=POLISH_WORKERS, seed=0,
                              batch_size=PATH_BATCH_SIZE, timer=timer, metrics=metrics,
                              log=logs.append)
    seconds = time.perf_counter() - t0
    steps = metrics.counters["batches"]
    want = {kernel: model.cfg.num_layers * steps} if kernel else {}
    launches = sum(counts.expect(f"the {kind} stream_polish path", want).values())
    shapes = sorted(session.dispatched_shapes)
    if not set(shapes) <= set(ladder):
        fail(f"{kind} stream_polish dispatched {shapes}, outside the ladder {ladder}")
    with open(out, "rb") as fh, open(staged_path, "rb") as want:
        identical = fh.read() == want.read()
    if not identical:
        fail(f"the {kind} streamed FASTA differs from the staged in-memory stitch of the same "
             "windows")
    windows, padded = metrics.fill_totals()
    if windows != polish["windows"]:
        fail(f"{kind} stream_polish voted {windows} windows, the polish phase extracted "
             f"{polish['windows']}")
    return {
        "windows": windows, "padded_rows": padded, "padding_efficiency": windows / padded,
        "seconds": seconds, "windows_per_s": windows / seconds,
        "spans_s": dict(timer.totals), "span_counts": dict(timer.counts),
        "steps": steps, f"{kernel or 'kernel'}_launches": launches,
        "launches_expected": "3 x steps" if kernel else "none",
        "ladder": list(ladder), "dispatched_shapes": shapes, "warmup_seconds": warmup_s,
        "fasta_byte_equal_to_staged_stitch": identical,
        "log": logs[-12:], "_run": (session, cfg, paths),
    }


def drive_stream_polish(torch, port, model, dev, counts, card, polish, rng):
    """The default ``polish``: ``stream_and_compare`` with the gru model.
    Then ``gru_fwd`` held against the plain recurrence at every rung of
    the ladder, a traced second run for the card's busy share, and the
    assess tool on the sim draft against its truth (random weights: the
    polished contig is not scored)."""
    run = stream_and_compare(torch, port, model, dev, counts, polish, "gru_fwd")
    session, cfg, paths = run.pop("_run")
    ladder, seconds = session.ladder, run["seconds"]
    contig, draft = polish["_stream_inputs"]["contig"], polish["_stream_inputs"]["draft"]

    # gru_fwd (and lingru_fwd) at every rung of the ladder, B=32 included,
    # against the plain loops
    rungs = [check_kernel(torch, port.fg, dict(MAIN_SHAPE, B=rung), dev, rng, timed=False)
             for rung in ladder]
    lin_rungs = [check_lingru(torch, port.fl, "fwd", dict(LIN_INFER_SHAPE, B=rung), dev, rng,
                              timed=False) for rung in ladder]

    # the card's busy share, from a traced second run on the warm session
    for _ in range(3):
        traced = device_breakdown(torch, lambda: port.run_streaming_polish(
            paths["draft_fasta"], paths["reads_bam"], None, cfg, session=session,
            workers=POLISH_WORKERS, seed=0, batch_size=PATH_BATCH_SIZE, log=lambda s: None))
        if "device_busy_ms" in traced:
            break
    else:
        fail(f"the stream_polish traces hold no device time: {traced}")

    # the assess tool through the native aligner: the sim draft against its truth
    truth = {n: q.encode() for n, q in port.read_fasta(paths["truth_fasta"])}
    t0 = time.perf_counter()
    res = port.assess_fastas(truth, {contig: draft.encode()})
    assess_s = time.perf_counter() - t0
    c = res.contigs[0]
    if not port.native_binding.is_available() or c.errors == 0 or c.truth_len < POLISH_GENOME_LEN:
        fail(f"assess of the sim draft: {res.summary()}")

    # the stream's fan-out is the process's sixth, so its files are in
    # the page cache: against the polish phase's first (cold) fan-out the
    # ratio flatters the overlap; the same run's 4-worker repeat is warm
    cold_serial_s = polish["extract_seconds"] + polish["inference_seconds"]
    warm_extract_s = (polish["windows"]
                      / polish["extract_windows_per_s_again_by_workers"][POLISH_WORKERS])
    warm_serial_s = warm_extract_s + polish["inference_seconds"]
    return {
        **run,
        "gru_fwd_by_rung": [{"B": r["shape"]["B"], "max_abs_err": r["max_abs_err"],
                             "bitwise_repeatable": r["bitwise_repeatable"],
                             **{k: r[k] for k in ("variant", "rows_per_block", "blocks")
                                if k in r}} for r in rungs],
        "lingru_fwd_by_rung": [{"B": r["shape"]["B"], "max_abs_err": r["max_abs_err"],
                                **{k: r[k] for k in ("variant", "steps_per_stage", "stages")
                                   if k in r}} for r in lin_rungs],
        "atol": ATOL, "rtol": RTOL,
        "traced_run": traced, "busy_share_of_wall": traced["device_busy_ms"] / traced["wall_ms"],
        "busy_from": "a traced second run on the warm session",
        "serial_cold_extract_plus_inference_s": cold_serial_s,
        "serial_warm_extract_plus_inference_s": warm_serial_s,
        "stream_over_cold_serial": seconds / cold_serial_s,
        "stream_over_warm_serial": seconds / warm_serial_s,
        "serial_from": "inference: the polish phase's; cold extraction: its first 4-worker "
                       "fan-out; warm extraction: the same run's 4-worker repeat. The stream's "
                       "fan-out is warm, so stream_over_warm_serial is the like-for-like ratio",
        "assess_draft_vs_truth": {
            "seconds": assess_s, "aligner": "native", "match": c.match, "sub": c.sub,
            "ins": c.ins, "dele": c.dele, "anchors": c.anchors,
            "band_capped_segments": c.band_capped_segments, "summary": res.summary()},
        "card": card,
    }


def check_bf16_kernel(torch, fg, fl, kind: str, B: int, dev, rng, *, timed: bool,
                      sweep: bool = False) -> dict:
    """``gru_fwd_bf16`` (``kind`` "gru": T=90, H=128, both directions) or
    ``lingru_fwd_bf16`` ("lingru": T=90, H=128) at batch ``B`` against its
    plain bf16 loop on the same bf16 inputs: max |d|, the share of outputs
    bit-equal to the plain loop's, two launches bitwise equal, the launch
    plan that ran, for gru the kernel bitwise equal at every rows a block
    on the first BF16_RAGGED_B rows, and for a staged lingru scan the
    kernel bitwise equal at every bf16 (steps, stages) and to its
    streaming variant; fails above BF16_ATOL. With ``timed``, the bf16
    kernel's time beside the f32 kernel's on the same inputs before their
    rounding to bf16 (CUDA events, and for the scans device time from a
    trace, as their f32 rows take it), the plain loop's, cuDNN's bf16 GRU
    forward (gru) and the bound; with ``sweep`` (lingru), the device time
    of every (steps, stages) and of the streaming variant."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if kind == "gru":
        shape = dict(MAIN_SHAPE, B=B)
        x, t, xp, w_hh, b_hh = layer_inputs(torch, shape, dev, rng)
        args32, run, plain = (xp, w_hh, b_hh), fg.gru_recurrence, fg.gru_recurrence_plain
        plan = fg.fwd_plan(B, shape["T"], shape["H"], shape["S"], n_sm, dtype=torch.bfloat16)
        plan = {"variant": plan["variant"], "rows_per_block": plan["rows"],
                "blocks": plan["blocks"], "threads_per_block": plan["threads"],
                "smem_bytes_per_block": plan["smem_bytes"]}
    else:
        shape = dict(LIN_INFER_SHAPE, B=B)
        args32, run, plain = (lingru_inputs(torch, "fwd", fl, shape, dev, rng), fl.lingru_scan,
                              fl.lingru_scan_plain)
        plan = lingru_plan(torch, fl, "fwd", shape, dev, torch.bfloat16)
    args = tuple(a.to(torch.bfloat16) for a in args32)
    got = run(*args)
    want = plain(*args)
    again = run(*args)
    torch.cuda.synchronize()
    name = f"{kind}_fwd_bf16"
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype != torch.bfloat16 or not err <= BF16_ATOL:
        fail(f"{name} disagrees with its plain bf16 loop at {shape}: max |d| {err}, "
             f"dtype {got.dtype}")
    if not torch.equal(got, again):
        fail(f"{name} differs between two launches at {shape}")
    row = {"shape": shape, "max_abs_err": err, "atol": BF16_ATOL,
           "bit_equal_share": (got == want).float().mean().item(), "bitwise_repeatable": True,
           **plan}
    if kind == "gru":
        ragged = tuple(a[:BF16_RAGGED_B].contiguous() if i == 0 else a
                       for i, a in enumerate(args))
        first = fg._gru_fwd_kernel(*ragged, rows=fg.RESIDENT_ROWS[0])
        for rows in fg.RESIDENT_ROWS[1:]:
            if not torch.equal(fg._gru_fwd_kernel(*ragged, rows=rows), first):
                fail(f"{name} at {rows} rows a block differs from {fg.RESIDENT_ROWS[0]} row "
                     f"at B={BF16_RAGGED_B}")
        row["bitwise_equal_across_rows"] = {"B": BF16_RAGGED_B, "rows": list(fg.RESIDENT_ROWS)}
    else:
        row.update(lingru_bf16_plans(torch, fl, "fwd", args, got, row, shape,
                                     sweep=timed and sweep))
    if not timed:
        return row
    row["output_sha256"] = hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    row["ms_events"] = cuda_ms(torch, lambda: run(*args), iters=20)
    row["f32_ms_events"] = cuda_ms(torch, lambda: run(*args32), iters=20)
    if kind == "gru":
        row["ms"], row["f32_ms"], row["ms_from"] = row["ms_events"], row["f32_ms_events"], "events"
        row["ms_by_kernel"] = kernel_split(torch, lambda: run(*args), 20,
                                           (("recurrence", "gru_fwd_bf16"),))
        ref = cudnn_gru(torch, t, shape["IN"], shape["H"], shape["S"], dev).to(torch.bfloat16)
        ref.flatten_parameters()  # else cuDNN compacts the weights every call
        xb = x.to(torch.bfloat16)
        row["library_note"] = ("cuDNN nn.GRU forward in bf16, one bidirectional layer; "
                               "includes the input GEMM")
        try:  # a yardstick only: a PyTorch without a bf16 GRU leaves it out
            with torch.no_grad():
                row["library_max_abs_err"] = (ref(xb)[0].float() - got.float()).abs().max().item()
                row["library_ms"] = cuda_ms(torch, lambda: ref(xb), iters=20)
        except RuntimeError as e:
            row["library_ms"], row["library_note"] = None, f"no bf16 nn.GRU here: {e}"
        flops = 2.0 * shape["T"] * shape["S"] * B * shape["H"] * 3 * shape["H"]
        row.update(bound(torch, flops, 2.0 * (sum(a.numel() for a in args) + got.numel()),
                         "bf16"))
    else:
        # the scans' own time is their device time in a trace, as in the f32 rows
        split = kernel_split(torch, lambda: run(*args), 20, (("scan", "lingru_fwd_bf16"),))
        split32 = kernel_split(torch, lambda: run(*args32), 20, (("scan", "lingru_fwd"),))
        row["ms_by_kernel"], row["f32_ms_by_kernel"] = split, split32
        row["ms"] = split.get("scan", row["ms_events"])
        row["f32_ms"] = split32.get("scan", row["f32_ms_events"])
        row["ms_from"] = "trace" if "scan" in split and "scan" in split32 else "events"
        row["library_ms"], row["library_note"] = None, LIN_NO_LIBRARY
        row.update(bound(torch, LIN_FWD_OPS * B * shape["T"] * 2 * shape["H"],
                         2.0 * (args[0].numel() + got.numel())))
    row["plain_ms"] = cuda_ms(torch, lambda: plain(*args), iters=3, warmup=1)
    return row


def bf16_ulps(torch, got, want):
    """Against one bf16 ulp of the larger of each pair of values: (the
    largest |got - want| in such ulps, the largest excess over one as a
    share of want's largest entry, the share of entries within one)."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    d = (g - w).abs()
    excess = (d - ulp).clamp_min(0) / w.abs().max().clamp_min(1e-30)
    return (d / ulp).max().item(), excess.max().item(), (d <= ulp).float().mean().item()


def check_bf16_bwd_kernel(torch, fg, fl, kind: str, shape, dev, rng, *, timed: bool,
                          sweep: bool = False) -> dict:
    """``gru_bwd_bf16`` (``kind`` "gru") or ``lingru_bwd_bf16`` ("lingru")
    at ``shape`` against its plain bf16 loop on the same bf16 inputs (the
    f32 inputs of the f32 kernel's check, rounded): dxp or dp within one
    bf16 ulp plus BF16_BWD_OF_MAX of the largest entry, dW_hh and db_hh
    within BF16_DW_OF_MAX of theirs, the share of dxp or dp bit-equal to
    the plain loop's and within one ulp, two launches bitwise equal, the
    launch plan that ran, (gru, resident) bitwise equal at every rows a
    block, and (lingru, staged) bitwise equal at every bf16 (steps,
    stages) and to the streaming variant. With ``timed``, the kernel's
    time beside ``gru_bwd`` or ``lingru_bwd`` on the f32 inputs (CUDA
    events for gru, device time in a trace for lingru, as their f32 rows
    take it), the plain loop's, cuDNN's bf16 GRU backward (gru) and the
    bound; with ``sweep`` (lingru), the device time of every (steps,
    stages) and of the streaming variant."""
    name = f"{kind}_bwd_bf16"
    if kind == "gru":
        x, t, xp, w_hh, b_hh = layer_inputs(torch, shape, dev, rng)
        B, T, H, S = (shape[k] for k in ("B", "T", "H", "S"))
        with torch.no_grad():
            out = fg.gru_recurrence_plain(xp, w_hh, b_hh)
        dy = torch.from_numpy(rng.standard_normal((B, T, S * H), dtype=np.float32)).to(dev)
        args32 = (xp, w_hh, b_hh, out, dy)
        run, plain = fg.gru_recurrence_backward, fg.gru_recurrence_backward_plain
        plan = launch_plan(torch, fg, "bwd", shape, dev, torch.bfloat16)
    else:
        B, T, H = (shape[k] for k in ("B", "T", "H"))
        args32 = lingru_inputs(torch, "bwd", fl, shape, dev, rng)
        run, plain = fl.lingru_scan_backward, fl.lingru_scan_backward_plain
        plan = lingru_plan(torch, fl, "bwd", shape, dev, torch.bfloat16)
    args = tuple(a.to(torch.bfloat16) for a in args32)
    got = run(*args)
    want = plain(*args)
    again = run(*args)
    torch.cuda.synchronize()
    got, want, again = ((o,) if kind == "lingru" else o for o in (got, want, again))
    if got[0].dtype != torch.bfloat16 or any(g.dtype != torch.float32 for g in got[1:]):
        fail(f"{name} returned {[g.dtype for g in got]} at {shape}")
    ulps, excess, within = bf16_ulps(torch, got[0], want[0])
    errs = {"dxp" if kind == "gru" else "dp": (got[0].float() - want[0].float()).abs().max().item()}
    shares = {}
    if not excess <= BF16_BWD_OF_MAX:
        fail(f"{name} is {excess} of its largest entry beyond one bf16 ulp from its plain bf16 "
             f"loop at {shape} ({ulps} ulps at most)")
    for label, g, w in zip(("dw_hh", "db_hh"), got[1:], want[1:]):
        errs[label] = (g - w).abs().max().item()
        shares[label] = errs[label] / max(w.abs().max().item(), 1e-30)
        if not errs[label] <= BF16_DW_OF_MAX * w.abs().max().item():
            fail(f"{name} {label} disagrees with the plain loop at {shape}: max |d| "
                 f"{errs[label]} against max |g| {w.abs().max().item()}")
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        fail(f"{name} differs between two launches at {shape}")
    row = {"shape": shape, "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
           **({"max_abs_err_share_of_max": shares} if shares else {}),
           "max_ulps": ulps, "beyond_one_ulp_of_max": excess,
           "beyond_one_ulp_allowed": BF16_BWD_OF_MAX, "dw_atol_of_max": BF16_DW_OF_MAX,
           "bit_equal_share": (got[0] == want[0]).float().mean().item(),
           "within_one_ulp_share": within,
           "bitwise_repeatable": True, **plan}
    if kind == "gru" and row.get("variant") == "resident":
        for rows in fg.BWD_ROWS:
            forced = fg._gru_bwd_kernel(*args, rows=rows)
            if not all(torch.equal(g, f) for g, f in zip(got, forced)):
                fail(f"{name} at {rows} rows a block differs from {row['rows_per_block']} "
                     f"rows at {shape}")
        row["bitwise_equal_across_rows"] = list(fg.BWD_ROWS)
    if kind == "lingru":
        row.update(lingru_bf16_plans(torch, fl, "bwd", args, got[0], row, shape,
                                     sweep=timed and sweep))
    if not timed:
        return row
    row["output_sha256"] = hashlib.sha256(
        got[0].view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    row["ms_events"] = cuda_ms(torch, lambda: run(*args), iters=20)
    row["f32_ms_events"] = cuda_ms(torch, lambda: run(*args32), iters=20)
    if kind == "gru":
        row["ms"], row["f32_ms"], row["ms_from"] = row["ms_events"], row["f32_ms_events"], "events"
        row["ms_by_kernel"] = kernel_split(
            torch, lambda: run(*args), 20,
            (("recurrence", "gru_bwd_bf16_rec"), ("dw", "gru_bwd_bf16_dw"),
             ("reduce", "gru_bwd_bf16_reduce")))
        # cuDNN's bf16 GRU backward with the same weights: a yardstick only;
        # it also runs the dx and dW_ih products that stay outside the kernel
        ref = cudnn_gru(torch, t, shape["IN"], H, S, dev).to(torch.bfloat16)
        ref.flatten_parameters()
        row["library_note"] = ("torch.autograd.grad through cuDNN nn.GRU in bf16, one "
                               "bidirectional layer, weights flattened; with dx and dW_ih")
        try:  # a PyTorch without a bf16 GRU leaves it out
            xr = x.to(torch.bfloat16).requires_grad_(True)
            lib_out, _ = ref(xr)
            lib_inputs = [xr, *ref.parameters()]
            dyb = args[4]
            row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, lib_inputs, dyb, retain_graph=True), iters=20)
        except RuntimeError as e:
            row["library_ms"], row["library_note"] = None, f"no bf16 nn.GRU here: {e}"
        flops = 3 * 2.0 * T * S * B * H * 3 * H  # hp, dhp W_hh^T, h_prev^T dhp
        nbytes = (2.0 * (sum(a.numel() for a in args) + got[0].numel())
                  + 4.0 * (got[1].numel() + got[2].numel()))
        row.update(bound(torch, flops, nbytes, "bf16"))
        row["dw_pass"] = dw_pass_row(torch, fg, args, got, want, row)
    else:
        split = kernel_split(torch, lambda: run(*args), 20, (("scan", "lingru_bwd_bf16"),))
        split32 = kernel_split(torch, lambda: run(*args32), 20, (("scan", "lingru_bwd"),))
        row["ms_by_kernel"], row["f32_ms_by_kernel"] = split, split32
        row["ms"] = split.get("scan", row["ms_events"])
        row["f32_ms"] = split32.get("scan", row["f32_ms_events"])
        row["ms_from"] = "trace" if "scan" in split and "scan" in split32 else "events"
        row["library_ms"], row["library_note"] = None, LIN_NO_LIBRARY
        row.update(bound(torch, LIN_BWD_OPS * B * T * 2 * H,
                         2.0 * (sum(a.numel() for a in args) + got[0].numel())))
    row["plain_ms"] = cuda_ms(torch, lambda: plain(*args), iters=3, warmup=1)
    return row


def h_prev_rows(torch, out, S: int):
    """h_prev of every row n = b T + t, [S, B T, H] in f32: the forward
    output at t - 1 in direction 0 and t + 1 in direction 1, zero at the
    direction's start."""
    B, T, SH = out.shape
    h = out.float().reshape(B, T, S, SH // S)
    prev = torch.zeros_like(h)
    prev[:, 1:, 0] = h[:, :-1, 0]
    if S == 2:
        prev[:, :-1, 1] = h[:, 1:, 1]
    return prev.reshape(B * T, S, SH // S).transpose(0, 1).contiguous()


def dw_pass_row(torch, fg, args, got, want, row) -> dict:
    """gru_bwd_bf16's weight-gradient pass on its own: its device time from
    the row's trace, dW's max |delta| to the plain loop as a share of its
    largest entry, its bound (dhp in f32 and h_prev in bf16 read once, dW
    and db written once; h_prev^T bf16(dhp) on bf16 tensor cores), the
    bytes its splits' partial sums add beside that (a cost of the design,
    not of the function), and, on the kernel's own dhp where the tree's wrapper hands it out,
    dW and db against the float64 sums of the same operands and the
    library calls that compute the same function: torch.bmm of h_prev^T
    by bf16(dhp) on f32 tensors holding the bf16 values (TF32 off) with
    dhp.sum for db, and bf16-in / f32-out torch.bmm(..., out_dtype=
    torch.float32) where this PyTorch has it."""
    xp, w_hh = args[0], args[1]
    B, T, SH = args[3].shape
    S, H = w_hh.shape[0], w_hh.shape[1]
    N, splits = B * T, row.get("dw_plan", {}).get("splits", fg.bwd_splits(B, T, H, S))
    out = {"ms": row.get("ms_by_kernel", {}).get("dw"), "ms_from": "trace",
           "max_abs_err_share_of_max": row.get("max_abs_err_share_of_max"),
           # check_bf16_bwd_kernel failed the row unless two launches agreed
           "dw_bitwise_repeatable": row["bitwise_repeatable"],
           "launches_in_trace": row.get("ms_by_kernel", {}).get("kernels_traced", {}).get("dw"),
           "kernel_names": row.get("ms_by_kernel", {}).get("kernel_names", {}).get("dw")}
    nbytes = 4.0 * S * N * 3 * H + 2.0 * S * N * H + 4.0 * S * (H * 3 * H + 3 * H)
    out.update(bound(torch, 2.0 * S * N * H * 3 * H, nbytes, "bf16"))
    # written by the pass, read back by the reduce
    out["partial_sums_bytes"] = 4.0 * splits * S * (H * 3 * H + 3 * H)
    if "dhp" not in inspect.signature(fg._gru_bwd_kernel).parameters:
        out["library_ms"], out["library_note"] = None, "the tree's wrapper hands out no dhp"
        return out
    dhp = torch.empty(B, T, S * 3 * H, device=xp.device, dtype=torch.float32)
    mine = fg._gru_bwd_kernel(*args, dhp=dhp)
    if not all(torch.equal(a, b) for a, b in zip(mine, got)):
        fail("gru_bwd_bf16 with its dhp handed out differs from the same launch without")
    h_t = h_prev_rows(torch, args[3], S).transpose(1, 2)           # [S, H, N]
    d_rows = dhp.reshape(N, S, 3 * H).transpose(0, 1).contiguous()  # [S, N, 3H]
    d_op = d_rows.to(torch.bfloat16).float()
    dw64 = torch.bmm(h_t.double(), d_op.double())
    db64 = d_rows.double().sum(dim=1)
    out["vs_float64_of_max"] = {
        "dw_hh": ((got[1].double() - dw64).abs().max() / dw64.abs().max()).item(),
        "db_hh": ((got[2].double() - db64).abs().max() / db64.abs().max()).item()}
    lib_dw = torch.bmm(h_t, d_op)
    out["library_max_abs_err_share_of_max"] = (
        (lib_dw - got[1]).abs().max() / got[1].abs().max()).item()
    out["library_ms"] = cuda_ms(torch, lambda: (torch.bmm(h_t, d_op), d_rows.sum(dim=1)),
                                iters=20)
    out["library_note"] = ("torch.bmm of h_prev^T by bf16(dhp), f32 tensors holding bf16 "
                           "values, TF32 off, and dhp.sum(dim=1) for db, on the kernel's dhp")
    h_b, d_b = h_t.to(torch.bfloat16), d_rows.to(torch.bfloat16)
    try:
        torch.bmm(h_b, d_b, out_dtype=torch.float32)
        out["library_bf16_ms"] = cuda_ms(
            torch, lambda: (torch.bmm(h_b, d_b, out_dtype=torch.float32), d_rows.sum(dim=1)),
            iters=20)
    except (TypeError, RuntimeError) as e:
        out["library_bf16_ms"] = None
        out["library_bf16_note"] = f"no bf16-in / f32-out bmm here: {e}"[:200]
    return out


def card_test_bwd_inputs(torch, fg, shape, dev, seed):
    """The bf16 inputs of tests/test_torch_gpu.py's gru_bwd_bf16 card tests
    at ``shape`` from ``seed``: xp from a standard normal, W_hh and b_hh
    uniform within 1/sqrt(H), the plain loop's forward output, dy."""
    B, T, H, S = (shape[k] for k in ("B", "T", "H", "S"))
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    xp, w, b = (torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16) for a in (
        rng.standard_normal((B, T, S * 3 * H)), rng.uniform(-bound, bound, (S, H, 3 * H)),
        rng.uniform(-bound, bound, (S, 3 * H))))
    out = fg.gru_recurrence_plain(xp, w, b)
    dy = torch.from_numpy(rng.standard_normal((B, T, S * H)).astype(np.float32)).to(dev)
    return xp, w, b, out, dy.to(torch.bfloat16)


def bf16_bwd_card_test(torch, fg, dev) -> dict:
    """gru_bwd_bf16 on the inputs of the card test at the train shape,
    against the plain loop: fails beyond the dxp or dW bar, as the test
    does."""
    args = card_test_bwd_inputs(torch, fg, TRAIN_SHAPE, dev, BF16_GRU_BWD_CARD_TEST_SEED)
    got, want = fg.gru_recurrence_backward(*args), fg.gru_recurrence_backward_plain(*args)
    ulps, excess, within = bf16_ulps(torch, got[0], want[0])
    if not excess <= BF16_BWD_OF_MAX:
        fail(f"gru_bwd_bf16 is {excess} of its largest entry beyond one bf16 ulp from its "
             f"plain bf16 loop on the card test's inputs at {TRAIN_SHAPE}")
    for label, g, w in zip(("dw_hh", "db_hh"), got[1:], want[1:]):
        if not (g - w).abs().max().item() <= BF16_DW_OF_MAX * w.abs().max().item():
            fail(f"gru_bwd_bf16 {label} disagrees with the plain loop on the card test's inputs")
    return {"shape": TRAIN_SHAPE, "seed": BF16_GRU_BWD_CARD_TEST_SEED, "max_ulps": ulps,
            "beyond_one_ulp_of_max": excess, "beyond_one_ulp_allowed": BF16_BWD_OF_MAX,
            "bit_equal_share": (got[0] == want[0]).float().mean().item()}


def plain_bmm_order(torch, dev, shape=TRAIN_SHAPE) -> dict:
    """For the bf16 backward's two step products at ``shape`` (h_prev
    W_hh and bf16(dhp) W_hh^T, bf16 values in f32): the share of
    ``torch.bmm``'s sums bit-equal to one product added at a time in k
    order, in f32 (the products are exact, so each add is a fused
    multiply-add). 1.0 says ``torch.bmm`` sums in k order, one product at
    a time, at that shape on this device, as the plain loop's own
    ``k_order_bmm`` does at every shape."""
    rng = np.random.default_rng(SEED + 6)
    B, H, S = (shape[k] for k in ("B", "H", "S"))

    def draw(shape, scale):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(torch.bfloat16).float()

    w = draw((S, H, 3 * H), H ** -0.5)
    shares = {}
    for name, a, b in (("hp", draw((S, B, H), 1.0), w),
                       ("chain", draw((S, B, 3 * H), 1.0), w.transpose(1, 2))):
        acc = torch.zeros(S, B, b.shape[2], device=dev)
        for k in range(a.shape[2]):
            acc = acc + a[:, :, k:k + 1] * b[:, k:k + 1, :]
        shares[name] = (torch.bmm(a, b) == acc).float().mean().item()
    return shares


def c2_inputs(torch, dev):
    """The inputs of ROADMAP C2 on ``dev`` in bf16, and the golden
    (``tests/torch_golden/c2.py`` beside this script): the card test's
    draws at H = 256, B = 1 from its seed, with the reference's own forward
    output from the golden as ``out``. Fails unless the draws' digest is
    the golden's."""
    from tests.torch_golden import c2

    golden = c2.load()
    draws = c2.draw()
    if c2.digest(*draws) != str(golden["draws_sha256"]):
        fail("the C2 draws on this machine are not the golden's")
    xp, w, b, dy = (torch.from_numpy(a).to(dev).to(torch.bfloat16) for a in draws)
    out = torch.from_numpy(golden["y"]).to(dev).to(torch.bfloat16)
    return (xp, w, b, out, dy), golden


def c2_check(torch, fg, dev) -> dict:
    """ROADMAP C2 on the golden's inputs, each as the largest |delta| of
    dW_hh and db_hh from the reference's bf16 Pallas route, a share of
    the reference's largest entry: (a) the kernel, (b) the plain loop on
    the card, (c) the same plain loop on this machine's CPU, and (d) the
    share of ``torch.bmm``'s sums in k order at C2's shape on the card
    (plain_bmm_order); beside them the kernel from the card's plain loop,
    as the card test holds it, and the launch plan."""
    args, golden = c2_inputs(torch, dev)
    ref = [torch.from_numpy(golden[k]).to(dev) for k in ("w_hh", "b_hh")]

    def share(got, want=ref):
        return {name: ((g.to(dev) - w).abs().max() / w.abs().max()).item()
                for name, g, w in zip(("dw_hh", "db_hh"), got[1:], want)}

    kernel = fg.gru_recurrence_backward(*args)
    plain = fg.gru_recurrence_backward_plain(*args)
    cpu = fg.gru_recurrence_backward_plain(*(a.cpu() for a in args))
    B, T, SH = args[3].shape
    S, H = args[1].shape[:2]
    shape = dict(B=B, T=T, H=H, S=S)
    out = {"shape": shape, "golden": "tests/torch_golden/c2_bf16_bwd.npz",
           "bar_of_max": BF16_DW_OF_MAX,
           "variant": fg.bwd_plan(B, T, H, S, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count, dtype=torch.bfloat16)["variant"],
           "a_kernel_vs_reference": share(kernel),
           "b_card_plain_vs_reference": share(plain),
           "c_cpu_plain_vs_reference": share(cpu), "cpu_threads": torch.get_num_threads(),
           "d_plain_bmm_in_k_order": plain_bmm_order(torch, dev, shape),
           "kernel_vs_card_plain": share(kernel, plain[1:])}
    out["kernel_within_bar"] = max(out["a_kernel_vs_reference"].values()) <= BF16_DW_OF_MAX
    return out


def yardstick_bwd(torch, xp, w_hh, b_hh, out, dy):
    """dxp and dW_hh of the plain bf16 loop
    (fused_gru.gru_recurrence_backward_plain, its formulas and its
    roundings of dhp to bf16) with both step products, h_prev W_hh and
    bf16(dhp) W_hh^T, summed in float64 and rounded to f32, and dW_hh
    summed in float64: a yardstick that sums in no order of the kernel's
    or the plain loop's."""
    B, T, SH = out.shape
    S, H = w_hh.shape[0], w_hh.shape[1]
    x = xp.float().reshape(B, T, S, 3 * H)
    hs, g = out.float().reshape(B, T, S, H), dy.float().reshape(B, T, S, H)
    w64, b = w_hh.double(), b_hh.float()
    dxp = xp.new_empty(B, T, S, 3 * H)
    dw = torch.zeros(S, H, 3 * H, device=xp.device, dtype=torch.float64)
    dh = x.new_zeros(S, B, H)
    zero = x.new_zeros(B, H)
    for step in range(T):
        ts = [T - 1 - step, step][:S]
        prev = [t - 1 if t > 0 else None for t in ts[:1]]
        prev += [t + 1 if t < T - 1 else None for t in ts[1:]]
        xt = torch.stack([x[:, t, s] for s, t in enumerate(ts)])
        h_prev = torch.stack([zero if q is None else hs[:, q, s] for s, q in enumerate(prev)])
        hp = torch.bmm(h_prev.double(), w64).float() + b[:, None]
        r = torch.sigmoid(xt[..., :H] + hp[..., :H])
        z = torch.sigmoid(xt[..., H:2 * H] + hp[..., H:2 * H])
        hpn = hp[..., 2 * H:]
        n = torch.tanh(xt[..., 2 * H:] + r * hpn)
        dh = dh + torch.stack([g[:, t, s] for s, t in enumerate(ts)])
        dz = dh * (h_prev - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * hpn * r * (1.0 - r)
        da = torch.cat([dr, dz, dn], dim=-1)
        for s, t in enumerate(ts):
            dxp[:, t, s] = da[s]
        operand = torch.cat([dr, dz, dn * r], dim=-1).to(torch.bfloat16).double()
        dh = dh * z + torch.bmm(operand, w64.transpose(1, 2)).float()
        dw = dw + torch.bmm(h_prev.double().transpose(1, 2), operand)
    return dxp.reshape(B, T, S * 3 * H), dw


def bf16_bwd_seeds(torch, fg, dev, n_seeds: int, *, yardstick: bool = False) -> dict:
    """gru_bwd_bf16's dxp against the plain loop over ``n_seeds``
    seeded inputs at the train shape (as check_bf16_bwd_kernel draws
    them): by seed, the excess beyond one bf16 ulp as a share of the
    largest entry and the share of bit-equal entries; and the seeds beyond
    BF16_BWD_OF_MAX. The plain loop adds its products one at a time in k
    order; where a sum in another order puts a dhp on the other side of a
    bf16 rounding, the carry takes it on: this reads how often that moves
    dxp beyond the bar. With ``yardstick``, beside it on each seed, the
    kernel's and the f32 plain loop's excess over the same bar from the
    float64 yardstick (yardstick_bwd), and the seeds where each lies
    beyond it."""
    by_seed = []
    for i in range(n_seeds):
        rng = np.random.default_rng(SEED + 100 + i)
        _, _, xp, w_hh, b_hh = layer_inputs(torch, TRAIN_SHAPE, dev, rng)
        xp, w_hh, b_hh = (a.to(torch.bfloat16) for a in (xp, w_hh, b_hh))
        out = fg.gru_recurrence_plain(xp, w_hh, b_hh)
        dy = torch.from_numpy(rng.standard_normal(out.shape, dtype=np.float32)).to(dev)
        args = (xp, w_hh, b_hh, out, dy.to(torch.bfloat16))
        got, want = fg.gru_recurrence_backward(*args)[0], fg.gru_recurrence_backward_plain(*args)[0]
        by_seed.append({"seed": SEED + 100 + i,
                        "beyond_one_ulp_of_max": bf16_ulps(torch, got, want)[1],
                        "bit_equal_share": (got == want).float().mean().item()})
        if yardstick:
            yard = yardstick_bwd(torch, *args)[0]
            by_seed[-1].update(kernel_beyond_yardstick=bf16_ulps(torch, got, yard)[1],
                               plain_beyond_yardstick=bf16_ulps(torch, want, yard)[1])

    def beyond(key):
        return [r["seed"] for r in by_seed if r[key] > BF16_BWD_OF_MAX]

    out = {"shape": TRAIN_SHAPE, "by_seed": by_seed, "beyond_one_ulp_allowed": BF16_BWD_OF_MAX,
           "seeds_beyond_allowed": beyond("beyond_one_ulp_of_max"), "n_seeds": len(by_seed)}
    if yardstick:
        out["kernel_seeds_beyond_yardstick"] = beyond("kernel_beyond_yardstick")
        out["plain_seeds_beyond_yardstick"] = beyond("plain_beyond_yardstick")
    return out


def drive_precision(torch, port, gru_model, lin_model, batches, contig, draft, dev, counts,
                    polish, card, rng):
    """The precision phase: the bf16 kernels against their plain loops and
    timed beside the f32 ones; inference of ``batches`` in f32, bf16 and
    int8 (gru) and in f32 and bf16 (lingru), each path counted and its
    argmax held against f32's; and the polish project streamed with the
    bf16 gru model, its FASTA byte-equal to the bf16 staged stitch and
    compared with the f32 one. Returns (the record, the kernel rows,
    launches by path)."""

    fg, fl = port.fg, port.fl
    rows = {
        "gru_fwd_bf16": [check_bf16_kernel(torch, fg, fl, "gru", B, dev, rng, timed=B >= 128)
                         for B in BF16_GRU_BATCHES],
        "lingru_fwd_bf16": [check_bf16_kernel(torch, fg, fl, "lingru", B, dev, rng, timed=True)
                            for B in BF16_LIN_BATCHES],
    }
    # the backward kernels draw from a stream of their own, so the forward
    # rows see the inputs they saw before
    bwd_rng = np.random.default_rng(SEED + 5)
    rows["gru_bwd_bf16"] = [
        check_bf16_bwd_kernel(torch, fg, fl, "gru", shape, dev, bwd_rng, timed=i == 0)
        for i, shape in enumerate(BF16_GRU_BWD_SHAPES)]
    rows["lingru_bwd_bf16"] = [
        check_bf16_bwd_kernel(torch, fg, fl, "lingru", shape, dev, bwd_rng, timed=i == 0)
        for i, shape in enumerate(BF16_LIN_BWD_SHAPES)]

    rows["gru_bwd_bf16_card_test"] = bf16_bwd_card_test(torch, fg, dev)
    rows["gru_bwd_bf16_seeds"] = bf16_bwd_seeds(torch, fg, dev, BF16_GRU_BWD_SEEDS_READ)
    names = rows["gru_bwd_bf16"][0]["ms_by_kernel"].get("kernel_names", {})
    traced, traced_dw = names.get("recurrence"), names.get("dw")
    if rows["gru_bwd_bf16"][0].get("variant") != "resident" or not traced or not all(
            "rec_resident_mma" in n for n in traced):
        fail(f"gru_bwd_bf16 at {BF16_GRU_BWD_SHAPES[0]} ran {traced}, not the resident mma "
             "recurrence")
    if not traced_dw or not all("gru_bwd_bf16_dw_mma" in n for n in traced_dw):
        fail(f"gru_bwd_bf16 at {BF16_GRU_BWD_SHAPES[0]} ran the weight-gradient passes "
             f"{traced_dw}, not the tensor-core pass")
    for kernel, checked in (("lingru_fwd_bf16", rows["lingru_fwd_bf16"]),
                            ("lingru_bwd_bf16", rows["lingru_bwd_bf16"][:1])):
        for row in checked:
            traced = row.get("ms_by_kernel", {}).get("kernel_names", {}).get("scan", [])
            if row.get("variant") != "staged" or not traced or not all(
                    "staged" in n for n in traced):
                fail(f"{kernel} at {row['shape']} ran {row.get('variant')} ({traced}), not the "
                     "staged kernel")
    emit({"precision_kernel_check": {**rows, "card": card}})

    def variant(model, **changes):
        m = port.RokoModel(dataclasses.replace(model.cfg, **changes))
        m.load_state_dict(model.state_dict(), strict=True)
        return m.to(dev).eval()

    runs = (("gru_float32", gru_model, "gru_fwd"),
            ("gru_bfloat16", variant(gru_model, compute_dtype="bfloat16"), "gru_fwd_bf16"),
            ("gru_int8", variant(gru_model, quantize="int8"), "gru_fwd"),
            ("lingru_float32", lin_model, "lingru_fwd"),
            ("lingru_bfloat16", variant(lin_model, compute_dtype="bfloat16"), "lingru_fwd_bf16"))
    paths, preds = {}, {}
    for label, model, kernel in runs:
        port.predict(model, batches[0][2], dev)  # warm-up: int8 quantizes here, once
        torch.cuda.synchronize()
        counts.zero()
        t0 = time.perf_counter()
        polished = port.run_inference(iter(batches), {contig: draft}, model, device=dev,
                                      log=lambda s: None)[contig]
        seconds = time.perf_counter() - t0
        launches = counts.expect(f"the {label} inference path",
                                 {kernel: model.cfg.num_layers * len(batches)})[kernel]
        # one batch's logits through the kernels against the plain recurrence
        plain = fg.gru_recurrence_plain if model.cfg.kind == "gru" else fl.lingru_scan_plain
        atol, rtol = (BF16_ATOL, 0.0) if model.cfg.compute_dtype == "bfloat16" else (ATOL, RTOL)
        with torch.inference_mode():
            xt = torch.from_numpy(batches[0][2]).to(dev)
            lk, lp = model(xt), model(xt, plain)
        if lk.shape != (len(xt), 90, 5) or not bool(torch.isfinite(lk).all()):
            fail(f"{label}: logits {tuple(lk.shape)}, finite {bool(torch.isfinite(lk).all())}")
        logit_err = (lk - lp).abs().max().item()
        if not torch.allclose(lk, lp, atol=atol, rtol=rtol):
            fail(f"{label}: logits of kernel and plain recurrence differ: max |d| {logit_err}")
        if not polished or set(polished) - set("ACGT"):
            fail(f"{label}: the polished contig is empty or holds letters other than ACGT")
        preds[label] = torch.cat([port.predict(model, x, dev) for _, _, x in batches]).cpu()
        n_windows = sum(len(b[0]) for b in batches)
        paths[label] = {"compute_dtype": model.cfg.compute_dtype, "quantize": model.cfg.quantize,
                        "seconds": seconds, "windows_per_s": n_windows / seconds,
                        f"{kernel}_launches": launches, "polished_len": len(polished),
                        "logits_max_abs_err_vs_plain": logit_err, "atol": atol, "rtol": rtol}
    for label, rec in paths.items():
        base = preds[label.split("_")[0] + "_float32"]
        rec["argmax_agreement_with_float32"] = (preds[label] == base).float().mean().item()
    # where the device time of bf16 gru inference goes (a second, traced run)
    bf16_model = runs[1][1]
    breakdown_bf16 = device_breakdown(
        torch, lambda: port.run_inference(iter(batches), {contig: draft}, bf16_model, device=dev,
                                          log=lambda s: None))

    # the bf16 lingru path traced: its scans are the staged kernels
    lin_bf16_model = runs[4][1]
    breakdown_lingru_bf16 = device_breakdown(
        torch, lambda: port.run_inference(iter(batches), {contig: draft}, lin_bf16_model,
                                          device=dev, log=lambda s: None))
    ran_staged("the lingru_bfloat16 inference path", breakdown_lingru_bf16, ("lingru_fwd_bf16",))

    # the polish project streamed in bf16: byte-equal to its staged stitch
    stream = stream_and_compare(torch, port, bf16_model, dev, counts, polish, "gru_fwd_bf16")
    stream.pop("_run")
    work = os.path.dirname(polish["_stream_inputs"]["paths"]["draft_fasta"])
    f32_seq = port.read_fasta(os.path.join(work, "staged_gru.fasta"))[0][1]
    bf16_seq = port.read_fasta(os.path.join(work, "stream_gru_bfloat16.fasta"))[0][1]
    diff = port.assess_fastas({contig: f32_seq.encode()}, {contig: bf16_seq.encode()}).contigs[0]
    same_len = len(f32_seq) == len(bf16_seq)
    stream["vs_float32_fasta"] = {
        "float32_len": len(f32_seq), "bfloat16_len": len(bf16_seq),
        "identical": f32_seq == bf16_seq, "sub": diff.sub, "ins": diff.ins, "dele": diff.dele,
        "bases_differing": diff.sub + diff.ins + diff.dele,
        "from": "assess_fastas with the f32 staged FASTA as the truth",
        # beside the aligner: the bases that differ at the same index, when
        # both contigs have one length
        "positions_differing": int(np.count_nonzero(
            np.frombuffer(f32_seq.encode(), np.uint8) != np.frombuffer(bf16_seq.encode(), np.uint8)
        )) if same_len else None}
    record = {
        "inference": paths, "windows": sum(len(b[0]) for b in batches),
        "breakdown_bf16": breakdown_bf16, "breakdown_lingru_bf16": breakdown_lingru_bf16,
        "stream_polish_bfloat16": stream, "card": card,
    }
    by_path = {
        "gru_fwd": {"inference_int8": paths["gru_int8"]["gru_fwd_launches"]},
        "gru_fwd_bf16": {"inference_bf16": paths["gru_bfloat16"]["gru_fwd_bf16_launches"],
                         "stream_polish_bf16": stream["gru_fwd_bf16_launches"]},
        "lingru_fwd_bf16": {
            "inference_bf16": paths["lingru_bfloat16"]["lingru_fwd_bf16_launches"]},
    }
    return record, rows, by_path


def train_loss_falls(history) -> bool:
    """The last epoch's train loss under the first's."""
    return history[-1]["train_loss"] < history[0]["train_loss"]


def val_loss_falls(history) -> bool:
    """Some epoch's val loss under the first's (patience may stop a run
    epochs after its best)."""
    return min(h["val_loss"] for h in history) < history[0]["val_loss"]


def drive_train(torch, port, cfg, corpus, batches, contig, draft, dev, counts, fwd, bwd,
                out_name, tcfg=None, falls=train_loss_falls):
    """``loop.train`` of ``cfg`` on the in-memory corpus with ``tcfg`` (by
    default TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_VAL_FRACTION held out),
    counted (``bwd`` once per layer and step, ``fwd`` once per layer and
    step or eval batch; with both None, no kernel at all), every epoch run
    unless patience stopped it, the losses finite and ``falls(history)``,
    its checkpoints verified under ``build/out_name``, and the best one
    polishing ``batches[:TRAINED_POLISH_BATCHES]`` through ``fwd``.
    Returns the record, the result and the train config."""
    out_dir = os.path.join(ROOT, "build", out_name)
    shutil.rmtree(out_dir, ignore_errors=True)
    tcfg = tcfg or port.TrainConfig(batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, seed=SEED,
                                    val_fraction=TRAIN_VAL_FRACTION)
    train_logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    t0 = time.perf_counter()
    result = port.loop.train(corpus, out_dir, model_cfg=cfg, train_cfg=tcfg, device=dev,
                             resume=False, log=train_logs.append)
    train_seconds = time.perf_counter() - t0
    history = result.history
    n_val = port.holdout_size(tcfg.val_fraction, len(corpus))
    eval_batches = -(-n_val // tcfg.batch_size)
    launches = counts.expect(
        f"{cfg.kind} training ({cfg.num_layers} layers, {result.step} steps, "
        f"{len(history)} x {eval_batches} eval batches)",
        {fwd: cfg.num_layers * (result.step + len(history) * eval_batches),
         bwd: cfg.num_layers * result.step} if fwd else {})
    train_peak = torch.cuda.max_memory_allocated()
    stopped = any(s.startswith("early stop") for s in train_logs)
    if len(history) != tcfg.epochs and not (stopped and len(history) < tcfg.epochs):
        fail(f"{cfg.kind} train ran {len(history)} epochs, expected {tcfg.epochs} or an "
             "early stop")
    losses = [h[k] for h in history for k in ("train_loss", "val_loss")]
    if not all(math.isfinite(v) for v in losses) or not falls(history):
        fail(f"{cfg.kind} train losses not finite, or not falling by {falls.__name__}: "
             f"{[{k: h[k] for k in ('train_loss', 'val_loss')} for h in history]}")
    manifests = {}
    for ckpt in sorted(os.listdir(out_dir)):
        status, detail = port.verify_manifest(os.path.join(out_dir, ckpt))
        manifests[ckpt] = status
        if status != "ok":
            fail(f"checkpoint {ckpt} fails verification: {detail}")
    if "latest" not in manifests or len(manifests) < 2:
        fail(f"expected latest and numbered checkpoints, found {sorted(manifests)}")
    train_secs = sum(h["seconds"] for h in history)
    best_step = port.CheckpointManager(out_dir).best_step()

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
                  {fwd: cfg.num_layers * len(polish_batches)} if fwd else {})
    board = port.VoteBoard({contig: draft})
    for names, pos, x in polish_batches:
        board.add(names, pos, port.predict(trained, x, dev).cpu().numpy())
    if set(polished_t) - set("ACGT") or polished_t != board.stitch(contig):
        fail(f"the trained {cfg.kind} checkpoint's polish holds letters other than ACGT "
             "or is not the stitch of its votes")
    record = {
        "config": f"ModelConfig(kind={cfg.kind!r}, compute_dtype={cfg.compute_dtype!r}) "
                  f"({cfg.num_layers} layers, hidden {cfg.hidden_size}, dropout {cfg.dropout}"
                  + (f", d_model {cfg.d_model}, {cfg.num_heads} heads, mlp_ratio "
                     f"{cfg.mlp_ratio}" if cfg.kind == "transformer" else "") + ", full width)",
        "windows": len(corpus), "val_fraction": tcfg.val_fraction, "batch": tcfg.batch_size,
        "epochs": len(history), "steps": result.step, "best_step": best_step,
        "seconds": train_seconds,
        "train_loop_seconds": train_secs, "steps_per_s": result.step / train_secs,
        "windows_per_s": result.step * tcfg.batch_size / train_secs,
        "history": history, "guard": result.guard_counters,
        **({f"{fwd}_launches": launches[fwd], f"{bwd}_launches": launches[bwd]} if fwd
           else {"kernel_launches": sum(launches.values())}),
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


def bf16_beside(f32_train: dict) -> dict:
    """The f32 train line's numbers that a bf16 train line prints beside its
    own (both runs of one call)."""
    return {k: f32_train[k] for k in ("windows_per_s", "steps_per_s", "train_loop_seconds",
                                      "steps", "guard")} | {
        "train_loss": [h["train_loss"] for h in f32_train["history"]],
        "val_acc": [h["val_acc"] for h in f32_train["history"]]}


def assess_row(res) -> dict:
    """An ``assess_fastas`` result as the quality line prints it: error %,
    Q (None when error-free) and the error counts by kind."""
    q = res.qscore
    return {"error_pct": 100.0 * res.error_rate, "q": None if math.isinf(q) else q,
            "mis": sum(c.sub for c in res.contigs), "del": sum(c.dele for c in res.contigs),
            "ins": sum(c.ins for c in res.contigs), "truth_len": res.truth_len}


def drive_quality(torch, port, dev, counts, card) -> dict:
    """The quality phase: ``roko_tpu_torch/examples/synthetic_e2e.py``'s
    recipe on the card through its in-memory route, in each error regime:
    the 12 kb / 30x project, its training windows and labels through
    ``drive_train`` (full-width gru f32, batch 64, lr 3e-3, 25 epochs or an
    early stop, 10 % held out), the best checkpoint polishing the inference
    windows through ``drive_inference`` (the logits of every batch against
    the plain recurrence), and ``assess_fastas`` against the truth. Fails
    unless the draft's error rate is BASELINE.md's to the printed digits,
    the polish is under a third of it, the losses are finite and the val
    loss falls, the checkpoints verify and the launches are ``gru_bwd``
    layers x steps, ``gru_fwd`` layers x (steps + epochs x eval batches)
    and layers x batches a polish. The kernels are held against their
    plain loops at the path's own batch sizes: ``gru_fwd`` and ``gru_bwd``
    at the padded train batch, ``gru_fwd_bf16`` at each batch size of the
    bf16 polish. The uniform checkpoint also polishes in bf16 and int8
    (printed, not gated)."""
    e2e, fg = port.e2e, port.fg
    t_phase = time.perf_counter()
    cfg = port.ModelConfig()
    tcfg = e2e.train_config()
    layers = cfg.num_layers
    # every train and eval batch is padded to the recipe's batch
    rng = np.random.default_rng(SEED + 30)
    train_shape = dict(TRAIN_SHAPE, B=tcfg.batch_size)
    kernel_check = {"gru_fwd": [check_kernel(torch, fg, train_shape, dev, rng, timed=False)],
                    "gru_bwd": [check_bwd_kernel(torch, fg, train_shape, dev, rng, timed=False)]}
    record = {"config": f"ModelConfig(kind={cfg.kind!r}) ({layers} layers, hidden "
                        f"{cfg.hidden_size}, embed {cfg.embed_dim}, read MLP {cfg.read_mlp}, "
                        f"dropout {cfg.dropout}, full width)",
              "recipe": {"genome_len": e2e.GENOME_LEN, "coverage": e2e.COVERAGE,
                         "batch": tcfg.batch_size, "lr": tcfg.lr, "epochs": tcfg.epochs,
                         "patience": tcfg.patience, "val_fraction": tcfg.val_fraction,
                         "features_seeds": [e2e.TRAIN_FEATURES_SEED, e2e.INFER_FEATURES_SEED],
                         "homopolymer": e2e.HOMOPOLYMER},
              "kernel_check": kernel_check, "regimes": {}, "card": card}
    totals = {"gru_fwd": 0, "gru_bwd": 0, "gru_fwd_bf16": 0}

    def polish(model, plain, kernel, batches, contig, draft, paths) -> dict:
        path, polished = drive_inference(torch, port, model, plain, batches, contig, draft, dev,
                                         counts, kernel)
        totals[kernel] += path[f"{kernel}_launches"]
        _, res = e2e.assess_polish(paths, {contig: polished})
        return {**assess_row(res), **{k: v for k, v in path.items() if k in (
            "seconds", "windows_per_s", f"{kernel}_launches", "polished_len",
            "logits_max_abs_err_vs_plain", "near_ties", "plain_stitch_identical")}}

    for regime in QUALITY_REGIMES:
        work = os.path.join("chip_smoke_quality", regime)
        shutil.rmtree(os.path.join(ROOT, "build", work), ignore_errors=True)
        t0 = time.perf_counter()
        paths = e2e.build_project(os.path.join(ROOT, "build", work), regime)
        X, Y = e2e.training_arrays(paths)
        batches = e2e.inference_batches(paths)
        data_seconds = time.perf_counter() - t0
        contig = paths["contig"]
        draft = port.read_fasta(paths["draft_fasta"])[0][1]
        draft_res, _ = e2e.assess_polish(paths, {contig: draft})
        draft_row = assess_row(draft_res)
        if f"{draft_row['error_pct']:.4f}" != QUALITY_DRAFT_PCT[regime]:
            fail(f"quality {regime}: the draft's error rate {draft_row['error_pct']:.4f} % is "
                 f"not BASELINE.md's {QUALITY_DRAFT_PCT[regime]} %")

        out_name = os.path.join(work, "ckpt")
        train, result, _ = drive_train(torch, port, cfg, port.InMemoryDataset(X, Y), batches,
                                       contig, draft, dev, counts, "gru_fwd", "gru_bwd",
                                       out_name, tcfg=tcfg, falls=val_loss_falls)
        totals["gru_fwd"] += train["gru_fwd_launches"]
        totals["gru_bwd"] += train["gru_bwd_launches"]
        best = port.RokoModel(cfg)
        best.load_state_dict(port.load_params(os.path.join(ROOT, "build", out_name)),
                             strict=True)
        best.to(dev).eval()
        polished = polish(best, fg.gru_recurrence_plain, "gru_fwd", batches, contig, draft,
                          paths)
        if not polished["error_pct"] < draft_row["error_pct"] / QUALITY_REDUCTION:
            fail(f"quality {regime}: the polished error rate {polished['error_pct']:.4f} % is not "
                 f"under the draft's {draft_row['error_pct']:.4f} % / {QUALITY_REDUCTION}")
        n_val = port.holdout_size(tcfg.val_fraction, len(X))
        history = result.history
        row = {
            "draft": draft_row, "polished": polished,
            "reduction": draft_row["error_pct"] / max(polished["error_pct"], 1e-12),
            "jax_reference_row": {**QUALITY_JAX_ROWS[regime],
                                  "from": "BASELINE.md, examples/synthetic_e2e.py, JAX on a "
                                          "CPU; other dropout masks, no identity claimed"},
            "windows": {"train": len(X) - n_val, "val": n_val,
                        "inference": sum(len(b[0]) for b in batches)},
            "epochs_run": train["epochs"], "best_step": train["best_step"],
            "best_epoch": int(np.searchsorted(np.cumsum([h["steps"] for h in history]),
                                              train["best_step"])),
            "steps": train["steps"], "eval_batches_per_epoch": train["eval_batches_per_epoch"],
            "train_seconds": train["seconds"], "train_loop_seconds": train["train_loop_seconds"],
            "train_windows_per_s": train["windows_per_s"], "data_seconds": data_seconds,
            "launches": {"train": {k: train[f"{k}_launches"] for k in ("gru_fwd", "gru_bwd")},
                         "polish": {"gru_fwd": polished["gru_fwd_launches"]}},
            "history": [{k: h[k] for k in ("train_loss", "val_acc", "val_loss", "seconds")}
                        for h in history],
            **{k: train[k] for k in ("guard", "checkpoints", "trained_polish_len", "log")},
        }
        if regime == "uniform":  # what the precision modes cost in output quality
            kernel_check["gru_fwd_bf16"] = [
                check_bf16_kernel(torch, fg, port.fl, "gru", B, dev, rng, timed=False)
                for B in sorted({len(b[0]) for b in batches})]
            for label, changes, kernel, plain in (
                    ("bfloat16", {"compute_dtype": "bfloat16"}, "gru_fwd_bf16", None),
                    ("int8", {"quantize": "int8"}, "gru_fwd", fg.gru_recurrence_plain)):
                m = port.RokoModel(dataclasses.replace(cfg, **changes))
                m.load_state_dict(best.state_dict(), strict=True)
                row[label] = polish(m.to(dev).eval(), plain, kernel, batches, contig, draft, paths)
                row["launches"]["polish_" + label] = {kernel: row[label][f"{kernel}_launches"]}
        record["regimes"][regime] = row
    record["launches"] = totals
    record["seconds"] = time.perf_counter() - t_phase
    return record


def drive_transformer(torch, port, batches, contig, draft, dev, counts, polish, corpus,
                      gru_train, gru_train_bf16, card, rng):
    """``kind="transformer"`` at full width (3 layers, d_model 256, 8 heads,
    mlp_ratio 4), random weights from ``rng`` in the JAX layout through
    the weights bridge. Its products are plain matrix products: every path
    runs with every launch count set to 0 and must leave them all at 0.

    (a) ``run_inference`` of ``batches`` in f32 and in bf16, windows/s for
    each; the f32 logits of the first ``TRANSFORMER_CPU_WINDOWS`` windows
    against the same model on this machine's CPU (rtol 1e-4, atol 1e-5;
    argmax equal where the CPU's top-two gap exceeds 1e-4); bf16 against
    f32: argmax agreement over every window and the largest |logit delta|.
    (b) ``run_streaming_polish`` of the polish project, byte-equal to the
    staged stitch of the same windows with the same model. (c)
    ``loop.train`` for two epochs over the training corpus in f32 and in
    bf16, checkpoints verified, the best polishing, windows/s and losses
    beside the gru runs'. A traced breakdown of inference and of train
    steps in each dtype, which must hold none of the port's kernels."""

    def traced(what, breakdown):
        if breakdown.get("port_kernels_ms_calls"):
            fail(f"the transformer's {what} trace holds the port's kernels: "
                 f"{breakdown['port_kernels_ms_calls']}")
        return breakdown

    cfg = port.ModelConfig(kind="transformer")
    model = port.RokoModel(cfg)
    model.load_state_dict(port.state_dict_from_jax(jax_layout_params(rng, cfg)), strict=True)
    bf16 = port.RokoModel(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    bf16.load_state_dict(model.state_dict(), strict=True)
    cpu_model = port.RokoModel(cfg)
    cpu_model.load_state_dict(model.state_dict(), strict=True)
    model.to(dev).eval()
    bf16.to(dev).eval()
    cpu_model.eval()
    n_windows = sum(len(b[0]) for b in batches)

    # (a) inference, counted: no kernel launches
    paths = {}
    for label, m in (("float32", model), ("bfloat16", bf16)):
        port.predict(m, batches[0][2], dev)  # warm-up: library handles, allocator
        torch.cuda.synchronize()
        counts.zero()
        t0 = time.perf_counter()
        polished = port.run_inference(iter(batches), {contig: draft}, m, device=dev,
                                      log=lambda s: None)[contig]
        seconds = time.perf_counter() - t0
        counts.expect(f"the transformer {label} inference path", {})
        if not polished or set(polished) - set("ACGT"):
            fail(f"transformer {label}: the polished contig is empty or holds letters other "
                 "than ACGT")
        paths[label] = {"seconds": seconds, "windows_per_s": n_windows / seconds,
                        "kernel_launches": 0, "polished_len": len(polished)}
    counts.zero()
    with torch.inference_mode():
        logits = {label: [m(torch.from_numpy(x).to(dev)) for _, _, x in batches]
                  for label, m in (("float32", model), ("bfloat16", bf16))}
        x_cpu = torch.from_numpy(batches[0][2][:TRANSFORMER_CPU_WINDOWS])
        t0 = time.perf_counter()
        on_cpu = cpu_model(x_cpu)
        cpu_s = time.perf_counter() - t0
    counts.expect("the transformer logits", {})
    f32 = torch.cat(logits["float32"])
    b16 = torch.cat(logits["bfloat16"])
    if f32.shape != (n_windows, cfg.window_cols, cfg.num_classes) or b16.shape != f32.shape:
        fail(f"transformer logits shapes {tuple(f32.shape)}, {tuple(b16.shape)}")
    if not bool(torch.isfinite(f32).all()) or not bool(torch.isfinite(b16).all()):
        fail("non-finite transformer logits")
    card_part = f32[:TRANSFORMER_CPU_WINDOWS].cpu()
    cpu_err = (card_part - on_cpu).abs().max().item()
    if not torch.allclose(card_part, on_cpu, rtol=RTOL, atol=TRANSFORMER_CPU_ATOL):
        fail(f"transformer f32 logits on the card and the CPU differ: max |d| {cpu_err}")
    top2 = on_cpu.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > TRANSFORMER_ARGMAX_GAP
    argmax_misses = int(((card_part.argmax(-1) != on_cpu.argmax(-1)) & clear).sum())
    if argmax_misses:
        fail(f"transformer: {argmax_misses} argmax differences between card and CPU on "
             f"columns whose top-two gap exceeds {TRANSFORMER_ARGMAX_GAP}")
    for label, m in (("float32", model), ("bfloat16", bf16)):
        paths[label]["breakdown"] = traced(f"{label} inference", device_breakdown(
            torch, lambda: port.run_inference(iter(batches), {contig: draft}, m, device=dev,
                                              log=lambda s: None)))
    inference = {
        **paths,
        "windows": n_windows, "batches": len(batches), "batch_size": len(batches[0][0]),
        "vs_cpu": {"windows": TRANSFORMER_CPU_WINDOWS, "max_abs_err": cpu_err,
                   "rtol": RTOL, "atol": TRANSFORMER_CPU_ATOL,
                   "argmax_gap": TRANSFORMER_ARGMAX_GAP,
                   "columns_checked": int(clear.sum()), "columns": clear.numel(),
                   "argmax_misses": 0, "cpu_seconds": cpu_s},
        "bfloat16_vs_float32": {
            "argmax_agreement": (b16.argmax(-1) == f32.argmax(-1)).float().mean().item(),
            "max_abs_logit_delta": (b16.float() - f32).abs().max().item()},
    }

    # (b) the polish project streamed: byte-equal to its staged stitch
    stream = stream_and_compare(torch, port, model, dev, counts, polish, None)
    stream.pop("_run")

    # (c) training in f32 and bf16, no kernel launches
    train, result, tcfg = drive_train(torch, port, cfg, corpus, batches, contig, draft, dev,
                                      counts, None, None, "chip_smoke_train_transformer")
    train_bf16, result_bf16, _ = drive_train(
        torch, port, dataclasses.replace(cfg, compute_dtype="bfloat16"), corpus, batches, contig,
        draft, dev, counts, None, None, "chip_smoke_train_transformer_bf16")
    for rec, res, label in ((train, result, "float32"), (train_bf16, result_bf16, "bfloat16")):
        rec.pop("log")
        rec["breakdown"] = traced(f"{label} train", train_breakdown(
            torch, port, res, corpus, tcfg, dev))
    return {
        "config": f"ModelConfig(kind='transformer') ({cfg.num_layers} layers, d_model "
                  f"{cfg.d_model}, {cfg.num_heads} heads, mlp_ratio {cfg.mlp_ratio}, "
                  "full width)",
        "inference": inference, "stream_polish": stream,
        "train": {**train, "gru": bf16_beside(gru_train)},
        "train_bf16": {**train_bf16, "float32": bf16_beside(train),
                       "gru": bf16_beside(gru_train_bf16)},
        "kernel_launches": 0, "card": card,
    }


def bench_kernel_check(torch, port, dev) -> dict:
    """The kernels at the bench's shapes that no earlier phase launches,
    each against its plain version (the bars and checks of the rows
    above), with its launch plan and its time by CUDA events: gru_fwd,
    gru_fwd_bf16 and lingru_fwd at batch BENCH_WIDE_B, gru_fwd and gru_bwd
    at BENCH_STRESS_SHAPE, which must run the streaming variants, and
    gru_bwd at the train rows' batch; then, checked and not timed, the
    forwards of the precision column's logit deltas at its batch,
    ``benchmark.LOGIT_DELTA_BATCH`` (f32 and int8 on the f32 kernels, bf16
    on the bf16 ones)."""
    fg, fl, delta_b = port.fg, port.fl, port.bench.LOGIT_DELTA_BATCH
    rng = np.random.default_rng(SEED + 7)
    wide = dict(MAIN_SHAPE, B=BENCH_WIDE_B)
    rows = {"gru_fwd": check_kernel(torch, fg, wide, dev, rng, timed=False),
            "gru_fwd_bf16": check_bf16_kernel(torch, fg, fl, "gru", BENCH_WIDE_B, dev, rng,
                                              timed=False),
            "lingru_fwd": check_lingru(torch, fl, "fwd", dict(LIN_INFER_SHAPE, B=BENCH_WIDE_B),
                                       dev, rng, timed=False),
            "gru_fwd_stress": check_kernel(torch, fg, BENCH_STRESS_SHAPE, dev, rng, timed=False),
            "gru_bwd_stress": check_bwd_kernel(torch, fg, BENCH_STRESS_SHAPE, dev, rng,
                                               timed=False),
            "gru_bwd_train": check_bwd_kernel(torch, fg, BENCH_TRAIN_SHAPE, dev, rng,
                                              timed=False)}
    if rows["gru_bwd_train"]["variant"] != "resident":
        fail(f"gru_bwd at {BENCH_TRAIN_SHAPE} ran {rows['gru_bwd_train']['variant']}, "
             "not resident")
    for name in ("gru_fwd_stress", "gru_bwd_stress"):
        if rows[name]["variant"] != "streaming":
            fail(f"{name} at {BENCH_STRESS_SHAPE} ran {rows[name]['variant']}, not streaming")
    for name, row in rows.items():
        shape = row["shape"]
        if name.startswith("lingru"):
            args = lingru_inputs(torch, "fwd", fl, shape, dev, np.random.default_rng(SEED + 8))
            run = fl.lingru_scan
        else:
            args = layer_inputs(torch, shape, dev, np.random.default_rng(SEED + 8))[2:]
            if name == "gru_fwd_bf16":
                args = tuple(a.to(torch.bfloat16) for a in args)
            run = fg.gru_recurrence
            if name.startswith("gru_bwd"):
                out = fg.gru_recurrence(*args)
                dy = torch.ones_like(out)
                args, run = (*args, out, dy), fg.gru_recurrence_backward
        row["ms"], row["ms_from"] = cuda_ms(torch, lambda: run(*args), iters=10), "events"
    rows["delta_batch"] = {
        "gru_fwd": check_kernel(torch, fg, dict(MAIN_SHAPE, B=delta_b), dev, rng,
                                timed=False),
        "lingru_fwd": check_lingru(torch, fl, "fwd", dict(LIN_INFER_SHAPE, B=delta_b),
                                   dev, rng, timed=False),
        **{f"{kind}_fwd_bf16": check_bf16_kernel(torch, fg, fl, kind, delta_b, dev, rng,
                                                 timed=False)
           for kind in ("gru", "lingru")}}
    return rows


def bench_launches(bench) -> dict:
    """The kernel launches of ``bench --train --bench-iterations
    BENCH_ITERS`` at the default widths (3 layers, one launch a layer and
    forward or backward): every timed call runs bench.WARMUP + BENCH_ITERS
    times. The inference sweep and the recurrence alone run gru_fwd; the
    lingru row and its recurrence lingru_fwd; the precision column, per
    kind, f32 and int8 (f32 compute) on the f32 kernel and bf16 on the
    bf16 one, timed, then one forward of each for the logit deltas; the
    train rows a forward and a backward a step, 4 layers in the stress
    row; the transformer row none."""
    n, layers, stress = bench.WARMUP + BENCH_ITERS, 3, 4
    timed = layers * n
    precision_f32, precision_bf16 = 2 * timed + 2 * layers, timed + layers
    return {"gru_fwd": len(bench.SWEEP_BATCHES) * timed + timed + precision_f32 + timed
            + stress * n,
            "gru_bwd": timed + stress * n,
            "gru_fwd_bf16": precision_bf16,
            "lingru_fwd": timed + timed + precision_f32,
            "lingru_fwd_bf16": precision_bf16}


def drive_bench(torch, port, counts) -> dict:
    """The bench phase: ``python -m roko_tpu_torch bench --train
    --bench-iterations BENCH_ITERS --mesh-devices 1,2`` in this process (``benchmark.main``,
    which prints its JSON line; its --out file is read back), with every
    launch count set to 0 just before and read just after. Fails unless it
    returns 0 with no error in a row of a ported suite, and each kernel
    launched as often as its suites launch it."""
    out_path = os.path.join(ROOT, "build", "chip_smoke_bench.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    counts.zero()
    t0 = time.perf_counter()
    rc = port.bench.main(["--train", "--bench-iterations", str(BENCH_ITERS), "--mesh-devices",
                          MESH_DEVICES, "--out", out_path])
    seconds = time.perf_counter() - t0
    with open(out_path) as f:
        result = json.load(f)
    errors = port.bench.ported_errors(result)
    if rc != 0 or errors:
        fail(f"bench returned {rc}; rows of ported suites failed: {errors}")
    launches = counts.expect("the bench", bench_launches(port.bench))
    d = result["detail"]
    row = d["train"]["train_transformer"]
    if not row.get("windows_per_sec", 0) > 0:
        fail(f"the bench's train_transformer row holds no number: {row}")
    return {"seconds": seconds, "bench_iterations": BENCH_ITERS, "launches": launches,
            **{k: result[k] for k in ("metric", "value", "unit", "vs_baseline")},
            **{k: d.get(k) for k in ("compute_dtype", "windows_per_sec", "best_batch",
                                     "batch_sweep", "mfu_pct", "recurrence_only",
                                     "lingru_speedup_vs_gru", "torch_cpu_ref_windows_per_sec")},
            "model_kinds": {k: r.get("kernels_windows_per_sec")
                            for k, r in d["model_kinds"].items()},
            "precision": {k: {c: r.get(c) for c in ("f32_windows_per_sec",
                                                    "bf16_windows_per_sec",
                                                    "int8_windows_per_sec")}
                          for k, r in d["precision"].items()},
            "train": {k: d["train"][k] for k in ("train_gru", "train_scan_stress",
                                                  "train_transformer")},
            "mesh": d.get("mesh")}


class DigestedCorpus:
    """An in-memory corpus that records each training batch it streams
    (those drawn with a shuffle generator; evaluation's are not): its
    step batch size, a sha256 of its (x, y, weight) and the sha256 of
    each real row. Views (``sharded``, ``unsharded``) share the record."""

    def __init__(self, port, X, Y):
        corpus = self

        class Recorded(port.InMemoryDataset):
            def batches(self, batch_size, **kw):
                for x, y, w in super().batches(batch_size, **kw):
                    if kw.get("rng") is not None:
                        corpus.record.append((
                            len(x), hashlib.sha256(x.tobytes() + y.tobytes() + w.tobytes())
                            .hexdigest(),
                            [hashlib.sha256(r.tobytes()).hexdigest() for r in x[w > 0]]))
                    yield x, y, w

        self.dataset = Recorded(X, Y)
        self.record = []


def trace_kernels(path: str) -> dict:
    """``{kind: {"events", "device_ms"}}`` of the port's kernels in a
    torch.profiler Chrome trace (device events, category ``kernel``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") != "kernel" or not e.get("dur"):
            continue
        kind = next((k for k in KERNEL_KINDS if k in e.get("name", "").lower()), None)
        if kind is not None:
            row = out.setdefault(kind, {"events": 0, "device_ms": 0.0})
            row["events"] += 1
            row["device_ms"] += e["dur"] / 1e3
    return out


def nondeterministic_grads(torch, port, cfg, corpus, dev) -> list:
    """The parameters whose gradient differs between two identical train
    steps (same weights, batch and dropout masks) on the card."""
    model = port.RokoModel(cfg, torch.Generator().manual_seed(SEED)).to(dev)
    batch = next(corpus.batches(TRAIN_BATCH, rng=np.random.default_rng(SEED)))
    x, y, w = port.loop.to_device(batch, dev)
    grads = []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        port.loop.grad_step(model, x, y, w, gen)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    return sorted(n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n]))


def drive_train_plane(torch, port, cfg, batches, contig, draft, dev, counts, card) -> dict:
    """The training data plane and run controls at full width, each run
    counted (``gru_fwd`` 3 times a step and an evaluation batch, ``gru_bwd``
    3 times a step):

    (a) run A trains two epochs saving ``latest`` every 5 steps; run A' is
        the same from a RokoConfig JSON file (e); run B is stopped by its
        log hook at epoch 1 step 8, its ``latest`` verified, and resumed,
        which must name epoch 1, batch 5; A and B end at the same step,
        with the same batch digests from the resume point on, and the
        same parameters: bitwise when A and A' are, else within the bar,
        with the gradients that differ between two identical steps named;
    (b) one epoch of each of 2 shards at a step batch of 64: the shards'
        rows are disjoint and their union is A's epoch 0;
    (c) the engine's readahead (2 mix groups) against none, batch for batch;
    (d) ``train(trace_dir=)`` and ``run_inference(trace_dir=)`` traces
        that parse, with device time of ``gru_fwd`` and ``gru_bwd``;
    (e) the config file's sections equal the keyword configs, and its run
        takes A's steps and losses;
    and, with h5py on the machine, ``train --no-memory --save-every-steps``
    end to end on the corpus written to HDF5."""
    loop = port.loop
    root = os.path.join(ROOT, "build", "chip_smoke_train_plane")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(SEED + 6)
    X = rng.integers(0, port.C.FEATURE_VOCAB, (PLANE_WINDOWS, port.C.WINDOW_ROWS,
                                               port.C.WINDOW_COLS), dtype=np.uint8)
    Y = (X.sum(axis=1) % port.C.NUM_CLASSES).astype(np.int32)
    tcfg = port.TrainConfig(batch_size=TRAIN_BATCH, epochs=PLANE_EPOCHS, seed=SEED,
                            log_every_steps=1)
    gcfg = port.GuardConfig(save_every_steps=PLANE_SAVE_EVERY)
    dcfg = port.DataConfig()
    steps = PLANE_WINDOWS // TRAIN_BATCH
    evals = -(-PLANE_WINDOWS // TRAIN_BATCH)
    launched = {"gru_fwd": 0, "gru_bwd": 0}
    layers = cfg.num_layers

    def run(name, *, model_cfg=cfg, train_cfg=tcfg, guard_cfg=gcfg, data_cfg=dcfg,
            log=None, trace_dir=None, want_steps, want_evals):
        corpus = DigestedCorpus(port, X, Y)
        logs = []
        counts.zero()
        t0 = time.perf_counter()
        result = None
        try:
            result = loop.train(corpus.dataset, os.path.join(root, name), model_cfg=model_cfg,
                                train_cfg=train_cfg, guard_cfg=guard_cfg, data_cfg=data_cfg,
                                device=dev, trace_dir=trace_dir,
                                log=lambda s: (logs.append(s), log and log(s)))
        except StopRun:
            pass
        seconds = time.perf_counter() - t0
        got = counts.expect(f"train_plane run {name} ({want_steps} steps, {want_evals} "
                            "evaluation batches)",
                            {"gru_fwd": layers * (want_steps + want_evals),
                             "gru_bwd": layers * want_steps})
        for k in launched:
            launched[k] += got[k]
        return result, corpus.record, logs, seconds

    def stop_at(marker):
        def hook(line):
            if marker in line:
                raise StopRun(line)
        return hook

    # (a) and (e): A by keywords, A' from the config file, B stopped and resumed
    res_a, rec_a, logs_a, sec_a = run("a", want_steps=PLANE_EPOCHS * steps,
                                      want_evals=PLANE_EPOCHS * evals)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        f.write(port.RokoConfig(model=cfg, train=tcfg, guard=gcfg, data=dcfg).to_json())
    with open(cfg_path) as f:
        loaded = port.RokoConfig.from_json(f.read())
    if (loaded.model, loaded.train, loaded.guard, loaded.data) != (cfg, tcfg, gcfg, dcfg):
        fail("train_plane: the RokoConfig JSON does not load back to the keyword configs")
    res_c, rec_c, logs_c, _ = run("config", model_cfg=loaded.model, train_cfg=loaded.train,
                                  guard_cfg=loaded.guard, data_cfg=loaded.data,
                                  want_steps=PLANE_EPOCHS * steps,
                                  want_evals=PLANE_EPOCHS * evals)
    stop_step = int(PLANE_STOP.split()[3].split("/")[0])
    _, rec_b1, _, _ = run("b", log=stop_at(PLANE_STOP), want_steps=steps + stop_step,
                          want_evals=evals)
    status, detail = port.verify_manifest(os.path.join(root, "b", "latest"))
    if status != "ok":
        fail(f"train_plane: run B's mid-epoch latest fails verification: {detail}")
    resume_batch = stop_step // PLANE_SAVE_EVERY * PLANE_SAVE_EVERY
    res_b, rec_b, logs_b, _ = run("b", want_steps=steps - resume_batch, want_evals=evals)
    resumed = [line for line in logs_b if line.startswith("resumed from step")]
    if not resumed or PLANE_RESUMED not in resumed[0]:
        fail(f"train_plane: run B resumed with {resumed}, not at {PLANE_RESUMED!r}")
    if not res_a.step == res_b.step == res_c.step == PLANE_EPOCHS * steps:
        fail(f"train_plane: steps A {res_a.step}, B {res_b.step}, config {res_c.step}")
    if [r[1] for r in rec_b] != [r[1] for r in rec_a[steps + resume_batch:]]:
        fail("train_plane: run B's batches after the resume differ from run A's")
    if rec_c != rec_a:
        fail("train_plane: the config run streamed other batches than run A")
    if any(r[0] != TRAIN_BATCH for r in rec_a):
        fail("train_plane: a step batch of run A is not the train batch")

    sd = {k: v.float() for k, v in res_a.model.state_dict().items()}
    repeatable = all(torch.equal(sd[k], v.float()) for k, v in res_c.model.state_dict().items())
    loss_a = [h["train_loss"] for h in res_a.history]
    if repeatable:
        differs = []
        same_params = all(torch.equal(sd[k], v.float())
                          for k, v in res_b.model.state_dict().items())
        if not same_params or res_b.history[-1]["train_loss"] != loss_a[1] or (
                [h["train_loss"] for h in res_c.history] != loss_a):
            fail("train_plane: the card's train step is bitwise repeatable, but the resumed "
                 "or the config run does not end bitwise where run A ends")
        bar = "bitwise"
    else:
        differs = nondeterministic_grads(torch, port, cfg, port.InMemoryDataset(X, Y), dev)
        worst = 0.0
        for other in (res_b, res_c):
            for k, v in other.model.state_dict().items():
                scale = max(sd[k].abs().max().item(), 1e-30)
                d = (v.float() - sd[k]).abs().max().item() / scale
                worst = max(worst, d)
                if d > PLANE_PARAM_OF_MAX:
                    fail(f"train_plane: parameter {k} of a resumed or config run lies "
                         f"{d:.3g} of its largest entry from run A's")
        for got in (res_b.history[-1]["train_loss"], res_c.history[-1]["train_loss"]):
            if abs(got - loss_a[1]) > PLANE_LOSS_RTOL * abs(loss_a[1]):
                fail(f"train_plane: epoch 1 loss {got} against run A's {loss_a[1]}")
        bar = {"param_of_max": PLANE_PARAM_OF_MAX, "loss_rtol": PLANE_LOSS_RTOL,
               "worst_param_of_max": worst}

    # (b) shards: one epoch of each, a step batch of batch / shards
    shard_rows, shard_runs = [], []
    trace_dir = os.path.join(root, "trace_train")
    for shard in range(PLANE_SHARDS):
        one = dataclasses.replace(tcfg, epochs=1, log_every_steps=0)
        res_s, rec_s, logs_s, _ = run(
            f"shard{shard}", train_cfg=one,
            data_cfg=port.DataConfig(shards=PLANE_SHARDS, shard_id=shard),
            trace_dir=trace_dir if shard == 0 else None, want_steps=steps, want_evals=evals)
        if any(r[0] != TRAIN_BATCH // PLANE_SHARDS for r in rec_s):
            fail(f"train_plane: shard {shard} stepped on batches of "
                 f"{sorted({r[0] for r in rec_s})}, not {TRAIN_BATCH // PLANE_SHARDS}")
        shard_rows.append([h for r in rec_s for h in r[2]])
        shard_runs.append({"steps": res_s.step, "local_batch": TRAIN_BATCH // PLANE_SHARDS,
                           "rows": len(shard_rows[-1]),
                           "log": [line for line in logs_s if "[shard" in line]})
    epoch0 = [h for r in rec_a[:steps] for h in r[2]]
    union = shard_rows[0] + shard_rows[1]
    if set(shard_rows[0]) & set(shard_rows[1]) or sorted(union) != sorted(epoch0) or len(
            set(epoch0)) != PLANE_WINDOWS:
        fail("train_plane: the shards' rows do not partition the 1-shard epoch")

    # (c) readahead: the engine with 2 mix groups ahead against none
    corpus = port.InMemoryDataset(X, Y)
    read, _ = corpus._reader()
    streams = [list(port.iter_span_batches(corpus._counts(), read, TRAIN_BATCH,
                                           rng=port.epoch_rng(SEED, 0), pad_to=TRAIN_BATCH,
                                           prefetch_groups=depth)) for depth in (2, 0)]
    if len(streams[0]) != len(streams[1]) or not all(
            all(np.array_equal(a, b) for a, b in zip(p, q)) for p, q in zip(*streams)):
        fail("train_plane: the engine with readahead yields other batches than without")

    # (d) traces: the first shard's epoch, and an inference run
    model = port.RokoModel(cfg)
    model.load_state_dict(res_a.model.state_dict())
    counts.zero()
    port.run_inference(iter(batches), {contig: draft}, model, device=dev, log=lambda s: None,
                       trace_dir=os.path.join(root, "trace_infer"))
    got = counts.expect("the traced train_plane inference", {"gru_fwd": layers * len(batches)})
    launched["gru_fwd"] += got["gru_fwd"]
    traces = {}
    for name, want in (("trace_train", ("gru_fwd", "gru_bwd")), ("trace_infer", ("gru_fwd",))):
        files = os.listdir(os.path.join(root, name))
        if len(files) != 1:
            fail(f"train_plane: {name} holds {files}, not one trace")
        kinds = trace_kernels(os.path.join(root, name, files[0]))
        if any(kinds.get(k, {}).get("device_ms", 0) <= 0 for k in want) or set(kinds) - set(want):
            fail(f"train_plane: {name} holds the device events {kinds}, expected {want}")
        traces[name] = kinds

    hdf5 = "not run: no h5py on this machine"
    if importlib.util.find_spec("h5py") is not None:
        from roko_tpu_torch.data.hdf5 import DataWriter

        h5 = os.path.join(root, "corpus.hdf5")
        cols = port.C.WINDOW_COLS
        with DataWriter(h5, infer=False) as w:
            w.write_contigs([("plane", "A" * 64)])
            w.store("plane", [np.stack([np.arange(cols), np.zeros(cols)], 1)] * len(X),
                    list(X), list(Y))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "roko_tpu_torch", "train", h5, os.path.join(root, "h5"),
             "--no-memory", "--save-every-steps", str(PLANE_SAVE_EVERY), "--epochs", "1",
             "--b", str(TRAIN_BATCH)], capture_output=True, text=True, timeout=600, cwd=ROOT)
        if proc.returncode != 0 or port.verify_manifest(
                os.path.join(root, "h5", "latest"))[0] != "ok":
            fail(f"train_plane: train --no-memory failed: {proc.stderr[-2000:]}")
        hdf5 = {"seconds": time.perf_counter() - t0,
                "log": [line for line in proc.stdout.splitlines() if line.startswith("epoch")]}

    return {
        "config": f"ModelConfig(kind={cfg.kind!r}) ({cfg.num_layers} layers, hidden "
                  f"{cfg.hidden_size}, full width), in-memory corpus of {PLANE_WINDOWS} windows, "
                  f"batch {TRAIN_BATCH}, {steps} steps an epoch",
        "resume": {"stopped_at": PLANE_STOP, "resumed": resumed[0],
                   "save_every_steps": PLANE_SAVE_EVERY, "steps": res_b.step,
                   "batches_after_resume_equal": len(rec_b), "latest_manifest": status,
                   "train_loss": {"a": loss_a, "b_epoch1": res_b.history[-1]["train_loss"]}},
        "params": {"repeatable_bitwise": repeatable, "bar": bar,
                   "nondeterministic_grads": differs,
                   "op": (None if repeatable else
                          "the embedding's backward (torch.nn.functional.embedding sums the "
                          "rows' gradients with float atomics)" if differs == ["embedding.weight"]
                          else f"the backward of {differs}" if differs else
                          "not found in one step's gradients")},
        "shards": {"shards": PLANE_SHARDS, "runs": shard_runs,
                   "disjoint": True, "union_is_epoch0": True},
        "prefetch": {"mix_groups_ahead": 2, "batches_equal": len(streams[0])},
        "traces": traces,
        "config_run": {"steps": res_c.step, "train_loss": [h["train_loss"]
                                                           for h in res_c.history],
                       "equal_to_keywords": True},
        "windows_per_s_a": [h["windows_per_s"] for h in res_a.history],
        "seconds_a": sec_a,
        "hdf5": hdf5, "launches": launched, "card": card,
    }


class StopRun(Exception):
    """Raised by a run's log hook to stop it where a kill would."""


def mesh_corpus(port):
    """The mesh phase's labelled corpus, the same in every process."""
    C = port.C
    rng = np.random.default_rng(SEED + 8)
    X = rng.integers(0, C.FEATURE_VOCAB, (MESH_TRAIN_WINDOWS, C.WINDOW_ROWS, C.WINDOW_COLS),
                     dtype=np.uint8)
    return port.InMemoryDataset(X, (X.sum(axis=1) % C.NUM_CLASSES).astype(np.int32))


def mesh_contigs(port):
    """({name: draft}, windows(only)): MESH_CONTIGS synthetic contigs and
    their window batches of 128, those of the contigs in ``only`` (None:
    all), as ``infer.polish_windows_to_fasta`` reads them."""
    rng = np.random.default_rng(SEED + 9)
    contigs, per = {}, {}
    for i in MESH_CONTIG_ORDER:
        name = f"mesh{i}"
        contigs[name], pos, x = synthetic_contig(rng, MESH_CONTIG_WINDOWS, port.C)
        per[name] = [([name] * len(x[j : j + TRAIN_BATCH]), pos[j : j + TRAIN_BATCH],
                      x[j : j + TRAIN_BATCH]) for j in range(0, len(x), TRAIN_BATCH)]

    def windows(only):
        for name in contigs:
            if only is None or name in only:
                yield from per[name]

    return contigs, windows


def flat_grads(torch, model):
    """Every gradient of ``model`` in parameter order, one f32 vector on the host."""
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()]).cpu()


def grads_within(torch, what, got, want, sizes, rtol=STEP_RTOL, atol_of_max=STEP_ATOL_OF_MAX,
                 scale_of=None):
    """Each parameter's slice of the flat gradients ``got`` against
    ``want`` at step_parity's bar; the worst one's numbers. ``scale_of``
    names, for a parameter whose exact gradient is 0 (its entries rounding
    noise), the parameter whose largest entry sets its bar."""
    worst, offset, spans = {}, 0, {}
    for name, n in sizes:
        spans[name] = (offset, offset + n)
        offset += n
    for name, n in sizes:
        a, b = spans[name]
        g, ref = got[a:b], want[a:b]
        a, b = spans[(scale_of or {}).get(name, name)]
        scale = want[a:b].abs().max().item()
        d = (g - ref).abs().max().item()
        worst[name] = [d, scale]
        if not torch.allclose(g, ref, rtol=rtol, atol=atol_of_max * scale):
            fail(f"{what}: gradient {name}: max |d| {d} against max |g| {scale}")
    top = max(worst, key=lambda n: worst[n][0] / max(worst[n][1], 1e-30))
    return {"params": len(worst), "max_abs_err": max(v[0] for v in worst.values()),
            "worst_relative": {"param": top, "max_abs_err": worst[top][0],
                               "max_abs_grad": worst[top][1]},
            "rtol": rtol, "atol_of_max_grad": atol_of_max}


def params_sha(torch, model) -> str:
    return hashlib.sha256(b"".join(p.detach().cpu().numpy().tobytes()
                                   for p in model.parameters())).hexdigest()


def mesh_child(torch, spec_path: str) -> None:
    """One rank of the mesh phase (``chip_smoke.py --mesh-child SPEC``),
    joined to its run by ``ROKO_*``: mode ``nccl1`` takes one dp train step
    on an NCCL group of one rank and the same step through the plain
    recurrence; mode ``pair`` takes one dp step with dropout on at the
    global batch, trains one epoch with ``loop.train``, times the step's
    flat all-reduce alone, and polishes the mesh contigs split by contig. Writes ``rank{r}.json`` beside SPEC."""
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["mode"] in TP_SP_RUNS:
        return tp_sp_child(torch, spec)
    if spec["mode"] == "mesh_serve":
        return mesh_serve_child(torch, spec)
    sys.path.insert(0, ROOT)
    from roko_tpu_torch import constants as C
    from roko_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from roko_tpu_torch.infer import polish_windows_to_fasta, use_float32_matmuls
    from roko_tpu_torch.models import fused_gru as fg
    from roko_tpu_torch.models import fused_lingru as fl
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.parallel import distributed
    from roko_tpu_torch.parallel.mesh import all_reduce_, make_mesh, shard_batch
    from roko_tpu_torch.training import loop
    from roko_tpu_torch.training.data import InMemoryDataset

    port = types.SimpleNamespace(C=C, InMemoryDataset=InMemoryDataset)
    counts = Counts(fg, fl)
    use_float32_matmuls()
    distributed.initialize(device="cuda", backend=spec["backend"])
    dev = distributed.device_of_rank("cuda")
    mesh = make_mesh()
    rank = mesh.rank
    out = {"rank": rank, "world": distributed.world_size(), "backend": distributed.backend(),
           "collective": mesh.collective, "device": str(dev)}
    corpus = mesh_corpus(port)
    batch = next(corpus.batches(TRAIN_BATCH, rng=np.random.default_rng(SEED)))
    if spec["mode"] == "nccl1":
        model = RokoModel(ModelConfig(dropout=0.0), torch.Generator().manual_seed(SEED))
        model.to(dev).train()
        x, y, w = loop.to_device(shard_batch(mesh, batch), dev)
        counts.zero()
        loss, finite = loop.grad_step(model, x, y, w, None, mesh)
        out["launches"] = counts.expect("the dp step on NCCL", {"gru_fwd": 3, "gru_bwd": 3})
        got = flat_grads(torch, model)
        model.zero_grad(set_to_none=True)
        loss_p, _, _ = loop.loss_and_stats(model(x, fg.gru_recurrence_plain), y, w)
        loss_p.backward()
        if not bool(finite) or abs(loss.item() - loss_p.item()) > STEP_RTOL * abs(loss_p.item()) + 1e-6:
            fail(f"the dp step on NCCL: loss {loss.item()} (finite {bool(finite)}), plain "
                 f"{loss_p.item()}")
        out["step"] = {"loss_dp_kernels": loss.item(), "loss_plain": loss_p.item(),
                       **grads_within(torch, "the dp step on NCCL against the plain step", got,
                                      flat_grads(torch, model),
                                      [(n, p.numel()) for n, p in model.named_parameters()])}
        gathered = distributed.all_gather_cpu(torch.tensor([rank, 7]))
        out["cpu_gather"] = gathered.tolist()
    else:
        cfg = ModelConfig()
        model = RokoModel(cfg, torch.Generator().manual_seed(SEED)).to(dev)
        x, y, w = loop.to_device(shard_batch(mesh, batch), dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        counts.zero()
        loss, finite = loop.grad_step(model, x, y, w, gen, mesh)
        out["step_launches"] = counts.expect("a dp step", {"gru_fwd": 3, "gru_bwd": 3})
        grads = flat_grads(torch, model)
        out["step"] = {"loss": loss.item(), "finite": bool(finite),
                       "grads_sha256": hashlib.sha256(grads.numpy().tobytes()).hexdigest()}
        if rank == 0:
            np.save(os.path.join(spec["dir"], "grads_rank0.npy"), grads.numpy())
        logs = []
        torch.cuda.synchronize()
        counts.zero()
        t0 = time.perf_counter()
        result = loop.train(corpus, os.path.join(spec["dir"], "ckpt"), model_cfg=cfg,
                            train_cfg=TrainConfig(batch_size=TRAIN_BATCH, epochs=1, seed=SEED,
                                                  log_every_steps=0),
                            data_cfg=DataConfig(block_size=MESH_BLOCK), device="cuda",
                            resume=False, log=logs.append)
        out["train"] = {"seconds": time.perf_counter() - t0, "steps": result.step,
                        "history": result.history, "log": logs,
                        "launches": counts.expect("a dp train epoch", {
                            "gru_fwd": 3 * (result.step + MESH_TRAIN_WINDOWS // TRAIN_BATCH),
                            "gru_bwd": 3 * result.step}),
                        "params_sha256": params_sha(torch, result.model)}
        # the step's flat all-reduce alone: the loss and every gradient
        flat = torch.zeros(1 + sum(p.numel() for p in model.parameters()), device=dev)
        all_reduce_(mesh, flat)
        torch.cuda.synchronize()
        distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(MESH_ALLREDUCE_REPS):
            all_reduce_(mesh, flat)
        torch.cuda.synchronize()
        out["allreduce"] = {"bytes": flat.numel() * 4, "reps": MESH_ALLREDUCE_REPS,
                            "ms": 1e3 * (time.perf_counter() - t0) / MESH_ALLREDUCE_REPS}
        contigs, windows = mesh_contigs(port)
        infer_model = RokoModel(cfg, torch.Generator().manual_seed(SEED + 1)).to(dev).eval()
        counts.zero()
        t0 = time.perf_counter()
        polish_windows_to_fasta(contigs, windows, infer_model,
                                os.path.join(spec["dir"], "mesh.fasta"), device="cuda",
                                log=lambda s: None)
        mine = sorted(contigs)[rank::distributed.world_size()]
        out["infer"] = {"seconds": time.perf_counter() - t0, "contigs": mine,
                        "launches": counts.expect("a rank's share of the contigs", {
                            "gru_fwd": 3 * len(mine) * -(-MESH_CONTIG_WINDOWS // TRAIN_BATCH)})}
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()


def run_ranks(mode: str, ranks: int, backend: str, out_dir: str) -> list:
    """``ranks`` processes of ``chip_smoke.py --mesh-child`` in mode
    ``mode``, joined by ``ROKO_*`` on a free localhost port; their
    ``rank{r}.json``. Fails, after killing them all, unless every rank
    exits 0 within MESH_CHILD_TIMEOUT_S."""
    import socket

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"mode": mode, "backend": backend, "dir": out_dir}, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("ROKO_")}
    env.update(ROKO_COORDINATOR=f"127.0.0.1:{port}", ROKO_NUM_PROCESSES=str(ranks))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-child",
                               spec_path], cwd=ROOT, env={**env, "ROKO_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MESH_CHILD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"mesh {mode}: a rank outlasted {MESH_CHILD_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"mesh {mode}: rank {r} of {ranks} exited {p.returncode}:\n{log[-3000:]}")
    out = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def drive_mesh(torch, port, dev, counts, bench_mesh, card) -> dict:
    """The mesh phase: (a) NCCL at world size 1, a dp train step through
    the kernels against the plain step at step_parity's bar; (b) two gloo
    ranks sharing the card: one dp step with dropout on at the global
    batch against this process's one-rank step at the same batch and
    masks (step_parity's bar: the card's embedding backward sums with
    atomics), then one epoch of ``train`` (shards = ranks), replicas
    bitwise equal, each rank's kernel launches, windows/s beside a
    one-rank run here; (c) the two ranks' contig-split inference
    byte-identical to one rank's, its parts removed; (d) the bench's mesh
    suite (run by the bench phase) byte-identical across 1 and 2 ranks."""
    base = os.path.join(ROOT, "build", "chip_smoke_mesh")
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    t0 = time.perf_counter()
    (nccl,) = run_ranks("nccl1", 1, "nccl", os.path.join(base, "nccl1"))
    if nccl["backend"] != "nccl" or not nccl["collective"] or nccl["cpu_gather"] != [[0, 7]]:
        fail(f"mesh (a): not an NCCL group of one rank with its CPU side: {nccl}")
    nccl_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    pair_dir = os.path.join(base, "pair")
    pair = run_ranks("pair", MESH_RANKS, "gloo", pair_dir)
    pair_seconds = time.perf_counter() - t0
    if {r["backend"] for r in pair} != {"gloo"} or [r["world"] for r in pair] != [2, 2]:
        fail(f"mesh (b): ranks not in one gloo group of 2: {pair}")
    for key in ("loss", "grads_sha256"):
        if len({r["step"][key] for r in pair}) != 1:
            fail(f"mesh (b): the ranks' dp steps differ in {key}")
    if len({r["train"]["params_sha256"] for r in pair}) != 1:
        fail("mesh (b): the replicas' parameters differ after training")
    for r in pair:
        losses = [h["train_loss"] for h in r["train"]["history"]]
        if not all(math.isfinite(v) for v in losses):
            fail(f"mesh (b): rank {r['rank']} train losses {losses}")
    # one rank at the global batch, the same masks: the card's step
    cfg = port.ModelConfig()
    model = port.RokoModel(cfg, torch.Generator().manual_seed(SEED)).to(dev)
    corpus = mesh_corpus(port)
    batch = next(corpus.batches(TRAIN_BATCH, rng=np.random.default_rng(SEED)))
    x, y, w = port.loop.to_device(batch, dev)
    loss, _ = port.loop.grad_step(model, x, y, w, torch.Generator(device=dev).manual_seed(SEED))
    got = torch.from_numpy(np.load(os.path.join(pair_dir, "grads_rank0.npy")))
    step = {"loss_2_ranks": pair[0]["step"]["loss"], "loss_1_rank": loss.item(),
            **grads_within(torch, "mesh (b): two ranks' dp step against one rank", got,
                           flat_grads(torch, model),
                           [(n, p.numel()) for n, p in model.named_parameters()])}
    if abs(step["loss_2_ranks"] - step["loss_1_rank"]) > STEP_RTOL * abs(step["loss_1_rank"]) + 1e-6:
        fail(f"mesh (b): loss of two ranks {step['loss_2_ranks']}, one rank {step['loss_1_rank']}")
    manifests = {}
    for ckpt in sorted(os.listdir(os.path.join(pair_dir, "ckpt"))):
        status, detail = port.verify_manifest(os.path.join(pair_dir, "ckpt", ckpt))
        manifests[ckpt] = status
        if status != "ok":
            fail(f"mesh (b): checkpoint {ckpt} fails verification: {detail}")
    # the same epoch in this process, one rank, for windows/s beside
    one_dir = os.path.join(base, "one_rank")
    shutil.rmtree(one_dir, ignore_errors=True)
    torch.cuda.synchronize()
    counts.zero()
    one = port.loop.train(corpus, one_dir, model_cfg=cfg,
                          train_cfg=port.TrainConfig(batch_size=TRAIN_BATCH, epochs=1, seed=SEED,
                                                     log_every_steps=0),
                          data_cfg=port.DataConfig(block_size=MESH_BLOCK), device=dev,
                          resume=False, log=lambda s: None)
    one_launches = counts.expect("the one-rank epoch", {
        "gru_fwd": 3 * (one.step + MESH_TRAIN_WINDOWS // TRAIN_BATCH), "gru_bwd": 3 * one.step})
    if one.step != pair[0]["train"]["steps"]:
        fail(f"mesh (b): one rank took {one.step} steps, two ranks {pair[0]['train']['steps']}")

    # (c) the contig-split FASTA against one rank's: one rank writes the
    # draft's order, two ranks the names sorted (as the reference merges)
    contigs, windows = mesh_contigs(port)
    infer_model = port.RokoModel(cfg, torch.Generator().manual_seed(SEED + 1)).to(dev).eval()
    one_fasta = os.path.join(base, "one_rank.fasta")
    counts.zero()
    polished = port.polish_windows_to_fasta(contigs, windows, infer_model, one_fasta,
                                            device=dev, log=lambda s: None)
    counts.expect("the one-rank inference", {
        "gru_fwd": 3 * MESH_CONTIGS * -(-MESH_CONTIG_WINDOWS // TRAIN_BATCH)})
    one_order = [n for n, _ in port.read_fasta(one_fasta)]
    if one_order != list(contigs):
        fail(f"mesh (c): one rank wrote {one_order}, not the draft's order {list(contigs)}")
    sorted_fasta = os.path.join(base, "one_rank_sorted.fasta")
    port.write_fasta(sorted_fasta, sorted(polished.items()))
    with open(sorted_fasta, "rb") as f:
        want = f.read()
    with open(os.path.join(pair_dir, "mesh.fasta"), "rb") as f:
        fasta = f.read()
    parts = [n for n in os.listdir(pair_dir) if ".part" in n]
    if fasta != want or parts or fasta.count(b">") != MESH_CONTIGS:
        fail(f"mesh (c): the two ranks' FASTA is not one rank's with the names sorted "
             f"({len(fasta)} vs {len(want)} bytes; parts left: {parts})")

    # (d) the bench's mesh suite
    if not bench_mesh or not bench_mesh.get("byte_identical"):
        fail(f"mesh (d): the bench's mesh suite is not byte-identical across counts: "
             f"{bench_mesh}")
    for n, row in bench_mesh["rows"].items():
        want_fwd = 3 * BENCH_ITERS
        if any(r["gru_fwd"] != want_fwd for r in row["launches_by_rank"]):
            fail(f"mesh (d): {n} rank(s) launched gru_fwd {row['launches_by_rank']}, "
                 f"expected {want_fwd} each")

    wps = pair[0]["train"]["history"][-1]["windows_per_s"]
    one_wps = one.history[-1]["windows_per_s"]
    return {
        "nccl_world_1": {"seconds": nccl_seconds, "launches": nccl["launches"],
                         "step": nccl["step"], "device": nccl["device"]},
        "gloo_2_ranks": {
            "seconds": pair_seconds, "config": "ModelConfig() (gru f32, 3 layers, hidden 128, "
            "dropout 0.2, full width)", "windows": MESH_TRAIN_WINDOWS,
            "global_batch": TRAIN_BATCH, "block_size": MESH_BLOCK,
            "steps": pair[0]["train"]["steps"], "step_vs_1_rank": step,
            "params_bitwise_equal": True, "params_sha256": pair[0]["train"]["params_sha256"],
            "launches_by_rank": [{"step": r["step_launches"], "train": r["train"]["launches"],
                                  "infer": r["infer"]["launches"]} for r in pair],
            "windows_per_s": wps, "windows_per_s_1_rank": one_wps,
            "allreduce_by_rank": [r["allreduce"] for r in pair],
            "over_1_rank": wps / one_wps, "train_seconds_by_rank":
                [r["train"]["seconds"] for r in pair],
            "history_rank0": pair[0]["train"]["history"], "history_1_rank": one.history,
            "launches_1_rank": one_launches, "checkpoints": manifests,
            "log_rank0": pair[0]["train"]["log"], "log_rank1": pair[1]["train"]["log"]},
        "contig_split": {"contigs": MESH_CONTIGS, "windows_per_contig": MESH_CONTIG_WINDOWS,
                         "draft_order": list(contigs), "one_rank_order": one_order,
                         "two_rank_order": [n for n, _ in port.read_fasta(
                             os.path.join(pair_dir, "mesh.fasta"))],
                         "by_rank": [r["infer"]["contigs"] for r in pair],
                         "seconds_by_rank": [r["infer"]["seconds"] for r in pair],
                         "fasta_bytes": len(fasta),
                         "byte_identical_to_1_rank_names_sorted": True},
        "bench_mesh": bench_mesh, "card": card,
        "not_run": "NCCL across more than one card: the machine has one",
    }


def key_bias_scale(sizes) -> dict:
    """The key biases' gradients are 0 exactly (a bias on every key adds the
    same score to each key of a query, which the softmax cancels): their
    entries are rounding noise, held within 1e-4 of the largest entry of
    their layer's key weight gradient instead of their own."""
    return {n: n[: -len("bias")] + "weight" for n, _ in sizes if n.endswith(".k.bias")}


def tp_sp_config(port):
    """The phase's model: ``kind="transformer"`` at full width, dropout 0.2."""
    return port.ModelConfig(kind="transformer", dropout=TP_SP_DROPOUT)


def tp_sp_weights(port, cfg):
    """The full state_dict, from a numpy seed through the weights bridge."""
    return port.state_dict_from_jax(jax_layout_params(np.random.default_rng(SEED + 11), cfg))


def tp_sp_batch(C):
    """The global train batch of the phase (TRAIN_BATCH windows, all real)."""
    rng = np.random.default_rng(SEED + 12)
    x = rng.integers(0, C.FEATURE_VOCAB, (TRAIN_BATCH, C.WINDOW_ROWS, C.WINDOW_COLS),
                     dtype=np.uint8)
    return x, (x.sum(axis=1) % C.NUM_CLASSES).astype(np.int32), np.ones(TRAIN_BATCH, np.float32)


def ring_inputs(torch, cfg, dev):
    """q, k, v and the output's cotangent, [TRAIN_BATCH, 90, d_model] f32."""
    rng = np.random.default_rng(SEED + 13)
    shape = (TRAIN_BATCH, cfg.window_cols, cfg.d_model)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
            for _ in range(4)]


def all_logits(torch, model, windows, gather) -> np.ndarray:
    """Every window's logits, batch by batch as ``windows(None)`` gives them."""
    out = []
    with torch.inference_mode():
        for _, _, x in windows(None):
            out.append(gather(model(torch.from_numpy(x).to(next(model.parameters()).device)))
                       .float().cpu().numpy())
    return np.concatenate(out)


def timed_steps(torch, step, n: int) -> float:
    """Milliseconds a call of ``step`` takes, over ``n`` calls after one."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def tp_sp_child(torch, spec) -> None:
    """One rank of the tp_sp phase (``--mesh-child`` with a ``tp_*`` mode),
    gloo on the shared card: the ring alone on the run's first sp ranks
    (its block of the output and of dq/dk/dv saved, one rotation timed); then for each
    layout of the run, one train step with dropout on at the global batch
    (the full gradients, gathered over tp, saved by rank 0), 3 Adam steps
    (a sha256 of every parameter part), the step timed, and for tp=2 and
    sp=2 the mesh contigs' inference (FASTA, every window's logits, timed).
    Every launch count must stay 0: the transformer runs no kernel."""
    sys.path.insert(0, ROOT)
    from roko_tpu_torch import constants as C
    from roko_tpu_torch.config import MeshConfig, ModelConfig
    from roko_tpu_torch.infer import polish_windows_to_fasta, use_float32_matmuls
    from roko_tpu_torch.models import fused_gru as fg
    from roko_tpu_torch.models import fused_lingru as fl
    from roko_tpu_torch.models.convert import state_dict_from_jax
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.parallel import distributed, ring, tp
    from roko_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
    from roko_tpu_torch.training import loop
    from roko_tpu_torch.training.data import InMemoryDataset

    port = types.SimpleNamespace(C=C, InMemoryDataset=InMemoryDataset, ModelConfig=ModelConfig,
                                 state_dict_from_jax=state_dict_from_jax)
    counts = Counts(fg, fl)
    use_float32_matmuls()
    distributed.initialize(device="cuda", backend=spec["backend"])
    dev = distributed.device_of_rank("cuda")
    rank, world = distributed.rank(), distributed.world_size()
    _, ring_sp, layouts = TP_SP_RUNS[spec["mode"]]
    cfg = tp_sp_config(port)
    out = {"rank": rank, "world": world, "backend": distributed.backend(), "layouts": {}}

    def save(name, **arrays):
        np.savez(os.path.join(spec["dir"], f"{name}.npz"),
                 **{k: v.detach().float().cpu().numpy() for k, v in arrays.items()})

    if ring_sp == world:
        mesh = make_mesh(MeshConfig(dp=1, sp=ring_sp))
    else:  # a ring on the first ring_sp ranks; every rank makes its group
        import torch.distributed as dist

        group = dist.new_group(list(range(ring_sp)))
        mesh = Mesh(dp=1, rank=rank, group=dist.group.WORLD, sp=ring_sp, sp_group=group)
    if rank < ring_sp:
        cols = ring.column_block(mesh, cfg.window_cols)
        q, k, v, ct = (t[:, cols].contiguous().requires_grad_(i < 3)
                       for i, t in enumerate(ring_inputs(torch, cfg, dev)))
        counts.zero()
        o = ring.ring_attention(q, k, v, cfg.num_heads, mesh)
        (o * ct).sum().backward()
        counts.expect("ring attention", {})
        save(f"ring{ring_sp}_s{mesh.s}", out=o, dq=q.grad, dk=k.grad, dv=v.grad)
        blocks = [k.detach(), v.detach()]
        out["ring"] = {"sp": ring_sp, "s": mesh.s, "transport": ring.transport(dev),
                       "rotation_bytes": sum(b.numel() * b.element_size() for b in blocks),
                       "rotation_ms": timed_steps(torch, lambda: ring.rotate(blocks, mesh, 1),
                                                  TP_SP_ROTATIONS)}
    full = tp_sp_weights(port, cfg)
    batch = tp_sp_batch(C)
    for name in layouts:
        mesh = make_mesh(MeshConfig(**TP_SP_LAYOUTS[name]))
        model = RokoModel(cfg, mesh=mesh)
        model.load_state_dict(tp.shard_state_dict(cfg, full, mesh), strict=True)
        model.to(dev)
        x, y, w = loop.to_device(shard_batch(mesh, batch), dev)
        gen = torch.Generator(device=dev)
        opt = loop.make_optimizer(model, TP_SP_LR)
        row = {"coords": [mesh.d, mesh.t, mesh.s], "losses": []}
        counts.zero()
        for k in range(TP_SP_ADAM_STEPS):
            gen.manual_seed(SEED + k)
            loss, finite = loop.grad_step(model, x, y, w, gen, mesh)
            if not bool(finite):
                fail(f"tp_sp (b) {name}: step {k} not finite")
            row["losses"].append(loss.item())
            if k == 0:
                grads = [tp.gather(p.grad, tp.split_axis(n), mesh).cpu().reshape(-1)
                         for n, p in model.named_parameters()]
                if rank == 0:
                    np.save(os.path.join(spec["dir"], f"grads_{name}.npy"),
                            torch.cat(grads).numpy())
            opt.step()
        row["params_sha256"] = {n: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
                                for n, p in model.named_parameters()}
        gen.manual_seed(SEED)
        row["step_ms"] = timed_steps(torch, lambda: loop.grad_step(model, x, y, w, gen, mesh),
                                     TP_SP_TIMED_STEPS)
        row["launches"] = counts.expect(f"tp_sp {name} train steps", {})
        if name in TP_SP_INFER_LAYOUTS:
            infer = RokoModel(cfg, mesh=mesh)
            infer.load_state_dict(tp.shard_state_dict(cfg, full, mesh), strict=True)
            infer.to(dev).eval()
            contigs, windows = mesh_contigs(port)
            counts.zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            polish_windows_to_fasta(contigs, windows, infer,
                                    os.path.join(spec["dir"], f"{name}.fasta"), device="cuda",
                                    log=lambda s: None)
            torch.cuda.synchronize()
            row["infer_seconds"] = time.perf_counter() - t0
            logits = all_logits(torch, infer, windows,
                                lambda t: ring.gather_columns(t, mesh) if infer.column_split
                                else t)
            row["infer_launches"] = counts.expect(f"tp_sp {name} inference", {})
            if rank == 0:
                np.save(os.path.join(spec["dir"], f"logits_{name}.npy"), logits)
        out["layouts"][name] = row
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()


def fasta_diff(want: dict, got: dict) -> dict:
    """Per contig name: identical, and the bases that differ (positions,
    where the lengths agree; else the lengths)."""
    out = {}
    for name, seq in want.items():
        other = got.get(name, "")
        if len(seq) == len(other):
            out[name] = sum(a != b for a, b in zip(seq, other))
        else:
            out[name] = {"lengths": [len(seq), len(other)]}
    return out


def drive_tp_sp(torch, port, dev, counts, card) -> dict:
    """The tp_sp phase: tensor and sequence parallelism of the transformer
    at full width, on gloo ranks sharing the card. (a) ring attention alone
    at sp = 2 and 3 (T=90, B=128) against dense ``attention`` here: max |d|
    of the output and of dq/dk/dv, at the reference's bars; (b) one train
    step (batch 128, dropout 0.2) at dp=1 x tp=2, dp=1 x sp=2 and dp=2 x
    tp=2 against one rank's step at the global batch with the same masks
    (each gradient within 1e-4 of its largest entry), and after 3 Adam
    steps every rank holding a part bitwise equal to its peers; (c) the
    mesh contigs (names not sorted) polished at tp=2 and sp=2 against one
    rank: FASTA identical or the differing bases, which must lie where
    one rank's top-two logit gap is under the max |d logits|; (d)
    windows/s of each layout's train step and inference beside one
    rank's; (e) the ring's transport per backend and the time of one
    rotation."""
    base = os.path.join(ROOT, "build", "chip_smoke_tp_sp")
    torch.cuda.empty_cache()
    cfg = tp_sp_config(port)
    runs, seconds = {}, {}
    for mode, (ranks, _, _) in TP_SP_RUNS.items():
        t0 = time.perf_counter()
        runs[mode] = run_ranks(mode, ranks, "gloo", os.path.join(base, mode))
        seconds[mode] = time.perf_counter() - t0
        if {r["backend"] for r in runs[mode]} != {"gloo"}:
            fail(f"tp_sp: {mode}'s ranks are not one gloo group: {runs[mode]}")

    # (a) the ring against dense attention, on this card
    q, k, v, ct = (t.requires_grad_(i < 3) for i, t in enumerate(ring_inputs(torch, cfg, dev)))
    dense = port.attention(q, k, v, cfg.num_heads)
    (dense * ct).sum().backward()
    want = {"out": dense.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    ring_rows = {}
    for mode, (_, sp, _) in TP_SP_RUNS.items():
        blocks = [np.load(os.path.join(base, mode, f"ring{sp}_s{s}.npz")) for s in range(sp)]
        row = {}
        for key, ref in want.items():
            got = torch.from_numpy(np.concatenate([b[key] for b in blocks], axis=1)).to(dev)
            tol = RING_FWD_TOL if key == "out" else RING_GRAD_TOL
            row[f"max_abs_err_{key}"] = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, rtol=tol, atol=tol):
                fail(f"tp_sp (a): ring at sp={sp}, {key}: max |d| {row[f'max_abs_err_{key}']}")
        rank0 = runs[mode][0]["ring"]
        ring_rows[f"sp{sp}"] = {**row, "transport": rank0["transport"],
                                "rotation_ms": rank0["rotation_ms"],
                                "rotation_bytes": rank0["rotation_bytes"]}

    # (b) one rank's step at the global batch, the same masks
    full = tp_sp_weights(port, cfg)
    model = port.RokoModel(cfg)
    model.load_state_dict(full, strict=True)
    model.to(dev)
    x, y, w = port.loop.to_device(tp_sp_batch(port.C), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    counts.zero()
    loss, _ = port.loop.grad_step(model, x, y, w, gen)
    one_grads = flat_grads(torch, model)
    sizes = [(n, p.numel()) for n, p in model.named_parameters()]
    gen.manual_seed(SEED)
    one_step_ms = timed_steps(torch, lambda: port.loop.grad_step(model, x, y, w, gen),
                              TP_SP_TIMED_STEPS)
    model.load_state_dict(full, strict=True)  # the ranks' Adam steps, on one rank
    opt = port.loop.make_optimizer(model, TP_SP_LR)
    one_losses = []
    for k in range(TP_SP_ADAM_STEPS):
        gen.manual_seed(SEED + k)
        one_losses.append(port.loop.grad_step(model, x, y, w, gen)[0].item())
        opt.step()
    steps = {}
    for mode, (_, _, layouts) in TP_SP_RUNS.items():
        for name in layouts:
            rows = [r["layouts"][name] for r in runs[mode]]
            got = torch.from_numpy(np.load(os.path.join(base, mode, f"grads_{name}.npy")))
            step = {"loss": rows[0]["losses"][0], "loss_1_rank": loss.item(),
                    **grads_within(torch, f"tp_sp (b) {name} against one rank", got,
                                   one_grads, sizes, scale_of=key_bias_scale(sizes))}
            if abs(step["loss"] - loss.item()) > STEP_RTOL * abs(loss.item()) + 1e-6:
                fail(f"tp_sp (b) {name}: loss {step['loss']}, one rank {loss.item()}")
            if len({tuple(r["losses"]) for r in rows}) != 1:
                fail(f"tp_sp (b) {name}: the ranks' losses differ: {[r['losses'] for r in rows]}")
            for r in rows:  # replicated tensors on every rank, tp parts on their peers
                peer = next(p for p in rows if p["coords"][1] == r["coords"][1])
                for n, sha in r["params_sha256"].items():
                    ref = rows[0] if port.split_axis(n) is None else peer
                    if sha != ref["params_sha256"][n]:
                        fail(f"tp_sp (b) {name}: {n} of rank {r['coords']} differs from "
                             f"{ref['coords']} after {TP_SP_ADAM_STEPS} Adam steps")
            steps[name] = {**step, "losses": rows[0]["losses"], "losses_1_rank": one_losses,
                           "params_bitwise_equal_after_adam": True,
                           "step_ms_by_rank": [r["step_ms"] for r in rows],
                           "windows_per_s": TRAIN_BATCH / (max(r["step_ms"] for r in rows) / 1e3),
                           "windows_per_s_1_rank": TRAIN_BATCH / (one_step_ms / 1e3),
                           "launches_by_rank": [r["launches"] for r in rows]}
    counts.expect("the one-rank transformer steps", {})

    # (c) the mesh contigs at tp=2 and sp=2 against one rank
    infer = port.RokoModel(dataclasses.replace(cfg, dropout=0.0))
    infer.load_state_dict(full, strict=True)
    infer.to(dev).eval()
    contigs, windows = mesh_contigs(port)
    counts.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_polished = port.polish_windows_to_fasta(
        contigs, windows, infer, os.path.join(base, "one_rank.fasta"), device=dev,
        log=lambda s: None)
    torch.cuda.synchronize()
    one_infer_s = time.perf_counter() - t0
    one_logits = all_logits(torch, infer, windows, lambda t: t)
    counts.expect("the one-rank transformer inference", {})
    top2 = np.sort(one_logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    n_windows = MESH_CONTIGS * MESH_CONTIG_WINDOWS
    inference = {}
    for name in TP_SP_INFER_LAYOUTS:
        mode = next(m for m, (_, _, lay) in TP_SP_RUNS.items() if name in lay)
        path = os.path.join(base, mode, f"{name}.fasta")
        got = port.read_fasta(path)
        if [n for n, _ in got] != sorted(contigs):
            fail(f"tp_sp (c) {name}: contigs written as {[n for n, _ in got]}, not sorted")
        logits = np.load(os.path.join(base, mode, f"logits_{name}.npy"))
        delta = float(np.abs(logits - one_logits).max())
        flips = logits.argmax(-1) != one_logits.argmax(-1)
        if (gap[flips] >= delta).any():
            fail(f"tp_sp (c) {name}: an argmax differs where one rank's top-two gap "
                 f"{gap[flips].max()} is not under max |d logits| {delta}")
        differing = fasta_diff(one_polished, dict(got))
        rows = [r["layouts"][name] for r in runs[mode]]
        inference[name] = {
            "identical": dict(got) == one_polished, "differing_bases": differing,
            "max_abs_err_logits": delta, "argmax_flips": int(flips.sum()),
            "order": [n for n, _ in got],
            "windows_per_s": n_windows / max(r["infer_seconds"] for r in rows),
            "windows_per_s_1_rank": n_windows / one_infer_s,
            "launches_by_rank": [r["infer_launches"] for r in rows]}
    return {
        "config": "ModelConfig(kind='transformer', dropout=0.2): 3 layers, d_model 256, "
                  "8 heads, mlp 1024, the published front end; every rank on the one card "
                  "through gloo",
        "seconds_by_run": seconds, "ring": ring_rows, "steps": steps,
        "inference": inference, "contig_order": list(contigs),
        "transport": {"gloo": ring_rows["sp2"]["transport"],
                      "nccl": "direct (CUDA tensors point to point); not run: NCCL refuses "
                              "two ranks on one card"},
        "bars": {"ring_fwd": RING_FWD_TOL, "ring_grad": RING_GRAD_TOL,
                 "step_rtol": STEP_RTOL, "step_atol_of_max": STEP_ATOL_OF_MAX},
        "kernel_launches": 0, "card": card,
    }


def http_json(base: str, path: str, payload=None, timeout: float = 300.0):
    """(status, parsed body, headers) of one request to the service,
    whatever its status."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method="POST" if data else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, body, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, e.read(), e.headers
    try:
        return status, json.loads(body), hdrs
    except ValueError:
        return status, body.decode(errors="replace"), hdrs


def serve_counts(counts, what: str, kernel: str, steps: int, exact: bool = True) -> int:
    """``kernel``'s launches since the last ``counts.zero()``: 3 a device
    step (one a layer; at least that when one coalesced batch may chunk,
    ``exact`` False), and no other kernel launched."""
    got = {name: getattr(w, attr) for name, (w, attr) in counts.wrappers.items()}
    n = got.pop(kernel)
    if any(got.values()) or n % 3 or (n != 3 * steps if exact else n < 3 * steps) or not n:
        fail(f"serve {what}: {kernel} launched {n} times over {steps} steps, others {got}")
    return n


def drive_serve(torch, port, dev, counts, card, rng) -> dict:
    """The polishing service at full width: (a) the ``serve`` command as a
    subprocess with a /profilez trace, (b) the three batchers under the
    bench's closed-loop mix in this process (and a lingru session), (c)
    bf16, (d) the subprocess drained by SIGTERM mid-request, (e) warmup
    and start-to-ready seconds. Every reply is checked byte for byte."""
    import http.client
    import signal
    import tempfile
    import threading

    C, bench = port.C, port.bench
    cfg = port.ModelConfig()
    sd = port.state_dict_from_jax(jax_layout_params(rng, cfg))
    model = port.RokoModel(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(dev).eval()
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    pth = os.path.join(work, "model.pth")
    torch.save(sd, pth)
    contig = "serve"
    draft, positions, examples = synthetic_contig(rng, max(SERVE_SIZES), C)

    def payload(n):
        return {"contig": contig, "draft": draft, "n": n,
                "positions": base64_le(positions[:n]), "examples": base64_le(examples[:n])}

    def staged(m, n):
        """The port's staged stitch of the first n windows on the card."""
        return port.run_inference(iter([([contig] * n, positions[:n], examples[:n])]),
                                  {contig: draft}, m, device=dev, log=lambda s: None)[contig]

    def solo(session, n):
        """The stitch of a solo ``session.predict`` of the first n windows."""
        board = port.VoteBoard({contig: draft})
        board.add([contig] * n, positions[:n], session.predict(examples[:n]))
        return board.stitch(contig)

    out: dict = {"model": {"kind": cfg.kind, "num_layers": cfg.num_layers,
                           "hidden_size": cfg.hidden_size},
                 "card": card}
    want_f32 = {n: staged(model, n) for n in SERVE_SIZES}

    # -- (a) the serve command as a subprocess ------------------------------
    announce = os.path.join(work, "announce.json")
    log_path = os.path.join(work, "serve.log")
    logf = open(log_path, "w")
    t_start = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "roko_tpu_torch", "serve", pth, "--port", "0",
                             "--announce", announce], cwd=ROOT, stdout=logf,
                            stderr=subprocess.STDOUT)

    def log_tail():
        logf.flush()
        with open(log_path) as f:
            return f.read()[-3000:]

    try:
        statuses = []
        while True:
            if proc.poll() is not None:
                fail(f"serve exited with {proc.returncode} before it was ready:\n{log_tail()}")
            if time.perf_counter() - t_start > SERVE_START_TIMEOUT_S:
                fail(f"serve was not ready within {SERVE_START_TIMEOUT_S} s:\n{log_tail()}")
            if os.path.exists(announce):
                with open(announce) as f:
                    base = f"http://127.0.0.1:{json.load(f)['port']}"
                status, body, _ = http_json(base, "/healthz")
                statuses.append(body.get("status"))
                if status == 200 and body.get("status") == "ok":
                    break
                if body.get("status") != "warming":
                    fail(f"serve /healthz said {status} {body} while starting")
            time.sleep(0.05)
        ready_s = time.perf_counter() - t_start
        client = port.PolishClient(base, timeout=300.0)
        sub: dict = {"command": "python -m roko_tpu_torch serve CKPT --port 0 --announce F",
                     "start_to_ready_s": ready_s,
                     "healthz_while_starting": sorted(set(statuses)), "healthz": body}
        for n in SERVE_SIZES:
            t0 = time.perf_counter()
            reply = client.polish(draft, positions[:n], examples[:n], contig=contig)
            sub[f"reply_{n}_s"] = time.perf_counter() - t0
            if reply["polished"] != want_f32[n] or reply["windows"] != n:
                fail(f"serve (a): the {n}-window reply differs from the staged stitch on the "
                     "card")
        # /profilez over requests in flight: its trace must hold gru_fwd
        prof: dict = {}
        prof_thread = threading.Thread(target=lambda: prof.update(
            r=http_json(base, f"/profilez?seconds={SERVE_PROFILE_S}", {})), daemon=True)
        prof_thread.start()
        during, k = 0, 0
        while prof_thread.is_alive():
            n = SERVE_SIZES[k % len(SERVE_SIZES)]
            reply = client.polish(draft, positions[:n], examples[:n], contig=contig)
            if reply["polished"] != want_f32[n]:
                fail(f"serve (a): a {n}-window reply under /profilez differs from the staged "
                     "stitch")
            during, k = during + 1, k + 1
        prof_thread.join()
        status, body, _ = prof["r"]
        if status != 200:
            fail(f"serve /profilez: {status} {body}")
        traced = trace_kernels(body["trace_file"])
        if traced.get("gru_fwd", {}).get("events", 0) == 0:
            fail(f"serve /profilez trace {body['trace_file']} holds no gru_fwd kernel: {traced}")
        shutil.rmtree(body["trace_dir"], ignore_errors=True)
        sub["profilez"] = {"seconds": body["seconds"], "requests_during": during,
                           "port_kernels": traced}
        metrics = port.parse_metric_values(client.metrics(), (
            "roko_serve_requests_total", "roko_serve_batches_total",
            "roko_serve_warmup_seconds", "roko_serve_padding_efficiency",
            "roko_serve_errors_total"))
        sub["metrics"] = metrics
        sub["replies_byte_equal_to_staged_stitch"] = True

        # -- (d) SIGTERM while a 700-window request's body is half sent ----
        body_bytes = json.dumps(payload(SERVE_DRAIN_WINDOWS)).encode()
        host, port_no = base.split("//")[1].split(":")
        conn = http.client.HTTPConnection(host, int(port_no), timeout=300)
        conn.putrequest("POST", "/polish")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(len(body_bytes)))
        conn.endheaders()
        half = len(body_bytes) // 2
        conn.send(body_bytes[:half])
        time.sleep(0.5)  # the handler has passed its draining check and reads the body
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        while True:
            status, health, _ = http_json(base, "/healthz")
            if health.get("status") == "draining":
                break
            if time.perf_counter() - t_term > 10:
                fail(f"serve did not start draining after SIGTERM: {health}")
            time.sleep(0.01)
        late_status, late, late_hdrs = http_json(base, "/polish", payload(7))
        if late_status != 503 or late.get("error") != "server draining" or \
                "Retry-After" not in late_hdrs:
            fail(f"serve (d): a request during the drain got {late_status} {late}")
        conn.send(body_bytes[half:])
        resp = conn.getresponse()
        drained = json.loads(resp.read())
        conn.close()
        if resp.status != 200 or drained.get("polished") != want_f32[SERVE_DRAIN_WINDOWS]:
            fail(f"serve (d): the request in flight at SIGTERM got {resp.status}, not the staged "
                 "stitch")
        deadline_s = port.RokoConfig().resilience.drain_deadline_s
        try:
            rc = proc.wait(timeout=deadline_s + 10)
        except subprocess.TimeoutExpired:
            fail(f"serve did not exit within {deadline_s + 10} s of SIGTERM:\n{log_tail()}")
        exit_s = time.perf_counter() - t_term
        if rc != 0 or exit_s > deadline_s:
            fail(f"serve exited {rc} {exit_s:.1f} s after SIGTERM:\n{log_tail()}")
        logf.flush()
        with open(log_path) as f:
            log = f.read()
        if "drained clean" not in log:
            fail(f"serve's log does not say it drained clean:\n{log[-3000:]}")
        out["subprocess"] = sub
        out["drain"] = {"in_flight_request": 200, "request_during_drain": late_status,
                        "retry_after": late_hdrs.get("Retry-After"), "exit_code": rc,
                        "sigterm_to_exit_s": exit_s, "drain_deadline_s": deadline_s,
                        "log": [ln for ln in log.splitlines() if "roko serve" in ln
                                or ln.startswith("serve:") or ln.startswith("warmup:")]}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()

    # -- (b) the three batchers under the bench's mixed load, in process ---
    mix = bench._parse_mix(SERVE_MIX)
    schedule = bench._mix_schedule(mix, SERVE_REQUESTS)
    sizes = sorted({n for n, _ in mix})

    def closed_loop(session, mode, want, kernel, n_requests=None):
        srv = port.make_server(session, port.ServeConfig(batching=mode,
                                                         max_queue=SERVE_CLIENTS * 2), port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        cl = port.PolishClient(base, timeout=300.0)
        try:
            for n in sizes:  # untimed calibration: one request a size
                if cl.polish(draft, positions[:n], examples[:n], contig=contig)["polished"] \
                        != want[n]:
                    fail(f"serve {mode} {kernel}: a calibration reply differs")
            cal_w, cal_p = srv.metrics.fill_totals()
            steps0 = srv.metrics.counters["batches"]
            work_list = list(schedule if n_requests is None else schedule[:n_requests])
            lat = {n: [] for n in sizes}
            spans = {n: [] for n in sizes}  # the server's own timings of each reply
            bad, errors = [], []
            lock = threading.Lock()

            def one_client():
                while True:
                    with lock:
                        if not work_list:
                            return
                        n = work_list.pop()
                    t0 = time.perf_counter()
                    try:
                        r = cl.polish(draft, positions[:n], examples[:n], contig=contig)
                    except Exception as e:
                        with lock:
                            errors.append(f"{type(e).__name__}: {e}"[:200])
                        continue
                    dt = time.perf_counter() - t0
                    with lock:
                        lat[n].append(dt)
                        spans[n].append({"server_total": r["timings"]["total_s"],
                                         **r["timings"]["spans"]})
                        if r["polished"] != want[n]:
                            bad.append(n)

            n_sched = len(work_list)
            counts.zero()
            threads = [threading.Thread(target=one_client, daemon=True)
                       for _ in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            steps = srv.metrics.counters["batches"] - steps0
            launches = serve_counts(counts, mode, kernel, steps, exact=mode != "deadline")
            if bad or errors:
                fail(f"serve {mode} {kernel}: {len(bad)} replies differ from the solo stitch "
                     f"(sizes {sorted(set(bad))}), {len(errors)} errors {errors[:3]}")
            fill_w, fill_p = srv.metrics.fill_totals()
            row = bench._mixed_latency_row(wall, n_sched, lat)
            # where a request's time goes: its client latency against the
            # server's span sums (the rest is the client's encoding, HTTP
            # and the reply's JSON), medians by size class
            row["server_spans_p50_s"] = {
                str(n): {k: float(np.median([d.get(k, 0.0) for d in v]))
                         for k in ("server_total", "queue_wait", "pack", "device", "scatter",
                                   "stitch")}
                for n, v in spans.items() if v}
            row.update({"padding_efficiency": (fill_w - cal_w) / (fill_p - cal_p),
                        "byte_identical": True, "client_errors": 0, "steps": steps,
                        f"{kernel}_launches": launches,
                        "dispatched_shapes": sorted(session.dispatched_shapes)})
            return row
        finally:
            srv.shutdown()
            srv.batcher.stop()
            srv.server_close()
            thread.join(10.0)

    session = port.PolishSession(model, port.RokoConfig(model=cfg), device=dev)
    session.warmup()
    warm = session.warmup_report.as_dict()
    want = {n: solo(session, n) for n in sizes}
    modes = {mode: closed_loop(session, mode, want, "gru_fwd")
             for mode in ("deadline", "continuous", "ragged")}
    small = str(min(sizes))
    out["load"] = {"mix": SERVE_MIX, "requests": len(schedule), "clients": SERVE_CLIENTS,
                   "ladder": list(session.ladder), "modes": modes,
                   "small_p99_deadline_over_continuous":
                       modes["deadline"]["size_classes"][small]["p99_s"]
                       / modes["continuous"]["size_classes"][small]["p99_s"],
                   "replies_byte_equal_to_solo_predict_stitch": True}
    lin_cfg = port.ModelConfig(kind="lingru")
    lin = port.RokoModel(lin_cfg)
    lin.load_state_dict(port.state_dict_from_jax(jax_layout_params(rng, lin_cfg)), strict=True)
    lin_session = port.PolishSession(lin, port.RokoConfig(model=lin_cfg), device=dev)
    lin_session.warmup()
    out["lingru"] = closed_loop(lin_session, "continuous",
                                {n: solo(lin_session, n) for n in sizes}, "lingru_fwd",
                                SERVE_LINGRU_REQUESTS)

    # -- (c) bf16, continuous, against the bf16 staged stitch ---------------
    bf_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    bf = port.RokoModel(bf_cfg)
    bf.load_state_dict(sd, strict=True)
    bf.to(dev).eval()
    bf_session = port.PolishSession(bf, port.RokoConfig(model=bf_cfg), device=dev)
    bf_session.warmup()
    bf_want = {n: staged(bf, n) for n in sizes}
    out["bf16"] = closed_loop(bf_session, "continuous", bf_want, "gru_fwd_bf16")
    out["bf16"]["replies_byte_equal_to_bf16_staged_stitch"] = True
    out["bf16"]["differs_from_f32_stitch"] = {n: bf_want[n] != want[n] for n in sizes}

    # -- (e) warmup ---------------------------------------------------------
    out["warmup"] = {"in_process_f32": warm, "in_process_bf16": bf_session.warmup_report.as_dict(),
                     "subprocess_warmup_seconds": float(out["subprocess"]["metrics"][
                         "roko_serve_warmup_seconds"]),
                     "subprocess_start_to_ready_s": out["subprocess"]["start_to_ready_s"]}
    out["launches"] = {
        "gru_fwd": sum(r["gru_fwd_launches"] for r in modes.values()),
        "gru_fwd_bf16": out["bf16"]["gru_fwd_bf16_launches"],
        "lingru_fwd": out["lingru"]["lingru_fwd_launches"],
    }
    shutil.rmtree(work, ignore_errors=True)
    return out


def mesh_serve_model(port, dev):
    """The mesh_serve phase's model: full width, gru f32, seed 0's weights."""
    cfg = port.ModelConfig()
    model = port.RokoModel(cfg)
    model.load_state_dict(port.state_dict_from_jax(
        jax_layout_params(np.random.default_rng(SEED), cfg)), strict=True)
    return cfg, model.to(dev).eval()


def mesh_serve_load(port, session, mode: str, inputs: dict, what: str) -> dict:
    """The serve phase's closed-loop mix through ``make_server`` on
    ``session`` under batching ``mode``: every reply must be
    ``inputs["want"]``'s; windows/s, the healthz grid and the steps."""
    import threading

    contig, draft = inputs["contig"], inputs["draft"]
    positions, examples = inputs["positions"], inputs["examples"]
    srv = port.make_server(session, port.ServeConfig(batching=mode,
                                                     max_queue=SERVE_CLIENTS * 2), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    cl = port.PolishClient(base, timeout=300.0)
    try:
        status, health, _ = http_json(base, "/healthz")
        grid = {k: health.get(k) for k in ("status", "mesh_dp", "devices", "ladder")}
        if status != 200 or (grid["mesh_dp"], grid["devices"]) != (session.dp,
                                                                     session.n_devices):
            fail(f"{what} {mode}: /healthz {status} {health}")
        work_list = list(inputs["schedule"])
        windows = sum(work_list)
        bad, errors = [], []
        lock = threading.Lock()

        def one_client():
            while True:
                with lock:
                    if not work_list:
                        return
                    n = work_list.pop()
                try:
                    r = cl.polish(draft, positions[:n], examples[:n], contig=contig)
                except Exception as e:
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}"[:200])
                    continue
                if r["polished"] != inputs["want"][str(n)]:
                    with lock:
                        bad.append(n)

        steps0 = srv.metrics.counters["batches"]
        threads = [threading.Thread(target=one_client, daemon=True)
                   for _ in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if bad or errors:
            fail(f"{what} {mode}: {len(bad)} replies differ from the one-rank stitch "
                 f"(sizes {sorted(set(bad))}), {len(errors)} errors {errors[:3]}")
        return {"requests": len(inputs["schedule"]), "windows": windows, "wall_s": wall,
                "windows_per_s": windows / wall, "healthz": grid,
                "steps": srv.metrics.counters["batches"] - steps0,
                "byte_equal_to_one_rank_stitch": True}
    finally:
        srv.shutdown()
        srv.batcher.stop()
        srv.server_close()
        thread.join(10.0)


def collective_ms(session) -> dict:
    """The leader's host collectives a dispatch: header and scatter, and
    the gather (which waits for the slowest rank's rows)."""
    dispatches = session.dispatches if session.mesh.collective else 0
    n = max(dispatches, 1)
    return {"dispatches": dispatches,
            "send_ms": 1e3 * session.collective_s["send"] / n,
            "gather_ms": 1e3 * session.collective_s["gather"] / n}


def mesh_serve_child(torch, spec) -> None:
    """One rank of the mesh_serve phase: ONE session over the ranks; rank 0
    serves the mix under the continuous and the ragged batcher, then every
    rank runs ``run_streaming_polish`` on a 2-rank session of the stream's
    ladder. Each rank's ``gru_fwd`` launches must be 3 times the
    dispatches it ran. Writes ``rank{r}.json`` beside SPEC."""
    sys.path.insert(0, ROOT)
    from roko_tpu_torch.config import ModelConfig, RokoConfig, ServeConfig, resolve_ladder
    from roko_tpu_torch.infer import tail_rungs, use_float32_matmuls
    from roko_tpu_torch.models import fused_gru as fg
    from roko_tpu_torch.models import fused_lingru as fl
    from roko_tpu_torch.models.convert import state_dict_from_jax
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.parallel import distributed
    from roko_tpu_torch.parallel.mesh import make_mesh
    from roko_tpu_torch.pipeline import run_streaming_polish
    from roko_tpu_torch.serve.client import PolishClient
    from roko_tpu_torch.serve.server import make_server
    from roko_tpu_torch.serve.session import PolishSession

    port = types.SimpleNamespace(ModelConfig=ModelConfig, RokoModel=RokoModel,
                                 state_dict_from_jax=state_dict_from_jax,
                                 make_server=make_server, ServeConfig=ServeConfig,
                                 PolishClient=PolishClient)
    counts = Counts(fg, fl)
    use_float32_matmuls()
    distributed.initialize(device="cuda", backend=spec["backend"])
    dev = distributed.device_of_rank("cuda")
    mesh = make_mesh()
    rank = mesh.rank
    what = f"mesh_serve rank {rank}"
    folder = os.path.join(os.path.dirname(spec["dir"]), "inputs")
    with open(os.path.join(folder, "inputs.json")) as f:
        inputs = json.load(f)
    arrays = np.load(os.path.join(folder, "windows.npz"))
    inputs.update(positions=arrays["positions"], examples=arrays["examples"])
    cfg, model = mesh_serve_model(port, dev)
    rcfg = RokoConfig(model=cfg)
    out = {"rank": rank, "world": distributed.world_size(), "backend": distributed.backend(),
           "device": str(dev)}

    # the serve session: its auto ladder, warmed by rank 0's rungs
    session = PolishSession(model, rcfg, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    session.warmup()
    if session.leader:
        session.stop()
    else:
        session.follow()
    out["warmup_s"] = time.perf_counter() - t0
    out["ladder"] = list(session.ladder)
    # from here on, the served dispatches only
    session.collective_s = {"send": 0.0, "gather": 0.0}
    session.dispatches = 0
    counts.zero()
    if session.leader:
        out["serve"] = {mode: mesh_serve_load(port, session, mode, inputs, what)
                        for mode in ("continuous", "ragged")}
        out["serve_collectives"] = collective_ms(session)
        session.stop()
    else:
        session.follow()
    out["serve_dispatches"] = session.dispatches
    out["serve_launches"] = serve_counts(counts, f"{what} serve", "gru_fwd",
                                         out["serve_dispatches"])

    # the stream on a 2-rank session of the stream's ladder
    stream_session = PolishSession(
        model, rcfg, device=dev, mesh=mesh,
        ladder=tail_rungs(resolve_ladder(rcfg.serve, mesh.dp), MESH_SERVE_BATCH, mesh.dp))
    fasta = os.path.join(spec["dir"], "stream.fasta")
    counts.zero()
    t0 = time.perf_counter()
    run_streaming_polish(inputs["project"]["draft_fasta"], inputs["project"]["reads_bam"],
                         model, rcfg, out_path=fasta, workers=POLISH_WORKERS, seed=0,
                         batch_size=MESH_SERVE_BATCH, device=dev, session=stream_session,
                         mesh=mesh, log=lambda s: None)
    if stream_session.leader:
        stream_session.stop()
    out["stream"] = {"seconds": time.perf_counter() - t0, "ladder": list(stream_session.ladder),
                     "dispatches": stream_session.dispatches,
                     "launches": serve_counts(counts, f"{what} stream", "gru_fwd",
                                              stream_session.dispatches)}
    if stream_session.leader:
        out["stream"]["collectives"] = collective_ms(stream_session)
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()


def drive_mesh_serve(torch, port, dev, counts, card) -> dict:
    """The mesh_serve phase (see the module docstring): the one-rank
    references in this process, then two gloo ranks sharing the card."""
    base = os.path.join(ROOT, "build", "chip_smoke_mesh_serve")
    folder = os.path.join(base, "inputs")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(folder)
    t_phase = time.perf_counter()
    cfg, model = mesh_serve_model(port, dev)
    rcfg = port.RokoConfig(model=cfg)
    contig = "mesh_serve"
    mix = port.bench._parse_mix(SERVE_MIX)
    schedule = [int(n) for n in port.bench._mix_schedule(mix, SERVE_REQUESTS)]
    sizes = sorted({n for n, _ in mix})
    draft, positions, examples = synthetic_contig(np.random.default_rng(SEED + 26),
                                                  max(sizes), port.C)
    one = port.PolishSession(model, rcfg, device=dev)
    one.warmup()
    want = {}
    for n in sizes:
        board = port.VoteBoard({contig: draft})
        board.add([contig] * n, positions[:n], one.predict(examples[:n]))
        want[str(n)] = board.stitch(contig)
        staged = port.run_inference(iter([([contig] * n, positions[:n], examples[:n])]),
                                    {contig: draft}, model, device=dev,
                                    log=lambda s: None)[contig]
        if staged != want[str(n)]:
            fail(f"mesh_serve: the one-rank solo stitch of {n} windows is not the staged one")
    inputs = {"contig": contig, "draft": draft, "schedule": schedule, "want": want,
              "positions": positions, "examples": examples}
    counts.zero()
    one_serve = mesh_serve_load(port, one, "continuous", inputs, "mesh_serve dp 1")
    one_serve["launches"] = serve_counts(counts, "mesh_serve dp 1", "gru_fwd",
                                         one_serve["steps"])
    project = small_project(port, os.path.join(base, "project"))
    one_fasta = os.path.join(base, "one_rank.fasta")
    metrics = port.ServeMetrics()
    counts.zero()
    t0 = time.perf_counter()
    port.run_streaming_polish(project["paths"]["draft_fasta"], project["paths"]["reads_bam"],
                              model, rcfg, out_path=one_fasta, workers=POLISH_WORKERS, seed=0,
                              batch_size=MESH_SERVE_BATCH, device=dev, metrics=metrics,
                              log=lambda s: None)
    one_stream = {"seconds": time.perf_counter() - t0, "steps": metrics.counters["batches"]}
    one_stream["launches"] = serve_counts(counts, "mesh_serve dp 1 stream", "gru_fwd",
                                          one_stream["steps"])
    np.savez(os.path.join(folder, "windows.npz"), positions=positions, examples=examples)
    with open(os.path.join(folder, "inputs.json"), "w") as f:
        json.dump({"contig": contig, "draft": draft, "schedule": schedule, "want": want,
                   "project": project["paths"]}, f)
    del one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks

    t0 = time.perf_counter()
    ranks = run_ranks("mesh_serve", MESH_SERVE_RANKS, "gloo", os.path.join(base, "ranks"))
    ranks_s = time.perf_counter() - t0
    if {r["backend"] for r in ranks} != {"gloo"} or [r["world"] for r in ranks] != [2, 2]:
        fail(f"mesh_serve: ranks not in one gloo group of 2: {ranks}")
    with open(one_fasta, "rb") as f:
        want_fasta = f.read()
    with open(os.path.join(base, "ranks", "stream.fasta"), "rb") as f:
        got_fasta = f.read()
    if got_fasta != want_fasta:
        fail(f"mesh_serve: the 2-rank stream's FASTA ({len(got_fasta)} bytes) is not the "
             f"one-rank stream's ({len(want_fasta)} bytes)")
    lead = ranks[0]
    stream_windows = project["windows"]
    return {
        "config": "ModelConfig() (gru f32, 3 layers, hidden 128, full width), seed 0",
        "ranks": MESH_SERVE_RANKS, "backend": "gloo, two ranks sharing one card",
        "ladder_dp2": lead["ladder"], "mix": SERVE_MIX, "requests": len(schedule),
        "clients": SERVE_CLIENTS,
        "windows_per_s": {
            "serve_continuous_dp1": one_serve["windows_per_s"],
            "serve_continuous_dp2": lead["serve"]["continuous"]["windows_per_s"],
            "serve_ragged_dp2": lead["serve"]["ragged"]["windows_per_s"],
            "stream_dp1": stream_windows / one_stream["seconds"],
            "stream_dp2": stream_windows / lead["stream"]["seconds"]},
        "note": "dp 2 is two ranks sharing one card: it measures sharing, not scaling",
        "host_collectives_ms_per_dispatch": {"serve": lead["serve_collectives"],
                                             "stream": lead["stream"]["collectives"]},
        "serve_dp1": one_serve, "serve_dp2": lead["serve"],
        "stream": {"windows": stream_windows, "batch": MESH_SERVE_BATCH,
                   "fasta_bytes": len(got_fasta), "byte_identical_to_one_rank": True,
                   "dp1": one_stream, "dp2_by_rank": [r["stream"] for r in ranks]},
        "launches_by_rank": [{"serve": r["serve_launches"],
                              "serve_dispatches": r["serve_dispatches"],
                              "stream": r["stream"]["launches"],
                              "stream_dispatches": r["stream"]["dispatches"]} for r in ranks],
        "warmup_s_by_rank": [r["warmup_s"] for r in ranks],
        "ranks_seconds": ranks_s, "seconds": time.perf_counter() - t_phase, "card": card,
    }


def drive_coldstart(port, card) -> dict:
    """The bench's coldstart suite at full width on the card; fails unless
    the cold starts ran nvcc, the warm-cache and bundle starts ran none,
    and every start launched ``gru_fwd`` only."""
    t0 = time.perf_counter()
    res = port.bench.run_coldstart_suite(COLDSTART_LADDER, device="cuda")
    res["seconds"] = time.perf_counter() - t0
    for mode in ("cold", "cold_parallel"):
        if res[mode]["compile_cache_misses"] < 1:
            fail(f"coldstart {mode}: no nvcc ran in an empty build directory: {res[mode]}")
    for mode in ("warm_cache", "aot"):
        if res[mode]["compile_cache_misses"] != 0:
            fail(f"coldstart {mode}: {res[mode]['compile_cache_misses']} kernel(s) built with "
                 "nvcc; the build cache or the bundle should have carried them")
    if res["aot"]["warmup"]["mode"] != "aot":
        fail(f"coldstart aot warmed in mode {res['aot']['warmup']['mode']}")
    for mode in ("cold", "cold_parallel", "warm_cache", "aot"):
        got = dict(res[mode]["launches"])
        if got.pop("gru_fwd") < 3 or any(got.values()):
            fail(f"coldstart {mode}: kernel launches {res[mode]['launches']}")
    res["launches"] = {"gru_fwd": sum(res[m]["launches"]["gru_fwd"]
                                      for m in ("cold", "cold_parallel", "warm_cache", "aot"))}
    res["card"] = card
    return res


def drive_fleet(torch, port, dev, card, job_inputs=None) -> dict:
    """The single-host fleet at full width (gru, 3 bidirectional layers,
    h=128, f32): bundles and the registry, the refusals, a 2-worker fleet
    on the card, failover, a rollout and the drain. Every reply is held
    byte for byte against the staged stitch of the version that served it.
    With ``job_inputs`` (a project in the polish phase's ``_stream_inputs``
    layout), a distributed polish job is posted to the supervisor before
    the drain (``out["distpolish"]``, :func:`run_job`)."""
    import signal
    import tempfile
    import threading

    C = port.C
    cfg = port.ModelConfig()
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    reg = os.path.join(work, "registry")
    contig = "fleet"
    rng = np.random.default_rng(SEED + 23)
    draft, positions, examples = synthetic_contig(rng, max(FLEET_SIZES), C)
    want: dict = {}
    ckpt: dict = {}
    sds: dict = {}
    for v, seed in (("v1", SEED + 24), ("v2", SEED + 25)):
        sd = sds[v] = port.state_dict_from_jax(jax_layout_params(np.random.default_rng(seed),
                                                                 cfg))
        ckpt[v] = os.path.join(work, f"{v}.pth")
        torch.save(sd, ckpt[v])
        model = port.RokoModel(cfg)
        model.load_state_dict(sd, strict=True)
        model.to(dev).eval()
        want[v] = {n: port.run_inference(
            iter([([contig] * n, positions[:n], examples[:n])]), {contig: draft}, model,
            device=dev, log=lambda m: None)[contig] for n in FLEET_SIZES}
        del model
    if want["v1"] == want["v2"]:
        fail("fleet: v1 and v2 give the same stitches; the rollout could not be told apart")
    py = [sys.executable, "-m", "roko_tpu_torch"]
    env = dict(os.environ, ROKO_REGISTRY=reg)
    out: dict = {"model": {"kind": cfg.kind, "num_layers": cfg.num_layers,
                           "hidden_size": cfg.hidden_size}, "card": card}

    def start(argvs):
        """Start the commands at once (each process spends most of its
        start reaching the card)."""
        return [(argv, time.perf_counter(), subprocess.Popen(
            py + argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)) for argv in argvs]

    def wait_all(started):
        """[(CompletedProcess, seconds from its start)] in order."""
        out = []
        for argv, t0, proc in started:
            try:
                stdout, stderr = proc.communicate(timeout=FLEET_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for _, _, p in started:
                    p.kill()
                fail(f"fleet: {argv[:2]} did not end within {FLEET_TIMEOUT_S} s")
            out.append((subprocess.CompletedProcess(argv, proc.returncode, stdout, stderr),
                        time.perf_counter() - t0))
        return out

    # -- compile: bundles v1 and v2 at once, v1 checked in a fresh process,
    # both registered with their weights
    bundles = {v: os.path.join(work, f"bundle_{v}") for v in ("v1", "v2")}
    compiling = start([["compile", bundles[v], "--register", v, "--params", ckpt[v],
                        "--registry", reg] + (["--no-verify"] if v == "v2" else [])
                       for v in ("v1", "v2")])
    # -- a bundle that does not match is refused, naming the field: these
    # need v1's manifest only, so they start while v1's fresh-process
    # check runs (a failed check fails the compile below)
    lin_cfg = port.ModelConfig(kind="lingru")
    lin_pth = os.path.join(work, "lingru.pth")
    torch.save(port.state_dict_from_jax(jax_layout_params(np.random.default_rng(SEED + 26),
                                                          lin_cfg)), lin_pth)
    man_v1 = os.path.join(bundles["v1"], "manifest.json")
    while not os.path.exists(man_v1) and compiling[0][2].poll() is None:
        time.sleep(0.1)
    if not os.path.exists(man_v1):
        r, _ = wait_all(compiling)[0]
        fail(f"fleet: compile v1 exited {r.returncode} without a manifest:\n"
             f"{(r.stdout + r.stderr)[-3000:]}")
    edited = os.path.join(work, "bundle_v1_edited")
    shutil.copytree(bundles["v1"], edited)
    man_path = os.path.join(edited, "manifest.json")
    man = json.load(open(man_path))
    man["identity"]["device_kind"] += " (edited)"
    json.dump(man, open(man_path, "w"))
    cases = (("lingru_config", ["serve", lin_pth, "--model-kind", "lingru", "--bundle",
                                bundles["v1"]], "model.kind"),
             ("edited_device_kind", ["serve", ckpt["v1"], "--bundle", edited], "device_kind"))
    refusing = start([argv + ["--port", "0"] for _, argv, _ in cases])
    for v, (r, secs) in zip(("v1", "v2"), wait_all(compiling)):
        if r.returncode != 0:
            fail(f"fleet: compile {v} exited {r.returncode}:\n{(r.stdout + r.stderr)[-3000:]}")
        manifest = json.load(open(os.path.join(bundles[v], "manifest.json")))
        out[f"compile_{v}"] = {"seconds": secs, "digest": manifest["digest"],
                               "libraries": manifest["libraries"], "rungs": manifest["rungs"],
                               "rung_seconds": manifest["rung_seconds"],
                               "verified": "(fresh process)" in r.stdout}
        if list(manifest["libraries"]) != ["gru_fwd"] or \
                out[f"compile_{v}"]["verified"] != (v == "v1"):
            fail(f"fleet: bundle {v} holds {list(manifest['libraries'])}, verified "
                 f"{out[f'compile_{v}']['verified']}")
    if out["compile_v1"]["digest"] != out["compile_v2"]["digest"]:
        fail("fleet: two bundles of one config and card have different digests")

    refusals = {}
    for (what, argv, field), (r, secs) in zip(cases, wait_all(refusing)):
        text = r.stdout + r.stderr
        named = "BundleMismatch" in text and f"{field}:" in text
        refusals[what] = {"rc": r.returncode, "names": field, "named": named, "seconds": secs}
        if r.returncode == 0 or not named:
            fail(f"fleet: serve with {what} exited {r.returncode}, naming {field} {named}:\n"
                 f"{text[-2000:]}")
    out["refusals"] = refusals

    # -- the fleet: supervisor + 2 workers sharing the card ----------------
    runtime = os.path.join(work, "runtime")
    cfg_path = os.path.join(work, "fleet.json")
    rcfg = port.RokoConfig()
    # the distributed polish job's units: one region each
    rcfg = dataclasses.replace(
        rcfg, fleet=dataclasses.replace(rcfg.fleet, runtime_dir=runtime),
        distpolish=port.DistPolishConfig(unit_bases=DIST_UNIT_BASES, inflight_per_worker=1,
                                         park_poll_s=0.05))
    job_want = (single_process_polish(torch, port, sds["v2"], rcfg, job_inputs, dev)
                if job_inputs is not None else None)
    with open(cfg_path, "w") as f:
        f.write(rcfg.to_json())
    announce = os.path.join(work, "front.json")
    launches_prefix = os.path.join(work, "launches")
    fenv = dict(env, ROKO_COMPILE_CACHE="off", ROKO_KERNEL_LAUNCHES=launches_prefix)
    log_path = os.path.join(work, "supervisor.log")
    logf = open(log_path, "w")
    t_start = time.perf_counter()
    sup = subprocess.Popen(py + ["serve", ckpt["v1"], "--workers", "2", "--devices-per-worker",
                                 "0", "--bundle", bundles["v1"], "--registry", reg,
                                 "--config", cfg_path, "--port", "0", "--announce", announce,
                                 "--heartbeat-interval", "0.5", "--bake-s", str(FLEET_BAKE_S)],
                           cwd=ROOT, env=fenv, stdout=logf, stderr=subprocess.STDOUT,
                           start_new_session=True)
    # the supervisor leads a process group of its own: its workers are in
    # it, so whatever fails below, no process of the fleet outlives the
    # phase
    roll = None
    poll_errors = []
    poll_max_s = [0.0]

    def poll(path):
        """(status, body) of a status endpoint; a connection that fails or
        times out is counted (the clients' requests carry their own
        retries and are held to 0 failures) and answers (None, {})."""
        t0 = time.perf_counter()
        try:
            status, body, _ = http_json(base, path, timeout=10)
        except OSError as e:
            poll_errors.append(f"{path}: {type(e).__name__}: {e}"[:200])
            return None, {}
        finally:
            poll_max_s[0] = max(poll_max_s[0], time.perf_counter() - t0)
        return status, body if isinstance(body, dict) else {}

    def log_tail():
        logf.flush()
        with open(log_path) as f:
            return f.read()[-4000:]

    def worker_pids():
        pids = {}
        for wid in (0, 1):
            try:
                with open(os.path.join(runtime, f"worker-{wid}.announce.json")) as f:
                    pids[wid] = json.load(f)["pid"]
            except (OSError, ValueError, KeyError):
                pass
        return pids

    all_pids: set = set()
    try:
        while True:
            if sup.poll() is not None:
                fail(f"fleet: the supervisor exited {sup.returncode}:\n{log_tail()}")
            if time.perf_counter() - t_start > FLEET_TIMEOUT_S:
                fail(f"fleet: not ready within {FLEET_TIMEOUT_S} s:\n{log_tail()}")
            if os.path.exists(announce):
                base = f"http://127.0.0.1:{json.load(open(announce))['port']}"
                status, health = poll("/healthz")
                if status == 200 and health.get("status") == "ok":
                    break
            time.sleep(0.1)
        out["ready_s"] = time.perf_counter() - t_start
        all_pids |= set(worker_pids().values())
        client = port.PolishClient(base, timeout=300.0)
        replies = {}
        for n in FLEET_SIZES:
            t0 = time.perf_counter()
            reply = client.polish(draft, positions[:n], examples[:n], contig=contig, retries=8)
            replies[n] = time.perf_counter() - t0
            if reply["polished"] != want["v1"][n] or reply["windows"] != n:
                fail(f"fleet: the {n}-window reply differs from v1's staged stitch")
        out["reply_s"] = replies
        metrics_text = client.metrics()
        misses = re.findall(r'^roko_compile_cache_misses\{worker="(\d+)"\} (\S+)$',
                            metrics_text, re.M)
        if sorted(w for w, _ in misses) != ["0", "1"] or any(float(v) for _, v in misses):
            fail(f"fleet: workers' roko_compile_cache_misses {misses}; a worker loaded from "
                 "a bundle must run no nvcc")
        out["compile_cache_misses_by_worker"] = {w: float(v) for w, v in misses}

        def load(seconds, stop=None, allowed=("v1",)):
            """Closed-loop clients until ``seconds`` pass (or ``stop`` is
            set); every reply must be one allowed version's stitch."""
            got, errors, which = [], [], []
            lock = threading.Lock()
            t_end = time.perf_counter() + seconds

            def one(k):
                c = port.PolishClient(base, timeout=300.0)
                i = k
                while (stop is None and time.perf_counter() < t_end) or \
                        (stop is not None and not stop.is_set()):
                    n = FLEET_SIZES[i % 2]  # 7 and 300 windows
                    i += 1
                    t0 = time.perf_counter()
                    try:
                        r = c.polish(draft, positions[:n], examples[:n], contig=contig,
                                     retries=8)
                    except Exception as e:
                        with lock:
                            errors.append(f"{type(e).__name__}: {e}"[:300])
                        continue
                    v = next((v for v in allowed if r["polished"] == want[v][n]), None)
                    with lock:
                        got.append(time.perf_counter() - t0)
                        which.append(v)
                        if v is None:
                            errors.append(f"a {n}-window reply matches none of {allowed}")

            threads = [threading.Thread(target=one, args=(k,), daemon=True)
                       for k in range(FLEET_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            return threads, got, errors, which, t0

        def finish(threads, got, errors, which, t0, what):
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            if errors:
                fail(f"fleet {what}: {len(errors)} failed request(s): {errors[:5]}")
            return {"requests": len(got), "req_per_s": len(got) / wall, "wall_s": wall,
                    "p50_s": float(np.percentile(got, 50)) if got else None,
                    "p99_s": float(np.percentile(got, 99)) if got else None,
                    "versions": {v: which.count(v) for v in set(which)}}

        out["load"] = finish(*load(FLEET_LOAD_S), "load")

        # -- failover: SIGKILL worker 0 under load --------------------------
        pids = worker_pids()
        stop = threading.Event()
        handle = load(0, stop)
        time.sleep(1.0)
        os.kill(pids[0], signal.SIGKILL)
        t_kill = time.perf_counter()
        time.sleep(4.0)
        stop.set()
        out["failover"] = finish(*handle, "failover")
        while True:
            status, health = poll("/healthz")
            w0 = health.get("workers", {}).get("0", {})
            if status == 200 and health.get("workers_up") == 2 and w0.get("restarts", 0) >= 1:
                break
            if time.perf_counter() - t_kill > FLEET_TIMEOUT_S:
                fail(f"fleet: worker 0 did not rejoin after SIGKILL: {health}\n{log_tail()}")
            time.sleep(0.2)
        out["failover"]["rejoin_s"] = time.perf_counter() - t_kill
        out["failover"]["killed_pid"] = pids[0]
        all_pids |= set(worker_pids().values())

        # -- rollout v2 under load --------------------------------------------
        stop = threading.Event()
        handle = load(0, stop, allowed=("v1", "v2"))
        t_roll = time.perf_counter()
        roll = subprocess.Popen(py + ["rollout", "v2", "--url", base, "--timeout",
                                      str(FLEET_TIMEOUT_S), "--poll-s", "0.2"],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        done_at, seen = {}, set()
        while roll.poll() is None:
            if time.perf_counter() - t_roll > FLEET_TIMEOUT_S + 60:
                fail(f"fleet: the rollout command did not end:\n{log_tail()}")
            _, st = poll("/rollout")
            for w in st.get("workers_done", []):
                if w not in seen:
                    seen.add(w)
                    done_at[w] = time.perf_counter() - t_roll
            all_pids |= set(worker_pids().values())
            time.sleep(0.1)
        t_cmd_end = time.perf_counter()
        roll_out = roll.stdout.read()
        stop.set()
        during = finish(*handle, "rollout")
        if roll.returncode != 0:
            fail(f"fleet: rollout v2 exited {roll.returncode}:\n{roll_out}\n{log_tail()}")
        st = {}
        while not st:
            _, st = poll("/rollout")
        after = finish(*load(2.0, allowed=("v2",)), "after the rollout")
        times = [done_at[w] for w in sorted(done_at, key=done_at.get)]
        out["rollout"] = {"seconds": time.perf_counter() - t_roll - after["wall_s"],
                          "command_s": t_cmd_end - t_roll,
                          "worker_done_s": times,
                          "seconds_per_worker": [b - a for a, b in zip([0.0] + times, times)],
                          "state": st.get("state"), "worker_versions": st.get("worker_versions"),
                          "during": during, "after": after, "log": roll_out.splitlines()[-4:]}
        if st.get("state") != "done" or set(st.get("worker_versions", {}).values()) != {"v2"}:
            fail(f"fleet: rollout ended {st}")
        all_pids |= set(worker_pids().values())

        # -- a distributed polish job over the fleet (POST /job) -------------
        if job_inputs is not None:
            job_out = os.path.join(work, "distributed.fasta")
            jpaths = job_inputs["paths"]
            # the workers are idle: their launch files are the job's zero
            before_job = launch_reports(work)
            status, body, _ = http_json(base, "/job", {
                "ref": jpaths["draft_fasta"], "bam": jpaths["reads_bam"], "out": job_out,
                "seed": 0}, timeout=30)
            if status != 202:
                fail(f"distpolish: POST /job answered {status}: {body}\n{log_tail()}")

            def wait_done():
                t0 = time.perf_counter()
                while True:
                    _, snap = poll("/jobz")
                    if snap.get("state") in ("done", "failed"):
                        return snap
                    if time.perf_counter() - t0 > 2 * FLEET_TIMEOUT_S:
                        fail(f"distpolish: the job did not end: {snap}\n{log_tail()}")
                    all_pids.update(worker_pids().values())
                    time.sleep(0.1)

            out["distpolish"] = run_job(base, sup.pid, runtime, job_inputs, job_out, job_want,
                                        lambda b, path: poll(path), wait_done,
                                        lambda: launch_reports(work), before_job,
                                        cfg.num_layers)
            all_pids |= set(worker_pids().values())
            # the restarted worker back in rotation before the drain
            t_back = time.perf_counter()
            while True:
                status, health = poll("/healthz")
                if status == 200 and health.get("workers_up") == 2:
                    break
                if time.perf_counter() - t_back > FLEET_TIMEOUT_S:
                    fail(f"distpolish: the killed worker did not rejoin: {health}")
                time.sleep(0.2)
            out["distpolish"]["worker_rejoin_s"] = time.perf_counter() - t_back
            all_pids |= set(worker_pids().values())

        # -- drain: SIGTERM the supervisor ---------------------------------------
        t_term = time.perf_counter()
        sup.send_signal(signal.SIGTERM)
        try:
            rc = sup.wait(FLEET_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"fleet: the supervisor did not exit within {FLEET_TIMEOUT_S} s of SIGTERM")
        left = sorted(p for p in all_pids if pid_alive(p))
        try:
            os.killpg(sup.pid, 0)
            group_left = True
        except ProcessLookupError:
            group_left = False
        out["drain"] = {"rc": rc, "seconds": time.perf_counter() - t_term,
                        "workers_seen": sorted(all_pids), "workers_left": left,
                        "process_group_left": group_left}
        out["status_poll_errors"] = poll_errors
        out["status_poll_max_s"] = poll_max_s[0]
        if rc != 0 or left or group_left:
            fail(f"fleet: SIGTERM drain exited {rc}, worker processes left {left}:\n"
                 f"{log_tail()}")
    finally:
        if roll is not None and roll.poll() is None:
            roll.kill()
            roll.wait()
        if sup.poll() is None:  # a failure above: drain, then kill the group
            sup.send_signal(signal.SIGTERM)
            try:
                sup.wait(60)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(sup.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if sup.poll() is None:
            sup.wait()
        for pid in all_pids:
            if pid_alive(pid):
                os.kill(pid, signal.SIGKILL)
        logf.close()
    # every worker's launch file: the last one each wrote (at its exit, or
    # at its last answered request for a SIGKILLed one)
    reports = launch_reports(work)
    launches = {"gru_fwd": 0, "gru_fwd_bf16": 0, "lingru_fwd": 0, "lingru_fwd_bf16": 0}
    for r in reports.values():
        for k, v in r["launches"].items():
            launches[k] += v
    total = launches.pop("gru_fwd")
    if not reports or total < 3 * len(reports) or any(launches.values()):
        fail(f"fleet: the workers' kernel launches {launches} from {len(reports)} file(s)")
    # the job's launches are the distpolish path's, the rest the fleet's
    job = out["distpolish"]["launches"]["gru_fwd"] if job_inputs is not None else 0
    out["launches"] = {"gru_fwd": total - job, "workers_reporting": len(reports)}
    shutil.rmtree(work, ignore_errors=True)
    return out


def pid_alive(pid: int) -> bool:
    """True while process ``pid`` runs (a zombie does not)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def wait_contexts(n: int, what: str, timeout: float = 30.0) -> float:
    """Seconds until the card holds ``n`` contexts (``nvidia-smi``'s
    compute apps: its pids may all read 1 from another pid namespace, so
    the contexts are counted, not matched)."""
    t0 = time.perf_counter()
    while len(nvidia_apps()) != n:
        if time.perf_counter() - t0 > timeout:
            fail(f"{what}: {len(nvidia_apps())} contexts on the card, expected {n}")
        time.sleep(0.2)
    return time.perf_counter() - t0


def rank_checks(what: str, reports: dict, layers: int) -> list:
    """Each serve process's launch file: ``gru_fwd`` ``layers`` times the
    dispatches it ran its rows of, no other kernel."""
    rows = []
    for pid, r in sorted(reports.items()):
        got = r["launches"]
        if got["gru_fwd"] != layers * r["dispatches"] or \
                any(v for k, v in got.items() if k != "gru_fwd"):
            fail(f"{what}: process {pid} (rank {r.get('rank')}) launched {got} over "
                 f"{r['dispatches']} dispatches")
        rows.append({"pid": pid, "worker": r.get("worker"), "rank": r.get("rank"),
                     "backend": r.get("backend"),
                     "gru_fwd": got["gru_fwd"], "dispatches": r["dispatches"],
                     "requests": r["served"]["requests"]})
    return rows


def drive_fleet_mesh(torch, port, dev, card) -> dict:
    """A fleet worker's session over its card slice at full width (gru, 3
    bidirectional layers, h=128, f32, weights from a numpy seed through
    the weights bridge): ``serve --workers 1 --dp 2`` as a subprocess on
    shared cards, so the supervisor starts the worker as two ranks on the
    one card, which choose gloo themselves (``distributed.choose_backend``;
    each rank's launch file says so). Every reply equals the staged
    stitch and a one-rank session's server in this process (a one-rank
    worker's code); each rank's ``gru_fwd`` is 3 times its dispatches;
    ``gru_fwd`` is held against the plain loop at each rank's rungs. The
    follower is SIGKILLed: the worker restarts both ranks once (one
    death), the card's context count comes back to what it was (no rank
    of the old incarnation left), and the replies are equal again. SIGTERM
    drains the supervisor to exit 0 with no rank and no context left. Two
    ranks on one card measure sharing, not scaling."""
    import signal
    import tempfile
    import threading

    t_phase = time.perf_counter()
    C = port.C
    cfg = port.ModelConfig()
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_mesh_")
    contig = "fleet_mesh"
    draft, positions, examples = synthetic_contig(np.random.default_rng(SEED + 27),
                                                  max(FLEET_SIZES), C)
    sd = port.state_dict_from_jax(jax_layout_params(np.random.default_rng(SEED + 28), cfg))
    ckpt = os.path.join(work, "model.pth")
    torch.save(sd, ckpt)
    model = port.RokoModel(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(dev).eval()
    want = {n: port.run_inference(iter([([contig] * n, positions[:n], examples[:n])]),
                                  {contig: draft}, model, device=dev, log=lambda m: None)[contig]
            for n in FLEET_SIZES}
    # a one-rank worker's code: the session and server a worker runs
    rcfg = port.RokoConfig(model=cfg)
    session = port.PolishSession(model, rcfg, device=dev)
    session.warmup()
    srv = port.make_server(session, rcfg.serve, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        client = port.PolishClient(f"http://127.0.0.1:{srv.server_address[1]}", timeout=300.0)
        one_rank = {n: client.polish(draft, positions[:n], examples[:n], contig=contig,
                                     retries=8)["polished"] for n in FLEET_SIZES}
    finally:
        srv.shutdown()
        srv.batcher.stop()
        srv.server_close()
        thread.join(10)
    if one_rank != want:
        fail("fleet_mesh: a one-rank session's replies differ from the staged stitch")
    del session, srv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    per_rank = [r // FLEET_MESH_RANKS
                for r in port.resolve_ladder(rcfg.serve, FLEET_MESH_RANKS)]
    rungs = [check_kernel(torch, port.fg, dict(MAIN_SHAPE, B=b), dev,
                          np.random.default_rng(SEED + 29), timed=False) for b in per_rank]

    runtime = os.path.join(work, "runtime")
    cfg_path = os.path.join(work, "fleet.json")
    with open(cfg_path, "w") as f:
        f.write(dataclasses.replace(rcfg, fleet=dataclasses.replace(
            rcfg.fleet, runtime_dir=runtime)).to_json())
    announce = os.path.join(work, "front.json")
    log_path = os.path.join(work, "supervisor.log")
    env = dict(os.environ, ROKO_KERNEL_LAUNCHES=os.path.join(work, "launches"))
    logf = open(log_path, "w")
    apps_before = len(nvidia_apps())
    t_start = time.perf_counter()
    sup = subprocess.Popen([sys.executable, "-m", "roko_tpu_torch", "serve", ckpt,
                            "--workers", "1", "--devices-per-worker", "0",
                            "--dp", str(FLEET_MESH_RANKS), "--config", cfg_path,
                            "--port", "0", "--announce", announce,
                            "--heartbeat-interval", "0.5"],
                           cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT,
                           start_new_session=True)
    out: dict = {"model": {"kind": cfg.kind, "num_layers": cfg.num_layers,
                           "hidden_size": cfg.hidden_size}, "ranks": FLEET_MESH_RANKS,
                 "note": "two ranks on one card measure sharing, not scaling", "card": card}
    seen: set = set()

    def log_tail():
        logf.flush()
        with open(log_path) as fh:
            sup_log = fh.read()[-3000:]
        try:
            with open(os.path.join(runtime, "worker-0.log")) as fh:
                return sup_log + "\n--- worker 0 ---\n" + fh.read()[-4000:]
        except OSError:
            return sup_log

    def worker0():
        try:
            status, health, _ = http_json(base, "/healthz", timeout=10)
        except OSError:
            return None, {}
        w = health.get("workers", {}).get("0", {}) if isinstance(health, dict) else {}
        return status, w

    def incarnation(what):
        """{rank: pid} of the worker's ranks not seen before, from the
        launch files they write at their warmup's end."""
        t0 = time.perf_counter()
        while True:
            got = {r["rank"]: pid for pid, r in launch_reports(work).items()
                   if pid not in seen and r.get("worker") == 0}
            if len(got) == FLEET_MESH_RANKS:
                seen.update(got.values())
                return got
            if time.perf_counter() - t0 > FLEET_TIMEOUT_S:
                fail(f"fleet_mesh: {what}: rank files {got}\n{log_tail()}")
            time.sleep(0.1)

    def replies(what):
        client = port.PolishClient(base, timeout=300.0)
        times = {}
        for n in FLEET_SIZES:
            t0 = time.perf_counter()
            r = client.polish(draft, positions[:n], examples[:n], contig=contig, retries=8)
            times[n] = time.perf_counter() - t0
            if r["polished"] != want[n] or r["windows"] != n:
                fail(f"fleet_mesh: the {n}-window reply {what} differs from the staged stitch")
        return times

    try:
        base = None
        while True:
            if sup.poll() is not None:
                fail(f"fleet_mesh: the supervisor exited {sup.returncode}:\n{log_tail()}")
            if time.perf_counter() - t_start > FLEET_TIMEOUT_S:
                fail(f"fleet_mesh: not ready within {FLEET_TIMEOUT_S} s:\n{log_tail()}")
            if base is None and os.path.exists(announce):
                base = f"http://127.0.0.1:{json.load(open(announce))['port']}"
            if base is not None:
                status, w = worker0()
                if status == 200 and w.get("state") == "ready":
                    break
            time.sleep(0.1)
        out["ready_s"] = time.perf_counter() - t_start
        if w.get("ranks") != FLEET_MESH_RANKS:
            fail(f"fleet_mesh: worker 0 runs {w.get('ranks')} rank(s)")
        first = incarnation("the first incarnation")
        apps_ready = len(nvidia_apps())
        if apps_ready != apps_before + FLEET_MESH_RANKS:
            fail(f"fleet_mesh: {apps_ready} contexts with the worker up, {apps_before} before")
        out["reply_s"] = replies("from 2 ranks")

        # -- the follower's SIGKILL: the worker restarts whole ------------
        os.kill(first[1], signal.SIGKILL)
        t_kill = time.perf_counter()
        while True:
            status, w = worker0()
            if status == 200 and w.get("state") == "ready" and w.get("restarts", 0) >= 1:
                break
            if time.perf_counter() - t_kill > FLEET_TIMEOUT_S:
                fail(f"fleet_mesh: worker 0 did not come back after its follower's SIGKILL: "
                     f"{w}\n{log_tail()}")
            time.sleep(0.1)
        out["rejoin_s"] = time.perf_counter() - t_kill
        print(f"fleet_mesh: worker 0 back in rotation {out['rejoin_s']:.2f} s after its "
              "follower's SIGKILL", flush=True)
        _, metrics_text, _ = http_json(base, "/metrics", timeout=10)
        restarts = re.findall(r"^roko_fleet_restarts_total (\S+)$", metrics_text, re.M)
        left = sorted(pid for pid in first.values() if pid_alive(pid))
        if w.get("restarts") != 1 or restarts != ["1"] or left:
            fail(f"fleet_mesh: after one follower's SIGKILL the worker restarted "
                 f"{w.get('restarts')} time(s), the fleet counts {restarts}, ranks left {left}")
        again = incarnation("the restarted incarnation")
        out["contexts_settle_s"] = wait_contexts(apps_ready, "fleet_mesh after the restart")
        out["reply_again_s"] = replies("after the restart")

        # -- drain ------------------------------------------------------------
        t_term = time.perf_counter()
        sup.send_signal(signal.SIGTERM)
        try:
            rc = sup.wait(FLEET_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"fleet_mesh: the supervisor did not exit within {FLEET_TIMEOUT_S} s")
        left = sorted(p for p in seen if pid_alive(p))
        if rc != 0 or left:
            fail(f"fleet_mesh: SIGTERM drain exited {rc}, ranks left {left}:\n{log_tail()}")
        out["drain"] = {"rc": rc, "seconds": time.perf_counter() - t_term,
                        "contexts_settle_s": wait_contexts(apps_before, "fleet_mesh drained"),
                        "ranks_seen": sorted(seen), "ranks_left": left}
    finally:
        if sup.poll() is None:
            sup.send_signal(signal.SIGTERM)
            try:
                sup.wait(60)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(sup.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if sup.poll() is None:
            sup.wait()
        for pid in seen:
            if pid_alive(pid):
                os.kill(pid, signal.SIGKILL)
        logf.close()
    reports = launch_reports(work)
    by_rank = rank_checks("fleet_mesh", reports, cfg.num_layers)
    final = [r for r in by_rank if r["pid"] in again.values()]
    if len({r["dispatches"] for r in final}) != 1 or not final[0]["dispatches"]:
        fail(f"fleet_mesh: the restarted ranks' exit files disagree: {final}")
    if {r["backend"] for r in by_rank} != {"gloo"}:
        fail(f"fleet_mesh: two ranks on one card chose {by_rank}; NCCL refuses them")
    out.update(
        backend="gloo, each rank's own choice on the one shared card",
        contexts={"before": apps_before, "worker_up": apps_ready},
        killed_follower_pid=first[1], first_ranks=first, restarted_ranks=again,
        launches_by_rank=by_rank, launches={"gru_fwd": sum(r["gru_fwd"] for r in by_rank)},
        gru_fwd_by_rung=[{"B": r["shape"]["B"], "max_abs_err": r["max_abs_err"],
                          "bitwise_repeatable": r["bitwise_repeatable"]} for r in rungs],
        seconds=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    return out


def drive_fleet_mix(torch, port, dev, card) -> dict:
    """The bench's mixed-size fleet phase (``benchmark.
    run_fleet_mixed_phase``) alone at full width (gru, 3 bidirectional
    layers, h=128, f32, weights from a numpy seed through the weights
    bridge): the serve phase's mix ``4:90,256:10``, 3 clients x 25
    requests, 2 one-rank workers sharing the card, under the deadline and
    then the continuous batcher, each mode its req/s, p50 and p99 by size
    class, padding efficiency and client errors (0 in both, the classes
    the mix's, each answered as often as the schedule asks). ``gru_fwd``
    is held against the plain loop at the ladder's rungs (8, 256), and
    each worker's exit file counts 3 launches a dispatch."""
    import tempfile

    t_phase = time.perf_counter()
    bench = port.bench
    cfg = port.ModelConfig()
    sd = port.state_dict_from_jax(jax_layout_params(np.random.default_rng(SEED + 30), cfg))
    mix = bench._parse_mix(SERVE_MIX)
    ladder = sorted({bench.FLEET_REQUEST_WINDOWS, max(s for s, _ in mix)})
    rungs = [check_kernel(torch, port.fg, dict(MAIN_SHAPE, B=b), dev,
                          np.random.default_rng(SEED + 31), timed=False) for b in ladder]
    schedule = bench._mix_schedule(mix, FLEET_CLIENTS * bench.FLEET_ITERS)
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_mix_")
    # the bench's workers run `python -m roko_tpu_torch` from this
    # process's directory, and report their launches beside the phase
    old, cwd = os.environ.get("ROKO_KERNEL_LAUNCHES"), os.getcwd()
    os.environ["ROKO_KERNEL_LAUNCHES"] = os.path.join(work, "launches")
    os.chdir(ROOT)
    try:
        res = bench.run_fleet_mixed_phase(
            SERVE_MIX, FLEET_MIX_WORKERS, iterations=bench.FLEET_ITERS, clients=FLEET_CLIENTS,
            device="cuda", startup_budget_s=FLEET_TIMEOUT_S, state_dict=sd)
    finally:
        os.chdir(cwd)
        if old is None:
            os.environ.pop("ROKO_KERNEL_LAUNCHES", None)
        else:
            os.environ["ROKO_KERNEL_LAUNCHES"] = old
    want_classes = {str(s): schedule.count(s) for s in set(schedule)}
    if set(res["modes"]) != {"deadline", "continuous"} or res["requests"] != len(schedule):
        fail(f"fleet_mix: {res}")
    for mode, row in res["modes"].items():
        got_classes = {s: c["requests"] for s, c in row["size_classes"].items()}
        if row["client_errors"] or got_classes != want_classes or \
                not 0.0 < row.get("padding_efficiency", 0.0) <= 1.0:
            fail(f"fleet_mix {mode}: {row}; the schedule's classes {want_classes}")
        print(f"fleet_mix {mode}: {row['req_per_s']} req/s over {row['wall_s']} s, "
              + ", ".join(f"{s} windows ({c['requests']} requests) p50 {c['p50_s']} s "
                          f"p99 {c['p99_s']} s" for s, c in row["size_classes"].items())
              + f", padding_efficiency {row['padding_efficiency']}, client_errors "
              f"{row['client_errors']}", flush=True)
    reports = launch_reports(work)
    by_worker = rank_checks("fleet_mix", reports, cfg.num_layers)
    if len(by_worker) != 2 * FLEET_MIX_WORKERS:
        fail(f"fleet_mix: {len(by_worker)} worker launch files, expected "
             f"{2 * FLEET_MIX_WORKERS}")
    shutil.rmtree(work, ignore_errors=True)
    return {**res, "model": {"kind": cfg.kind, "num_layers": cfg.num_layers,
                             "hidden_size": cfg.hidden_size},
            "clients": FLEET_CLIENTS, "iterations": bench.FLEET_ITERS, "ladder": ladder,
            "schedule_classes": want_classes, "launches_by_worker": by_worker,
            "launches": {"gru_fwd": sum(r["gru_fwd"] for r in by_worker)},
            "gru_fwd_by_rung": [{"B": r["shape"]["B"], "max_abs_err": r["max_abs_err"],
                                 "bitwise_repeatable": r["bitwise_repeatable"]} for r in rungs],
            "note": "two workers share one card: sharing, not scaling; a smoke, not a "
                    "measured tail: each class's p99 of fewer than 100 requests is near "
                    "its largest sample, and req/s covers one wall_s window",
            "seconds": time.perf_counter() - t_phase, "card": card}


def small_project(port, work: str, region=None) -> dict:
    """A 100 kb sim project and its windows (regions of ``region``, a
    ``RegionConfig``) in batches of 512, in the polish phase's
    ``_stream_inputs`` layout (``--cascade-only`` and
    ``--distpolish-only``)."""
    shutil.rmtree(work, ignore_errors=True)
    paths = port.build_synthetic_project(work, genome_len=SMALL_PROJECT_LEN,
                                         seed=POLISH_SIM_SEED)
    contig = paths["contig"]
    draft = port.read_fasta(paths["draft_fasta"])[0][1]
    config = port.RokoConfig() if region is None else port.RokoConfig(region=region)
    with port.open_region_stream(paths["draft_fasta"], paths["reads_bam"],
                                 workers=POLISH_WORKERS, seed=0, log=lambda s: None,
                                 config=config) as stream:
        blocks = [r for r in stream.results if r is not None and len(r[1])]
    positions = np.concatenate([b[1] for b in blocks])
    examples = np.concatenate([b[2] for b in blocks])
    batches = [([contig] * len(positions[i : i + PATH_BATCH_SIZE]),
                positions[i : i + PATH_BATCH_SIZE], examples[i : i + PATH_BATCH_SIZE])
               for i in range(0, len(positions), PATH_BATCH_SIZE)]
    return {"paths": paths, "contig": contig, "draft": draft, "batches": batches,
            "windows": len(positions)}


def drive_cascade(torch, port, model, lin_model, dev, counts, inputs, card) -> dict:
    """The cascade on the card, in this process, on ``model`` (full-width
    gru) and ``inputs`` (the polish phase's windows in batches of 512):
    threshold 0 against the plain path, the majority tier cold and warm
    over an on-disk cache, the ``model`` tier with ``lin_model``
    registered as a version, a gru-only bundle refused for it, escalated
    subsets against the full batch, and the bench's rows. Each run's
    launches are counted from 0."""
    import tempfile

    contig, draft, batches = inputs["contig"], inputs["draft"], inputs["batches"]
    n_batches, n = len(batches), sum(len(b[0]) for b in batches)
    layers = model.cfg.num_layers
    work = tempfile.mkdtemp(prefix="chip_smoke_cascade_")
    base = port.RokoConfig(model=model.cfg)

    def cascaded(**kw):
        return dataclasses.replace(base, cascade=port.CascadeConfig(enabled=True, **kw))

    def run(cfg, what, want=None, use=batches):
        stats: dict = {}
        counts.zero()
        t0 = time.perf_counter()
        got = port.run_inference(iter(use), {contig: draft}, model, device=dev,
                                 log=lambda s: None, cfg=cfg, cascade_stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: getattr(w, a) for k, (w, a) in counts.wrappers.items()}
        if want is not None:
            counts.expect(f"cascade {what}", want)
        return got, seconds, launches, stats

    run(base, "warm-up")
    plain, plain_s, _, _ = run(base, "plain", {"gru_fwd": layers * n_batches})
    zero, zero_s, zero_l, zero_st = run(cascaded(threshold=0.0), "threshold 0",
                                        {"gru_fwd": layers * n_batches})
    if zero != plain or zero_st["escalation_fraction"] != 1.0:
        fail(f"cascade: threshold 0's FASTA differs from the plain path's ({zero_st})")

    # the majority tier, cold then warm over one on-disk cache; the
    # escalating batches counted on the host with the same decision
    maj = cascaded(threshold=CASCADE_THRESHOLD, cache_dir=os.path.join(work, "cache"))
    router = port.CascadeRouter(threshold=CASCADE_THRESHOLD, params_digest="count",
                                cache_bytes=port.CascadeConfig().cache_bytes,
                                calibration=port.Calibration(temperature=8.0))
    cached = batches[:CASCADE_CACHE_BATCHES]
    n_cached = sum(len(b[0]) for b in cached)
    esc_batches = 0
    for _, _, x in cached:  # the same decisions and cache hits, tier 2 a stand-in
        before = router.escalated
        router.route(x, lambda xs: np.zeros((len(xs), xs.shape[2]), np.int32))
        esc_batches += router.escalated > before
    cold, cold_s, cold_l, cold_st = run(maj, "majority cold", {"gru_fwd": layers * esc_batches},
                                        use=cached)
    warm, warm_s, warm_l, warm_st = run(maj, "majority warm", {}, use=cached)
    if warm != cold or warm_st["cache_hit_rate"] != 1.0 or not cold_st["escalated"] < n_cached:
        fail(f"cascade: majority cold {cold_st} / warm {warm_st}")

    # the model tier: a registered lingru version, its kernel beside tier 2's
    lin_pth = os.path.join(work, "lingru.pth")
    torch.save(lin_model.state_dict(), lin_pth)
    reg = os.path.join(work, "registry")
    t0 = time.perf_counter()
    port.export_bundle(os.path.join(work, "b_lingru"), port.RokoConfig(model=lin_model.cfg),
                       ladder=(32,), device="cuda", log=lambda s: None)
    port.register_model(reg, "cascade_lingru", os.path.join(work, "b_lingru"), lin_pth,
                        log=lambda s: None)
    register_s = time.perf_counter() - t0
    tier = dataclasses.replace(
        cascaded(tier="model", tier_version="cascade_lingru", threshold=CASCADE_THRESHOLD,
                 cache_bytes=0),
        fleet=port.FleetConfig(registry_dir=reg))
    mt, mt_s, mt_l, mt_st = run(tier, "model tier")
    others = {k: v for k, v in mt_l.items() if k not in ("gru_fwd", "lingru_fwd") and v}
    if (mt_l["lingru_fwd"] != lin_model.cfg.num_layers * n_batches or others
            or mt_l["gru_fwd"] % layers or (mt_l["gru_fwd"] > 0) != (mt_st["escalated"] > 0)):
        fail(f"cascade: the model tier launched {mt_l} over {n_batches} batches ({mt_st})")
    if mt_st["escalation_fraction"] == 1.0 and mt != plain:
        fail(f"cascade: the model tier escalated every window, and its FASTA differs from the "
             f"plain path's ({mt_st})")
    # a keep floor at the median tier-1 confidence (as the CPU test sets
    # it), so that some windows keep the tier model's argmax: the FASTA must
    # be the one voted from those rows and the plain path's rows for the
    # rest, and each tier's kernel must run where its rows need it
    cal = port.Calibration(method=tier.cascade.method)
    with torch.inference_mode():
        tier1 = [lin_model(torch.from_numpy(np.ascontiguousarray(b[2])).to(dev)).float().cpu()
                 .numpy() for b in batches]
        tier2 = [port.predict(model, b[2], dev).cpu().numpy() for b in batches]
    threshold = 1.0 - float(np.median(np.concatenate([cal.confidence(t) for t in tier1])))
    esc = [port.escalate_mask(cal.confidence(t), threshold) for t in tier1]
    board = port.VoteBoard({contig: draft})
    for (names, positions, _), t1, t2, e in zip(batches, tier1, tier2, esc):
        board.add(names, positions, np.where(e[:, None], t2, t1.argmax(-1)).astype(np.int32))
    split_want = board.stitch_all()
    split_cfg = dataclasses.replace(tier, cascade=dataclasses.replace(tier.cascade,
                                                                     threshold=threshold))
    n_esc = int(sum(e.sum() for e in esc))
    esc_batches_mt = int(sum(bool(e.any()) for e in esc))
    ms, ms_s, ms_l, ms_st = run(split_cfg, "model tier at the median", {
        "gru_fwd": layers * esc_batches_mt, "lingru_fwd": lin_model.cfg.num_layers * n_batches})
    if ms != split_want or ms_st["escalated"] != n_esc or not 0 < n_esc < n:
        fail(f"cascade: the model tier at threshold {threshold} escalated {ms_st['escalated']} "
             f"windows (want {n_esc} of {n}); its FASTA equals the rows it should keep and "
             f"escalate: {ms == split_want}")
    # a bundle without the tier model's library is refused at start
    port.export_bundle(os.path.join(work, "b_gru"), base, ladder=(32,), device="cuda",
                       log=lambda s: None)
    try:
        port.build_router(dataclasses.replace(tier, compile=dataclasses.replace(
            tier.compile, bundle_dir=os.path.join(work, "b_gru"))), params=model, device=dev)
        fail("cascade: a gru-only bundle was not refused for a lingru tier model")
    except RuntimeError as e:
        if "lingru_fwd" not in str(e):
            fail(f"cascade: the bundle refusal does not name lingru_fwd: {e}")
        refusal = str(e).splitlines()[0][:300]

    # escalated subsets of odd sizes against the same rows of the full batch
    x = torch.from_numpy(np.ascontiguousarray(batches[0][2])).to(dev)
    rng = np.random.default_rng(SEED + 27)
    subsets = {}
    with torch.inference_mode():
        full = model(x).float()
        for m in CASCADE_SUBSETS:
            idx = np.sort(rng.choice(len(x), m, replace=False))
            sub = model(x[torch.from_numpy(idx).to(dev)]).float()
            ref = full[torch.from_numpy(idx).to(dev)]
            subsets[m] = {
                "max_abs_logit_delta": float((sub - ref).abs().max()),
                "argmax_differing": int((sub.argmax(-1) != ref.argmax(-1)).sum()),
                "columns": int(ref.shape[0] * ref.shape[1]),
                "bitwise_equal": bool(torch.equal(sub, ref)),
            }

    # the bench's rows
    t0 = time.perf_counter()
    bench_rows = port.bench.run_cascade_suite(CASCADE_BENCH_DRAFT, device="cuda")
    bench_s = time.perf_counter() - t0
    if "error" in bench_rows or bench_rows.get("threshold0_identical") is not True:
        fail(f"cascade: the bench's cascade rows {bench_rows}")
    shutil.rmtree(work, ignore_errors=True)

    def tiers(st):
        return {k: st[k] for k in ("windows", "escalated", "escalation_fraction", "cache_hits",
                                   "cache_hit_rate", "tier1_seconds", "tier2_seconds")}

    return {
        "windows": n, "batches": n_batches, "plain_seconds": plain_s,
        "plain_windows_per_s": n / plain_s,
        "threshold0": {"fasta_identical": True, "seconds": zero_s, "windows_per_s": n / zero_s,
                       "launches": zero_l["gru_fwd"]},
        "majority": {"threshold": CASCADE_THRESHOLD, "temperature": 8.0,
                     "windows": n_cached, "batches": len(cached),
                     "escalation_pct": 100.0 * cold_st["escalation_fraction"],
                     "escalating_batches": esc_batches,
                     "cold": {**tiers(cold_st), "seconds": cold_s,
                              "windows_per_s": n_cached / cold_s,
                              "gru_fwd_launches": cold_l["gru_fwd"]},
                     "warm": {**tiers(warm_st), "seconds": warm_s,
                              "windows_per_s": n_cached / warm_s,
                              "gru_fwd_launches": warm_l["gru_fwd"]},
                     "tier1_host_s_per_window": cold_st["tier1_seconds"] / n_cached,
                     "speedup_cold_vs_plain": (plain_s / n) / (cold_s / n_cached)},
        "model_tier": {"kind": lin_model.cfg.kind, "threshold": CASCADE_THRESHOLD,
                       **tiers(mt_st), "seconds": mt_s, "windows_per_s": n / mt_s,
                       "lingru_fwd_launches": mt_l["lingru_fwd"],
                       "gru_fwd_launches": mt_l["gru_fwd"],
                       "fasta_identical_to_plain": mt == plain,
                       "export_and_register_s": register_s, "bundle_refusal": refusal,
                       "at_median": {"threshold": threshold, **tiers(ms_st), "seconds": ms_s,
                                     "windows_per_s": n / ms_s,
                                     "lingru_fwd_launches": ms_l["lingru_fwd"],
                                     "gru_fwd_launches": ms_l["gru_fwd"],
                                     "fasta_identical_to_kept_and_plain_rows": True}},
        "subsets_vs_full_batch": subsets,
        "bench": {**bench_rows, "seconds": bench_s},
        "launches": {"gru_fwd": zero_l["gru_fwd"] + cold_l["gru_fwd"] + mt_l["gru_fwd"]
                     + ms_l["gru_fwd"],
                     "lingru_fwd": mt_l["lingru_fwd"] + ms_l["lingru_fwd"]},
        "card": card,
    }


def nvidia_apps() -> list:
    """The pids holding a context on the card, as nvidia-smi lists them."""
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return [int(t) for t in smi.stdout.split() if t.strip().isdigit()]


def nvidia_handles(pid: int) -> list:
    """The ``/dev/nvidia*`` files process ``pid`` holds open: none in a
    process that never initialised CUDA (nvidia-smi's pids may be another
    pid namespace's, so they alone cannot show it)."""
    out = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.append(target)
    except OSError:
        pass
    return sorted(set(out))


def launch_reports(folder: str) -> dict:
    """{pid: report} of the serve processes' launch files in ``folder``
    (``ROKO_KERNEL_LAUNCHES=<folder>/launches``; each is rewritten at the
    worker's warmup end, after each answered request and at its exit)."""
    out = {}
    for name in os.listdir(folder):
        if name.startswith("launches.") and name.endswith(".json"):
            with open(os.path.join(folder, name)) as f:
                report = json.load(f)
            out[report["pid"]] = report
    return out


def job_launches(before: dict, after: dict) -> dict:
    """What the workers launched and served between two
    :func:`launch_reports` snapshots: each worker's counts past its
    warmup, less those it had at ``before`` (a worker absent there
    started from 0)."""
    served = {"windows": 0, "batches": 0}
    launched = {"gru_fwd": 0, "gru_fwd_bf16": 0, "lingru_fwd": 0, "lingru_fwd_bf16": 0}
    for pid, r in after.items():
        p = before.get(pid)
        for k in served:
            served[k] += r["served"][k] - (p["served"][k] if p else 0)
        for k in launched:
            launched[k] += r["launches"][k] - r["warmup_launches"].get(k, 0)
            if p:
                launched[k] -= p["launches"][k] - p["warmup_launches"].get(k, 0)
    return {"launches": launched, "served": served}


def run_job(base: str, coordinator_pid: int, runtime: str, inputs: dict, out: str,
            want: bytes, http, wait_done, reports, before: dict, layers: int) -> dict:
    """A distributed polish job over a fleet: SIGKILL the worker of the
    first unit seen in flight, read ``/jobz`` to its end, and hold the
    FASTA and the coordinator's hands off the card. ``wait_done()`` waits
    for the job to end (the coordinator's exit, or ``/jobz`` done).

    The job's launches are the workers' launch files (``reports()``) at
    its end less ``before``, each past its warmup. A worker writes its
    file before each reply, so the SIGKILLed one counts the requests it
    answered and nothing of the unit it died in: the job's windows are
    then the single process's exactly, and ``gru_fwd`` ran ``layers``
    times in each step that predicted them."""
    import signal

    def worker_pid(wid):
        with open(os.path.join(runtime, f"worker-{wid}.announce.json")) as f:
            return json.load(f)["pid"]

    t0 = time.perf_counter()
    victim = None
    while victim is None:
        if time.perf_counter() - t0 > FLEET_TIMEOUT_S:
            fail(f"distpolish: no unit went in flight within {FLEET_TIMEOUT_S} s")
        status, body = http(base, "/jobz")
        for u in (body.get("units") or {}).values():
            if u.get("state") == "inflight" and u.get("worker") is not None:
                victim = u["worker"]
                break
        time.sleep(0.02)
    killed = worker_pid(victim)
    os.kill(killed, signal.SIGKILL)
    t_kill = time.perf_counter() - t0
    apps = nvidia_apps()
    workers = {}
    for wid in (0, 1):
        try:
            workers[wid] = worker_pid(wid)
        except (OSError, ValueError, KeyError):
            pass
    handles = nvidia_handles(coordinator_pid)
    snap = wait_done()
    seconds = time.perf_counter() - t0
    units = list(snap.get("units", {}).values())
    reruns = max(sum(u.get("attempts", 0) for u in units), snap.get("retries_logged", 0))
    spans = sum(1 for u in units if not u.get("whole"))
    with open(out, "rb") as fh:
        identical = fh.read() == want
    ran = job_launches(before, reports())
    windows = sum(len(b[0]) for b in inputs["batches"])
    result = {
        "state": snap.get("state"), "units": len(units), "span_units": spans,
        "units_run_twice": reruns,
        # the single process's windows: the units extract the same set
        "windows": windows, "served": ran["served"],
        "launches": {k: v for k, v in ran["launches"].items() if v},
        "gru_fwd_launches_want": layers * ran["served"]["batches"],
        "seconds": seconds, "killed_worker": victim, "killed_pid": killed,
        "killed_at_s": t_kill, "fasta_identical_to_single_process": identical,
        "nvidia_smi_compute_pids": apps, "worker_pids": workers,
        "coordinator_pid": coordinator_pid, "coordinator_on_card": coordinator_pid in apps,
        "coordinator_nvidia_handles": handles,
    }
    if (snap.get("state") != "done" or reruns > 1 or not spans or not identical
            or coordinator_pid in apps or handles):
        fail(f"distpolish: {result}")
    if (ran["served"]["windows"] != windows or ran["served"]["batches"] < len(units)
            or ran["launches"]["gru_fwd"] != layers * ran["served"]["batches"]
            or set(result["launches"]) != {"gru_fwd"}):
        fail(f"distpolish: the workers served and launched {ran} for the job's {windows} "
             f"windows in {len(units)} units")
    return result


def single_process_polish(torch, port, sd, cfg, inputs, dev) -> bytes:
    """The single-process polish on the card (the streaming engine) of
    ``inputs``' project with the weights ``sd``: the bytes a distributed
    job must write."""
    import tempfile

    model = port.RokoModel(cfg.model)
    model.load_state_dict(sd, strict=True)
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_single_"), "single.fasta")
    paths = inputs["paths"]
    port.run_streaming_polish(paths["draft_fasta"], paths["reads_bam"], model, cfg, out_path=out,
                              workers=POLISH_WORKERS, seed=0, batch_size=PATH_BATCH_SIZE,
                              device=dev, log=lambda s: None)
    with open(out, "rb") as fh:
        data = fh.read()
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    return data


def drive_distpolish_cli(torch, port, dev, card) -> dict:
    """``polish --distributed`` from the command line on a 100 kb project:
    its own fleet of 2 workers sharing the card, span units, the worker of
    the first unit SIGKILLed mid-unit, the coordinator in a session of its
    own (drained, then its group and its fleet's group killed, on any
    failure). Its workers report their launches (:func:`run_job`)."""
    import signal
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_distpolish_")
    cfg = port.RokoConfig(region=port.RegionConfig(size=DIST_CLI_REGION, overlap=300))
    inputs = small_project(port, os.path.join(work, "project"), cfg.region)
    sd = port.state_dict_from_jax(jax_layout_params(np.random.default_rng(SEED + 28), cfg.model))
    pth = os.path.join(work, "model.pth")
    torch.save(sd, pth)
    want = single_process_polish(torch, port, sd, cfg, inputs, dev)
    runtime = os.path.join(work, "runtime")
    cfg = dataclasses.replace(
        cfg, fleet=dataclasses.replace(cfg.fleet, runtime_dir=runtime,
                                       heartbeat_interval_s=0.5),
        distpolish=port.DistPolishConfig(unit_bases=DIST_CLI_UNIT_BASES, inflight_per_worker=1,
                                         park_poll_s=0.05))
    cfg_path = os.path.join(work, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    out = os.path.join(work, "distributed.fasta")
    log_path = os.path.join(work, "coordinator.log")
    logf = open(log_path, "w")
    env = dict(os.environ, ROKO_COMPILE_CACHE="off",
               ROKO_KERNEL_LAUNCHES=os.path.join(work, "launches"))
    t_start = time.perf_counter()
    paths = inputs["paths"]
    proc = subprocess.Popen([sys.executable, "-m", "roko_tpu_torch", "polish",
                             paths["draft_fasta"], paths["reads_bam"], pth, out, "--distributed",
                             "--workers", "2", "--config", cfg_path, "--seed", "0"],
                            cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT,
                            start_new_session=True)

    def log_tail():
        logf.flush()
        with open(log_path) as f:
            return f.read()[-4000:]

    def http(base, path):
        try:
            status, body, _ = http_json(base, path, timeout=10)
        except OSError:
            return None, {}
        return status, body if isinstance(body, dict) else {}

    try:
        base = None
        while base is None:
            if proc.poll() is not None:
                fail(f"distpolish: polish --distributed exited {proc.returncode}:\n{log_tail()}")
            if time.perf_counter() - t_start > FLEET_TIMEOUT_S:
                fail(f"distpolish: no front end within {FLEET_TIMEOUT_S} s:\n{log_tail()}")
            m = re.search(r"front end at (http://[\d.]+:\d+)", log_tail())
            base = m.group(1) if m else None
            time.sleep(0.1)
        last = {}

        def wait_done():
            deadline = time.perf_counter() + 2 * FLEET_TIMEOUT_S
            while proc.poll() is None:
                status, body = http(base, "/jobz")
                if body.get("units"):
                    last.update(body)
                if time.perf_counter() > deadline:
                    fail(f"distpolish: the job did not end:\n{log_tail()}")
                time.sleep(0.1)
            if proc.returncode != 0:
                fail(f"distpolish: polish --distributed exited {proc.returncode}:\n{log_tail()}")
            # the last live snapshot; the job's end is the coordinator's
            # own event line
            logf.flush()
            with open(log_path) as f:
                text = f.read()
            return {**last, "state": "done" if "ROKO_JOB event=job_done" in text else "failed",
                    "retries_logged": text.count("ROKO_JOB event=unit_retry")}

        result = run_job(base, proc.pid, runtime, inputs, out, want, http, wait_done,
                         lambda: launch_reports(work), {}, cfg.model.num_layers)
        result["rc"] = proc.returncode
        result["wall_s"] = time.perf_counter() - t_start
        # the coordinator's group, and the one its fleet's workers ran in
        m = re.search(r"fleet workers in process group (\d+)", log_tail())
        fleet_group = int(m.group(1)) if m else None
        left = {}
        for what, pgid in (("coordinator", proc.pid), ("fleet", fleet_group)):
            try:
                os.killpg(pgid, 0)
                left[what] = True
            except ProcessLookupError:
                left[what] = False
        result.update(fleet_process_group=fleet_group, process_groups_left=left)
        if fleet_group is None or any(left.values()):
            fail(f"distpolish: processes of the coordinator's groups {left} outlived it "
                 f"(the fleet's group {fleet_group}):\n{log_tail()}")
    finally:
        if proc.poll() is None:  # a failure above: drain, then kill the group
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                pass
        m = re.search(r"fleet workers in process group (\d+)", log_tail())
        for pgid in (proc.pid, int(m.group(1)) if m else None):
            try:
                if pgid is not None:
                    os.killpg(pgid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if proc.poll() is None:
            proc.wait()
        logf.close()
    shutil.rmtree(work, ignore_errors=True)
    return {**result, "mode": "polish --distributed (CLI)", "project_len": SMALL_PROJECT_LEN,
            "region_size": DIST_CLI_REGION, "unit_bases": DIST_CLI_UNIT_BASES, "card": card}


def drive_federation(torch, port, dev, card) -> dict:
    """The multi-host federation and the object-store data plane at full
    width (gru, 3 bidirectional layers, h=128, f32; weights from the numpy
    seed) on the ``--distpolish-only`` project (100 kb, 40 kb regions):

    1. a ``StubObjectStore`` on loopback holds the draft, the BAM and its
       BAI; ``python -m roko_tpu_torch polish`` reads them and writes its
       FASTA there (``s3://`` URLs through ``--store-endpoint``) under
       ``ROKO_STORE_FAULTS`` at the storage gate's rates, seed 42; the FASTA
       read back from the bucket must be the single-process polish's on the
       card byte for byte, with retries above 0;
    2. a federation front in this process, its relays through
       ``ROKO_FED_FAULTS`` at the chaos gate's rates, and two host agents
       (``serve MODEL --host-agent --join ... --host-id h0|h1 --workers 1``)
       started through the CLI, each in a session of its own, sharing the
       card;
    3. closed-loop ``/polish`` load through the front: every reply the
       staged stitch byte for byte, ``X-Roko-Host`` naming both hosts;
    4. a partition pulse of ``front-h1``, then h1's whole process group
       SIGKILLed under load: no client error, ``/healthz`` degraded, and
       none of h1's workers left on the card (``nvidia-smi
       --query-compute-apps``, and the pid gone);
    5. h1 started again under the same host id: its epoch one higher, and
       routed to again;
    6. ``POST /job`` to h0 with ``s3://`` draft, BAM and output: the FASTA
       read back from the bucket is the single-process polish's, and h0's
       worker files, read just before the job and at its end, show the
       job's windows served once and ``gru_fwd`` launched 3 times a step;
    7. SIGTERM to both agents: a clean drain, no worker left."""
    import http.client
    import signal
    import tempfile
    import threading

    from roko_tpu_torch.datapipe.store import StubObjectStore
    from roko_tpu_torch.serve.federation import (
        FED_HOST_HEADER,
        FederationFront,
        make_federation_server,
    )
    from roko_tpu_torch.serve.transport import transport_from_env

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_federation_")
    region = port.RegionConfig(size=DIST_CLI_REGION, overlap=300)
    cfg = port.RokoConfig(region=region)
    inputs = small_project(port, os.path.join(work, "project"), region)
    sd = port.state_dict_from_jax(jax_layout_params(np.random.default_rng(SEED + 29), cfg.model))
    pth = os.path.join(work, "model.pth")
    torch.save(sd, pth)
    want_fasta = single_process_polish(torch, port, sd, cfg, inputs, dev)
    contig, draft = inputs["contig"], inputs["draft"]
    positions = np.concatenate([b[1] for b in inputs["batches"]])
    examples = np.concatenate([b[2] for b in inputs["batches"]])
    model = port.RokoModel(cfg.model)
    model.load_state_dict(sd, strict=True)
    model.to(dev).eval()
    want = {n: port.run_inference(iter([([contig] * n, positions[:n], examples[:n])]),
                                  {contig: draft}, model, device=dev, log=lambda m: None)[contig]
            for n in FED_SIZES}
    del model
    bodies = {n: json.dumps({"contig": contig, "draft": draft, "n": n,
                             "positions": base64_le(positions[:n].astype(np.int64)),
                             "examples": base64_le(examples[:n].astype(np.uint8))}).encode()
              for n in FED_SIZES}
    out: dict = {"model": {"kind": cfg.model.kind, "num_layers": cfg.model.num_layers,
                           "hidden_size": cfg.model.hidden_size},
                 "project_len": SMALL_PROJECT_LEN, "region_size": DIST_CLI_REGION,
                 "windows": inputs["windows"], "card": card}

    # -- the bucket -----------------------------------------------------------
    bucket = os.path.join(work, "bucket")
    os.makedirs(os.path.join(bucket, "bkt"))
    paths = inputs["paths"]
    for name, src in (("draft.fasta", paths["draft_fasta"]), ("reads.bam", paths["reads_bam"]),
                      ("reads.bam.bai", paths["reads_bam"] + ".bai")):
        shutil.copyfile(src, os.path.join(bucket, "bkt", name))
    stub = StubObjectStore(bucket).start()
    py = [sys.executable, "-m", "roko_tpu_torch"]
    home = os.path.join(work, "home")  # the store outputs' journals
    base_env = {k: v for k, v in os.environ.items()
                if not k.startswith(("ROKO_FED_", "ROKO_STORE_"))}
    base_env["HOME"] = home

    # -- the front, in this process ---------------------------------------------
    front_transport = transport_from_env("front", env={
        "ROKO_FED_FAULTS": FED_FAULTS, "ROKO_FED_DELAY_S": FED_DELAY_S,
        "ROKO_FED_FAULTS_SEED": "1234"})
    fed_log: list = []
    front = FederationFront(
        port.RokoConfig(fleet=port.FleetConfig(lease_ttl_s=FED_LEASE_TTL_S,
                                               fed_breaker_failures=2, fed_breaker_reset_s=0.5,
                                               failover_attempts=4)),
        transport=front_transport, log=fed_log.append)
    fed_server = make_federation_server(front, host="127.0.0.1", port=0)
    threading.Thread(target=fed_server.serve_forever, daemon=True).start()
    front.start()
    fed_port = fed_server.server_address[1]
    fed_base = f"http://127.0.0.1:{fed_port}"

    agents: dict = {}  # tag -> (proc, announce, runtime, launches folder, log path)

    def spawn_agent(hid, tag):
        runtime = os.path.join(work, f"rt_{tag}")
        folder = os.path.join(work, f"launches_{tag}")
        os.makedirs(folder)
        acfg = dataclasses.replace(
            cfg, fleet=port.FleetConfig(runtime_dir=runtime, heartbeat_interval_s=0.5),
            distpolish=port.DistPolishConfig(unit_bases=DIST_CLI_UNIT_BASES,
                                             inflight_per_worker=1, park_poll_s=0.05))
        cfg_path = os.path.join(work, f"agent_{tag}.json")
        with open(cfg_path, "w") as f:
            f.write(acfg.to_json())
        announce = os.path.join(work, f"agent_{tag}.announce.json")
        log_path = os.path.join(work, f"agent_{tag}.log")
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                py + ["serve", pth, "--host-agent", "--join", f"127.0.0.1:{fed_port}",
                      "--host-id", hid, "--lease-ttl", str(FED_LEASE_TTL_S), "--workers", "1",
                      "--config", cfg_path, "--store-endpoint", stub.url, "--port", "0",
                      "--announce", announce],
                cwd=ROOT, env=dict(base_env, ROKO_KERNEL_LAUNCHES=os.path.join(folder,
                                                                               "launches")),
                stdout=logf, stderr=subprocess.STDOUT, start_new_session=True)
        agents[tag] = (proc, announce, runtime, folder, log_path)
        return time.perf_counter()

    def agent_log(tag):
        with open(agents[tag][4]) as f:
            return f.read()[-3000:]

    def agent_port(tag):
        try:
            with open(agents[tag][1]) as f:
                return json.load(f)["port"]
        except (OSError, ValueError, KeyError):
            return None

    def agent_health(tag):
        p = agent_port(tag)
        if p is None:
            return {}
        try:
            return http_json(f"http://127.0.0.1:{p}", "/healthz", timeout=10)[1]
        except OSError:
            return {}

    def worker_pid(tag):
        try:
            with open(os.path.join(agents[tag][2], "worker-0.announce.json")) as f:
                return json.load(f)["pid"]
        except (OSError, ValueError, KeyError):
            return None

    def wait_ready(tags, t0, what):
        while True:
            for tag in tags:
                if agents[tag][0].poll() is not None:
                    fail(f"federation: agent {tag} exited {agents[tag][0].returncode}:\n"
                         f"{agent_log(tag)}")
            hids = {tag: tag.split("_")[0] for tag in tags}
            leases = {tag: front.registry.get(h) for tag, h in hids.items()}
            if all(l is not None and l.state() == "live" for l in leases.values()) and \
                    all(agent_health(tag).get("status") == "ok" for tag in tags):
                return time.perf_counter() - t0
            if time.perf_counter() - t0 > FLEET_TIMEOUT_S:
                fail(f"federation: {what} not ready within {FLEET_TIMEOUT_S} s:\n"
                     + "\n".join(agent_log(tag) for tag in tags))
            time.sleep(0.1)

    def fed_post(n):
        """(host, polished, attempts) of one /polish through the front,
        riding out 503s and dropped connections as a retrying client
        does; anything else, or 30 attempts without a reply, is an error
        the client sees."""
        for attempt in range(30):
            conn = http.client.HTTPConnection("127.0.0.1", fed_port, timeout=300)
            try:
                conn.request("POST", "/polish", body=bodies[n],
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                data = r.read()
                if r.status == 200:
                    return r.getheader(FED_HOST_HEADER), json.loads(data)["polished"], attempt + 1
                if r.status != 503:
                    raise RuntimeError(f"/polish answered {r.status}: {data[:300]!r}")
            except (OSError, http.client.HTTPException):
                pass
            finally:
                conn.close()
            time.sleep(0.2)
        raise RuntimeError("no reply through the front in 30 attempts")

    def load(stop):
        got, errors = [], []
        lock = threading.Lock()

        def one(k):
            i = k
            while not stop.is_set():
                n = FED_SIZES[i % len(FED_SIZES)]
                i += 1
                t0 = time.perf_counter()
                try:
                    host, polished, attempts = fed_post(n)
                except RuntimeError as e:
                    with lock:
                        errors.append(str(e)[:300])
                    continue
                with lock:
                    got.append((time.perf_counter() - t0, host, attempts))
                    if polished != want[n]:
                        errors.append(f"a {n}-window reply from {host} differs from the "
                                      "staged stitch")

        threads = [threading.Thread(target=one, args=(k,), daemon=True)
                   for k in range(FED_CLIENTS)]
        for t in threads:
            t.start()
        return threads, got, errors, time.perf_counter()

    def finish(handle, what):
        threads, got, errors, t0 = handle
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        if errors:
            fail(f"federation {what}: {len(errors)} client-visible error(s): {errors[:5]}")
        lat = [g[0] for g in got]
        hosts = [g[1] for g in got]
        return {"requests": len(got), "req_per_s": len(got) / wall, "wall_s": wall,
                "p50_s": float(np.percentile(lat, 50)) if lat else None,
                "p99_s": float(np.percentile(lat, 99)) if lat else None,
                "by_host": {h: hosts.count(h) for h in set(hosts)},
                "retried": sum(1 for g in got if g[2] > 1)}

    store_polish = None
    try:
        # -- 1 and 2 at once: the store polish and both agents start ----------
        t0 = time.perf_counter()
        pcfg = os.path.join(work, "polish.json")
        with open(pcfg, "w") as f:
            f.write(cfg.to_json())
        evlog = os.path.join(work, "polish_events.jsonl")
        store_polish = subprocess.Popen(
            py + ["polish", "s3://bkt/draft.fasta", "s3://bkt/reads.bam", pth,
                  "s3://bkt/polished.fasta", "--config", pcfg, "--store-endpoint", stub.url,
                  "--store-cache", os.path.join(work, "store_cache"), "--t",
                  str(POLISH_WORKERS), "--seed", "0", "--event-log", evlog],
            cwd=ROOT, env=dict(base_env, ROKO_STORE_FAULTS=STORE_FAULTS,
                               ROKO_STORE_FAULT_SEED="42", ROKO_STORE_TIMEOUT_S="10"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        t_agents = {tag: spawn_agent(tag, tag) for tag in ("h0", "h1")}
        try:
            text, _ = store_polish.communicate(timeout=FLEET_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"federation: the store polish did not end within {FLEET_TIMEOUT_S} s")
        polish_s = time.perf_counter() - t0
        if store_polish.returncode != 0:
            fail(f"federation: the store polish exited {store_polish.returncode}:\n"
                 f"{text[-3000:]}")
        with open(os.path.join(bucket, "bkt", "polished.fasta"), "rb") as f:
            got_fasta = f.read()
        events = []
        with open(evlog) as f:
            for line in f:
                try:
                    events.append(json.loads(line))
                except ValueError:
                    pass
        store_events = [e["event"] for e in events if e.get("subsystem") == "store"]
        out["store_polish"] = {
            "seconds": polish_s, "faults": STORE_FAULTS, "fault_seed": 42,
            "fasta_identical_to_single_process": got_fasta == want_fasta,
            "sha256": hashlib.sha256(got_fasta).hexdigest(),
            "retries": store_events.count("store_retry"),
            "events": {e: store_events.count(e) for e in set(store_events)}}
        if got_fasta != want_fasta or not out["store_polish"]["retries"]:
            fail(f"federation: the store polish {out['store_polish']}")

        out["agents_ready_s"] = wait_ready(("h0", "h1"), min(t_agents.values()), "h0 and h1")
        pids = {tag: worker_pid(tag) for tag in ("h0", "h1")}

        # -- 3: load through the front --------------------------------------
        stop = threading.Event()
        handle = load(stop)
        time.sleep(FED_LOAD_S)
        stop.set()
        out["load"] = finish(handle, "load")
        if set(out["load"]["by_host"]) != {"h0", "h1"}:
            fail(f"federation: X-Roko-Host named {out['load']['by_host']}, not both hosts")

        # -- 4: a partition pulse, then h1's group SIGKILLed under load ------
        stop = threading.Event()
        handle = load(stop)
        time.sleep(1.0)
        # the pulse lasts until it has cut at least one relay (5 s at most)
        front_transport.partition("front", "h1")
        t_cut = time.perf_counter()
        while not front_transport.injected["partition"] and time.perf_counter() - t_cut < 5.0:
            time.sleep(0.05)
        time.sleep(0.5)
        front_transport.heal("front", "h1")
        pulse_s = time.perf_counter() - t_cut
        time.sleep(1.0)
        # nvidia-smi may list every process as pid 1 (another pid
        # namespace): h1's worker is gone from it when one context fewer
        # stays on the card
        apps_before = nvidia_apps()
        os.killpg(agents["h1"][0].pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        degraded_s = None
        while degraded_s is None:
            status, health, _ = http_json(fed_base, "/healthz", timeout=10)
            if isinstance(health, dict) and health.get("status") == "degraded":
                degraded_s = time.perf_counter() - t_kill
            elif time.perf_counter() - t_kill > FLEET_TIMEOUT_S:
                fail(f"federation: /healthz not degraded after h1's SIGKILL: {health}")
            else:
                time.sleep(0.05)
        time.sleep(max(0.0, FED_KILL_LOAD_S - (time.perf_counter() - t_kill)))
        stop.set()
        out["failover"] = finish(handle, "the partition pulse and h1's SIGKILL")
        out["failover"].update(degraded_s=degraded_s, health_after_kill=health,
                               partition_s=pulse_s,
                               partition_injected=front_transport.injected["partition"])
        if not front_transport.injected["partition"]:
            fail("federation: the front-h1 partition pulse cut no relay")
        agents["h1"][0].wait(60)
        t_gone = time.perf_counter()
        while pid_alive(pids["h1"]) or pids["h1"] in nvidia_apps() or \
                len(nvidia_apps()) != len(apps_before) - 1:
            if time.perf_counter() - t_gone > 30:
                fail(f"federation: h1's worker {pids['h1']} still on the card "
                     f"({nvidia_apps()}, {apps_before} before) after its group's SIGKILL")
            time.sleep(0.2)
        out["failover"].update(killed_worker_pid=pids["h1"],
                               nvidia_smi_compute_pids_before=apps_before,
                               nvidia_smi_compute_pids=nvidia_apps(),
                               worker_gone_s=time.perf_counter() - t_kill)

        # -- 5: h1 rejoins under the same host id ----------------------------
        old_epoch = front.registry.current_epoch("h1")
        t_re = spawn_agent("h1", "h1_b")
        rejoin_s = wait_ready(("h1_b",), t_re, "h1 again")
        epoch = front.registry.current_epoch("h1")
        served_by = []
        while "h1" not in served_by:
            if len(served_by) >= 20:
                fail(f"federation: the rejoined h1 was never routed to: {served_by}")
            host, polished, _ = fed_post(FED_SIZES[0])
            if polished != want[FED_SIZES[0]]:
                fail(f"federation: a reply from {host} after the rejoin differs")
            served_by.append(host)
        out["rejoin"] = {"seconds": rejoin_s, "epoch_before": old_epoch, "epoch": epoch,
                         "requests_until_h1": len(served_by)}
        if epoch != old_epoch + 1:
            fail(f"federation: h1 rejoined at epoch {epoch}, not {old_epoch + 1}")

        # -- 6: POST /job to h0 over the store -------------------------------
        h0 = f"http://127.0.0.1:{agent_port('h0')}"
        before = launch_reports(agents["h0"][3])
        t_job = time.perf_counter()
        status, body, _ = http_json(h0, "/job", {
            "ref": "s3://bkt/draft.fasta", "bam": "s3://bkt/reads.bam",
            "out": "s3://bkt/job.fasta", "seed": 0}, timeout=30)
        if status != 202:
            fail(f"federation: POST /job to h0 answered {status}: {body}\n{agent_log('h0')}")
        while True:
            _, snap, _ = http_json(h0, "/jobz", timeout=30)
            if isinstance(snap, dict) and snap.get("state") in ("done", "failed"):
                break
            if time.perf_counter() - t_job > FLEET_TIMEOUT_S:
                fail(f"federation: the job did not end: {snap}")
            time.sleep(0.1)
        job_s = time.perf_counter() - t_job
        ran = job_launches(before, launch_reports(agents["h0"][3]))
        with open(os.path.join(bucket, "bkt", "job.fasta"), "rb") as f:
            job_fasta = f.read()
        units = list(snap.get("units", {}).values())
        out["job"] = {
            "seconds": job_s, "state": snap.get("state"), "units": len(units),
            "span_units": sum(1 for u in units if not u.get("whole")),
            "fasta_identical_to_single_process": job_fasta == want_fasta,
            "served": ran["served"], "launches": {k: v for k, v in ran["launches"].items() if v},
            "gru_fwd_launches_want": cfg.model.num_layers * ran["served"]["batches"]}
        if (snap.get("state") != "done" or job_fasta != want_fasta
                or ran["served"]["windows"] != inputs["windows"]
                or ran["launches"]["gru_fwd"] != cfg.model.num_layers * ran["served"]["batches"]
                or set(out["job"]["launches"]) != {"gru_fwd"}):
            fail(f"federation: the job {out['job']} for {inputs['windows']} windows")

        out["federation"] = front.summary()

        # -- 7: SIGTERM drains both agents ------------------------------------
        t_term = time.perf_counter()
        live = ("h0", "h1_b")
        workers = {tag: worker_pid(tag) for tag in live}
        for tag in live:
            agents[tag][0].send_signal(signal.SIGTERM)
        rcs = {}
        for tag in live:
            try:
                rcs[tag] = agents[tag][0].wait(FLEET_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"federation: agent {tag} did not exit within {FLEET_TIMEOUT_S} s")
        left = {tag: pid for tag, pid in workers.items() if pid and pid_alive(pid)}
        groups_left = []
        for tag in live:
            try:
                os.killpg(agents[tag][0].pid, 0)
                groups_left.append(tag)
            except ProcessLookupError:
                pass
        out["drain"] = {"rc": rcs, "seconds": time.perf_counter() - t_term,
                        "workers_left": left, "process_groups_left": groups_left}
        if any(rcs.values()) or left or groups_left:
            fail(f"federation: the drain {out['drain']}:\n" +
                 "\n".join(agent_log(tag) for tag in live))
        out["fed_faults_injected"] = dict(front_transport.injected)
    finally:
        if store_polish is not None and store_polish.poll() is None:
            os.killpg(store_polish.pid, signal.SIGKILL)
            store_polish.wait()
        for proc, *_ in agents.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(60)
                except subprocess.TimeoutExpired:
                    pass
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            if proc.poll() is None:
                proc.wait()
        front.stop()
        fed_server.shutdown()
        fed_server.server_close()
        stub.shutdown()
        stub.server_close()
    # every worker's launch file: the last one each wrote (at its exit, or
    # at its last answered request for the SIGKILLed one)
    launches = {"gru_fwd": 0, "gru_fwd_bf16": 0, "lingru_fwd": 0, "lingru_fwd_bf16": 0}
    reports = {}
    for tag, (_, _, _, folder, _) in agents.items():
        for pid, r in launch_reports(folder).items():
            reports[pid] = r
            for k, v in r["launches"].items():
                launches[k] += v
    total = launches.pop("gru_fwd")
    if len(reports) != 3 or total < 3 * len(reports) or any(launches.values()):
        fail(f"federation: the workers' kernel launches {launches} from {len(reports)} file(s)")
    out["launches"] = {"gru_fwd": total, "job_gru_fwd": ran["launches"]["gru_fwd"],
                       "workers_reporting": len(reports)}
    out["seconds"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    return out


def base64_le(a: np.ndarray) -> str:
    """An array as the service's wire format: base64 of its raw
    little-endian bytes."""
    import base64

    return base64.b64encode(np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tobytes()).decode()


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def ptxas_usage(report: str) -> dict:
    """Registers and spill bytes of each function in nvcc's ``-Xptxas -v``
    report (``kernels.build``'s ``"ptxas"``), by mangled name:
    ``{name: {"registers": n, "spill_stores": n, "spill_loads": n}}``."""
    usage: dict = {}
    name = None
    for line in report.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if found:
            name = found.group(1)
            usage.setdefault(name, {})
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and name:
            usage[name].update(spill_stores=int(spills.group(1)), spill_loads=int(spills.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            usage[name]["registers"] = int(regs.group(1))
    return usage


def one_kernel(torch, flag: str, root: str) -> None:
    """Only gru_bwd (``--bwd-only``), only gru_fwd (``--fwd-only``), only
    gru_fwd_bf16 (``--fwd-bf16-only``), only gru_bwd_bf16
    (``--bwd-bf16-only``), only the lingru scans
    (``--lingru-only``) or only the bf16 lingru scans
    (``--lingru-bf16-only``), from the port package under ``root`` (this
    tree's or an unpacked copy of another commit's): built, checked against
    the plain loops and timed, gru_bwd at the train shape split by
    sub-kernel, gru_fwd and both lingru scans at the inference and the
    train batch (the scans also at every steps and stages of their plan),
    gru_fwd_bf16 at the inference rungs (B = 32, 128, 512) as the
    precision phase checks it, gru_bwd_bf16 as the precision phase checks
    it (the train shape, the ragged one, the card test's inputs; its dxp
    over seeds, failing unless it lies beyond the bar from the float64
    yardstick on no more seeds than the plain loop's own, C1's rule; the
    order of the plain loop's sums) and at B = 512, each timed and split
    by sub-kernel, its weight-gradient pass beside the library calls, the
    bf16 lingru scans as the precision phase checks them at B = 512 and
    128 (the backward at 128 first), beside the f32 scans on the same
    inputs and at every bf16 steps and stages; each with nvcc's ptxas
    report (registers and spill bytes of every kernel function, read by
    ``ptxas_usage``). Two trees compare within one call as parent, change,
    change, parent."""
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
    name = flag[2:-5].replace("-", "_")
    names = {"lingru": ["lingru_fwd", "lingru_bwd"],
             "lingru_bf16": ["lingru_fwd_bf16", "lingru_bwd_bf16", "lingru_fwd", "lingru_bwd"],
             "bwd_bf16": ["gru_bwd_bf16", "gru_bwd"],
             }.get(name, [f"gru_{name}"])
    built = kernels.build(names)
    dev, rng = torch.device("cuda", 0), np.random.default_rng(SEED)
    if name == "lingru_bf16":
        # the precision phase's bars and timing, on streams of their own
        fwd_rng, bwd_rng = np.random.default_rng(SEED + 4), np.random.default_rng(SEED + 5)
        result = {
            "lingru_fwd_bf16": [
                check_bf16_kernel(torch, fg, fl, "lingru", B, dev, fwd_rng, timed=True, sweep=True)
                for B in BF16_LIN_BATCHES[::-1]],
            "lingru_bwd_bf16": [
                check_bf16_bwd_kernel(torch, fg, fl, "lingru", s, dev, bwd_rng, timed=True,
                                      sweep=True)
                for s in (LIN_TRAIN_SHAPE, LIN_INFER_SHAPE)]}
    elif name == "bwd_bf16":
        # the precision phase's stream, so the first two rows match its own
        bwd_rng = np.random.default_rng(SEED + 5)
        result = {"rows": [
            check_bf16_bwd_kernel(torch, fg, fl, "gru", shape, dev, bwd_rng, timed=True)
            for shape in (*BF16_GRU_BWD_SHAPES, BF16_GRU_BWD_WIDE_SHAPE)],
            "card_test": bf16_bwd_card_test(torch, fg, dev),
            "seeds": bf16_bwd_seeds(torch, fg, dev, BF16_GRU_BWD_SEEDS, yardstick=True),
            "plain_bmm_in_k_order": plain_bmm_order(torch, dev),
            "c2": c2_check(torch, fg, dev)}
        # C1's rule: the kernel's dxp lies beyond the bar from the float64
        # yardstick on no more seeds than the f32 plain loop's own
        kernel_n, plain_n = (len(result["seeds"][f"{who}_seeds_beyond_yardstick"])
                             for who in ("kernel", "plain"))
        if kernel_n > plain_n:
            fail(f"gru_bwd_bf16's dxp is beyond the bar from the float64 yardstick on {kernel_n} "
                 f"of {BF16_GRU_BWD_SEEDS} seeds, the plain loop's on {plain_n}")
    elif name == "fwd_bf16":
        # the precision phase's stream, so the rows match its own
        bf16_rng = np.random.default_rng(SEED + 4)
        result = {"rows": [check_bf16_kernel(torch, fg, fl, "gru", B, dev, bf16_rng, timed=True)
                           for B in BF16_GRU_BATCHES]}
    elif name == "bwd":
        result = check_bwd_kernel(torch, fg, TRAIN_SHAPE, dev, rng, timed=True)
    elif name == "fwd":
        result = {"rows": [check_kernel(torch, fg, s, dev, rng, timed=True)
                           for s in (MAIN_SHAPE, TRAIN_SHAPE)]}
    else:
        result = {f"lingru_{k}": [check_lingru(torch, fl, k, s, dev, rng, timed=True, sweep=True)
                                  for s in (LIN_INFER_SHAPE, LIN_TRAIN_SHAPE)]
                  for k in ("fwd", "bwd")}
    ptxas = {n: built.get(n, {}).get("ptxas") for n in names}
    result["ptxas_usage"] = {n: ptxas_usage(r) for n, r in ptxas.items() if r}
    emit({f"{name}_only": {"root": root, "package": os.path.dirname(kernels.__file__),
                           "ptxas": ptxas, **result, "card": card}})
    if name == "bwd_bf16" and not result["c2"]["kernel_within_bar"]:
        c2 = result["c2"]
        fail(f"gru_bwd_bf16 at {c2['shape']} is {c2['a_kernel_vs_reference']} of the largest "
             f"entry from the reference's golden, beyond {BF16_DW_OF_MAX}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if sys.argv[1:2] == ["--mesh-child"] and len(sys.argv) == 3:
        return mesh_child(torch, sys.argv[2])
    modes = (["--bwd-only"], ["--fwd-only"], ["--fwd-bf16-only"], ["--bwd-bf16-only"],
             ["--lingru-only"], ["--lingru-bf16-only"])
    if sys.argv[1:2] in modes and len(sys.argv) == 3:
        return one_kernel(torch, sys.argv[1], sys.argv[2])
    plane_only = sys.argv[1:] == ["--train-plane-only"]
    mesh_only = sys.argv[1:] == ["--mesh-only"]
    tp_sp_only = sys.argv[1:] == ["--tp-sp-only"]
    serve_only = sys.argv[1:] == ["--serve-only"]
    coldstart_only = sys.argv[1:] == ["--coldstart-only"]
    fleet_only = sys.argv[1:] == ["--fleet-only"]
    cascade_only = sys.argv[1:] == ["--cascade-only"]
    distpolish_only = sys.argv[1:] == ["--distpolish-only"]
    federation_only = sys.argv[1:] == ["--federation-only"]
    mesh_serve_only = sys.argv[1:] == ["--mesh-serve-only"]
    quality_only = sys.argv[1:] == ["--quality-only"]
    fleet_mesh_only = sys.argv[1:] == ["--fleet-mesh-only"]
    fleet_mix_only = sys.argv[1:] == ["--fleet-mix-only"]
    if sys.argv[1:] and not (plane_only or mesh_only or tp_sp_only or serve_only
                             or coldstart_only or fleet_only or cascade_only
                             or distpolish_only or federation_only or mesh_serve_only
                             or quality_only or fleet_mesh_only or fleet_mix_only):
        fail(f"unknown arguments {sys.argv[1:]}; usage: chip_smoke.py "
             "[--bwd-only ROOT | --fwd-only ROOT | --fwd-bf16-only ROOT | --bwd-bf16-only ROOT "
             "| --lingru-only ROOT | --lingru-bf16-only ROOT | --train-plane-only | --mesh-only "
             "| --tp-sp-only | --serve-only | --coldstart-only | --fleet-only | --cascade-only "
             "| --distpolish-only | --federation-only | --mesh-serve-only | --quality-only "
             "| --fleet-mesh-only | --fleet-mix-only]")
    sys.path.insert(0, ROOT)
    try:
        from roko_tpu_torch import benchmark as bench
        from roko_tpu_torch import constants as C
        from roko_tpu_torch import kernels
        from roko_tpu_torch.cascade import (
            Calibration,
            CascadeRouter,
            build_router,
            escalate_mask,
        )
        from roko_tpu_torch.compile.bundle import export_bundle
        from roko_tpu_torch.config import (
            CascadeConfig,
            DataConfig,
            DistPolishConfig,
            FleetConfig,
            GuardConfig,
            ModelConfig,
            RegionConfig,
            RokoConfig,
            ServeConfig,
            TrainConfig,
            resolve_ladder,
        )
        from roko_tpu_torch.datapipe.dataset import epoch_rng, holdout_size
        from roko_tpu_torch.datapipe.engine import iter_span_batches
        from roko_tpu_torch.eval.assess import assess_fastas
        from roko_tpu_torch.examples import synthetic_e2e
        from roko_tpu_torch.features import backend
        from roko_tpu_torch.features.extract import extract_windows
        from roko_tpu_torch.features.pipeline import open_region_stream
        from roko_tpu_torch.infer import (
            VoteBoard,
            polish_windows_to_fasta,
            predict,
            run_inference,
            tail_rungs,
            use_float32_matmuls,
        )
        from roko_tpu_torch.io.bam import BamReader
        from roko_tpu_torch.io.fasta import read_fasta, write_fasta
        from roko_tpu_torch.models import fused_gru as fg
        from roko_tpu_torch.models import fused_lingru as fl
        from roko_tpu_torch.models.convert import state_dict_from_jax
        from roko_tpu_torch.models.model import RokoModel
        from roko_tpu_torch.models.transformer import attention
        from roko_tpu_torch.native import binding as native_binding
        from roko_tpu_torch.native import build as native_build
        from roko_tpu_torch.parallel.tp import split_axis
        from roko_tpu_torch.pipeline import run_streaming_polish
        from roko_tpu_torch.serve.client import PolishClient
        from roko_tpu_torch.serve.metrics import ServeMetrics, parse_metric_values
        from roko_tpu_torch.serve.registry import register_model
        from roko_tpu_torch.serve.server import make_server
        from roko_tpu_torch.serve.session import PolishSession
        from roko_tpu_torch.sim import build_synthetic_project
        from roko_tpu_torch.training import loop
        from roko_tpu_torch.training.checkpoint import (
            CheckpointManager,
            load_params,
            verify_manifest,
        )
        from roko_tpu_torch.training.data import InMemoryDataset
        from roko_tpu_torch.utils.profiling import StageTimer
        from roko_tpu_torch.utils.rng import derive_region_seed
    except ImportError as e:
        fail(f"the port package roko_tpu_torch is not importable beside this script: {e}")
    port = types.SimpleNamespace(
        C=C, TrainConfig=TrainConfig, VoteBoard=VoteBoard, predict=predict,
        run_inference=run_inference, RokoModel=RokoModel, loop=loop,
        load_params=load_params, verify_manifest=verify_manifest,
        build_synthetic_project=build_synthetic_project, read_fasta=read_fasta,
        native_build=native_build, native_binding=native_binding, backend=backend,
        derive_region_seed=derive_region_seed, BamReader=BamReader,
        extract_windows=extract_windows, open_region_stream=open_region_stream,
        gru_recurrence_plain=fg.gru_recurrence_plain, fg=fg, fl=fl, RokoConfig=RokoConfig,
        resolve_ladder=resolve_ladder, tail_rungs=tail_rungs, PolishSession=PolishSession,
        run_streaming_polish=run_streaming_polish, ServeMetrics=ServeMetrics,
        StageTimer=StageTimer, write_fasta=write_fasta, assess_fastas=assess_fastas,
        bench=bench, InMemoryDataset=InMemoryDataset, GuardConfig=GuardConfig,
        DataConfig=DataConfig, iter_span_batches=iter_span_batches, epoch_rng=epoch_rng,
        ModelConfig=ModelConfig, state_dict_from_jax=state_dict_from_jax,
        polish_windows_to_fasta=polish_windows_to_fasta, attention=attention,
        split_axis=split_axis, make_server=make_server, PolishClient=PolishClient,
        ServeConfig=ServeConfig, parse_metric_values=parse_metric_values,
        CascadeConfig=CascadeConfig, DistPolishConfig=DistPolishConfig, FleetConfig=FleetConfig,
        Calibration=Calibration, CascadeRouter=CascadeRouter, build_router=build_router,
        escalate_mask=escalate_mask,
        export_bundle=export_bundle, register_model=register_model, RegionConfig=RegionConfig,
        e2e=synthetic_e2e, holdout_size=holdout_size, CheckpointManager=CheckpointManager,
    )
    counts = Counts(fg, fl)

    use_float32_matmuls()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    emit({"device": {"name": name, "count": torch.cuda.device_count(), "nvidia_smi": card,
                     "torch": torch.__version__, "cuda": torch.version.cuda}})

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build(["gru_fwd", "gru_bwd"] if plane_only or mesh_only
                          else ["gru_fwd", "gru_fwd_bf16", "lingru_fwd"] if serve_only
                          else ["gru_fwd", "lingru_fwd"] if cascade_only
                          else ["gru_fwd", "gru_bwd", "gru_fwd_bf16"] if quality_only
                          else ["gru_fwd"] if (coldstart_only or fleet_only or distpolish_only
                                               or federation_only or mesh_serve_only
                                               or fleet_mesh_only or fleet_mix_only)
                          else None)
    emit({"build": {"seconds": time.perf_counter() - t0, "kernels": built}})
    if coldstart_only:  # the coldstart phase alone
        emit({"coldstart": drive_coldstart(port, card)})
        return
    if fleet_only:  # the fleet phase alone
        emit({"fleet": drive_fleet(torch, port, dev, card)})
        return
    if fleet_mesh_only:  # one fleet worker of two ranks sharing the card
        emit({"fleet_mesh": drive_fleet_mesh(torch, port, dev, card)})
        return
    if fleet_mix_only:  # the bench's mixed-size fleet phase alone
        emit({"fleet_mix": drive_fleet_mix(torch, port, dev, card)})
        return
    if distpolish_only:  # polish --distributed from the command line, its own fleet
        emit({"distpolish": drive_distpolish_cli(torch, port, dev, card)})
        return
    if federation_only:  # the federation and the store, on a 100 kb project
        emit({"federation": drive_federation(torch, port, dev, card)})
        return
    if cascade_only:  # the cascade phase alone, on a 100 kb project
        rng = np.random.default_rng(SEED)
        models = []
        for kind, seed in (("gru", SEED), ("lingru", SEED + 1)):
            mcfg = ModelConfig(kind=kind)
            m = RokoModel(mcfg)
            m.load_state_dict(state_dict_from_jax(jax_layout_params(
                np.random.default_rng(seed), mcfg)), strict=True)
            models.append(m.to(dev).eval())
        inputs = small_project(port, os.path.join(ROOT, "build", "chip_smoke_cascade"))
        emit({"cascade": drive_cascade(torch, port, *models, dev, counts, inputs, card)})
        return
    if quality_only:  # the end-to-end quality loop alone
        emit({"quality": drive_quality(torch, port, dev, counts, card)})
        return
    if mesh_serve_only:  # one session over two gloo ranks sharing the card
        emit({"mesh_serve": drive_mesh_serve(torch, port, dev, counts, card)})
        return
    if serve_only:  # the serve phase alone
        emit({"serve": drive_serve(torch, port, dev, counts, card,
                                   np.random.default_rng(SEED + 22))})
        return
    if mesh_only:  # the mesh phase alone, the bench's mesh suite called directly
        t0 = time.perf_counter()
        bench_mesh = bench.run_mesh_suite(bench.parse_counts(MESH_DEVICES),
                                          iterations=BENCH_ITERS, device="cuda")
        bench_mesh["seconds"] = time.perf_counter() - t0
        emit({"mesh": drive_mesh(torch, port, torch.device("cuda", 0), counts, bench_mesh,
                                 card)})
        return
    if tp_sp_only:  # the tp_sp phase alone: the transformer launches no kernel
        emit({"tp_sp": drive_tp_sp(torch, port, dev, counts, card)})
        return
    if plane_only:  # the train_plane phase alone, on its own streams
        rng = np.random.default_rng(SEED)
        cfg = ModelConfig()
        model = RokoModel(cfg)
        model.load_state_dict(state_dict_from_jax(jax_layout_params(rng, cfg)), strict=True)
        draft, positions, examples = synthetic_contig(rng, PATH_BATCHES * PATH_BATCH_SIZE, C)
        batches = [(["synthetic"] * PATH_BATCH_SIZE, positions[i : i + PATH_BATCH_SIZE],
                    examples[i : i + PATH_BATCH_SIZE])
                   for i in range(0, len(examples), PATH_BATCH_SIZE)]
        emit({"train_plane": drive_train_plane(torch, port, cfg, batches, "synthetic", draft,
                                               dev, counts, card)})
        return

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
    path, _ = drive_inference(torch, port, model, fg.gru_recurrence_plain, batches, contig,
                              draft, dev, counts, "gru_fwd")
    launches = path["gru_fwd_launches"]
    emit({"path": {**path, "card": card}})
    # where the device time of the main path goes (a second, traced run)
    emit({"breakdown": {**device_breakdown(
        torch, lambda: run_inference(iter(batches), {contig: draft}, model, device=dev,
                                     log=lambda s: None)), "card": card}})

    # -- the polish path: FASTA + BAM -> features -> the gru model ----------
    polish = drive_polish(torch, port, model, dev, counts, card)
    emit({"polish": {k: v for k, v in polish.items() if not k.startswith("_")}})
    stream = drive_stream_polish(torch, port, model, dev, counts, card, polish,
                                 np.random.default_rng(SEED + 3))
    emit({"stream_polish": stream})

    lin_cfg = ModelConfig(kind="lingru")
    lin_model = RokoModel(lin_cfg)
    lin_model.load_state_dict(state_dict_from_jax(jax_layout_params(lin_rng, lin_cfg)),
                              strict=True)
    lin_model.to(dev).eval()
    lin_path, _ = drive_inference(torch, port, lin_model, fl.lingru_scan_plain, batches,
                                  contig, draft, dev, counts, "lingru_fwd")
    emit({"lingru_path": {**lin_path, "card": card}})
    # the default polish with the lingru model: streamed through the session
    # and batcher, byte-equal to its staged stitch
    lin_stream = stream_and_compare(torch, port, lin_model, dev, counts, polish, "lingru_fwd")
    lin_stream.pop("_run")
    emit({"stream_polish_lingru": {**lin_stream, "card": card}})
    emit({"lingru_breakdown": {**device_breakdown(
        torch, lambda: run_inference(iter(batches), {contig: draft}, lin_model, device=dev,
                                     log=lambda s: None)), "card": card}})
    # -- the cascade: tier 1 in front of the model, on the polish windows ---
    cascade = drive_cascade(torch, port, model, lin_model, dev, counts,
                            polish["_stream_inputs"], card)
    emit({"cascade": cascade})

    # -- the precision modes: bf16 kernels, bf16 and int8 inference, bf16 stream
    precision, bf16_rows, precision_launches = drive_precision(
        torch, port, model, lin_model, batches, contig, draft, dev, counts, polish, card,
        np.random.default_rng(SEED + 4))
    emit({"precision": precision})

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
    # the same in bf16 compute: the bf16 kernels only, the f32 line beside it
    gru_bf16, lin_bf16 = (dataclasses.replace(c, compute_dtype="bfloat16")
                          for c in (cfg, lin_cfg))
    emit({"train_step_check_bf16": {**step_parity(
        torch, port, dev, corpus, dataclasses.replace(gru_bf16, dropout=0.0), fg.gru_recurrence,
        fg.gru_recurrence_plain, rtol=0.0, atol_of_max=BF16_STEP_ATOL_OF_MAX), "card": card}})
    train_bf16, result_bf16, _ = drive_train(
        torch, port, gru_bf16, corpus, batches, contig, draft, dev, counts, "gru_fwd_bf16",
        "gru_bwd_bf16", "chip_smoke_train_bf16")
    emit({"train_bf16": {**train_bf16, "float32": bf16_beside(train), "card": card}})
    breakdown_bf16 = train_breakdown(torch, port, result_bf16, corpus, tcfg, dev)
    mma_calls = ran_bwd_bf16_mma("the gru bf16 train steps", breakdown_bf16)
    emit({"train_breakdown_bf16": {**breakdown_bf16, **mma_calls, "card": card}})

    emit({"lingru_train_step_check": {**step_parity(
        torch, port, dev, corpus, ModelConfig(kind="lingru", dropout=0.0), fl.lingru_scan,
        fl.lingru_scan_plain), "card": card}})
    lin_train, lin_result, _ = drive_train(
        torch, port, lin_cfg, corpus, batches, contig, draft, dev, counts, "lingru_fwd",
        "lingru_bwd", "chip_smoke_train_lingru")
    emit({"lingru_train": {**lin_train, "card": card}})
    emit({"lingru_train_breakdown": {
        **train_breakdown(torch, port, lin_result, corpus, tcfg, dev), "card": card}})
    emit({"lingru_train_step_check_bf16": {**step_parity(
        torch, port, dev, corpus, dataclasses.replace(lin_bf16, dropout=0.0), fl.lingru_scan,
        fl.lingru_scan_plain, rtol=0.0, atol_of_max=BF16_STEP_ATOL_OF_MAX), "card": card}})
    lin_train_bf16, lin_result_bf16, _ = drive_train(
        torch, port, lin_bf16, corpus, batches, contig, draft, dev, counts, "lingru_fwd_bf16",
        "lingru_bwd_bf16", "chip_smoke_train_lingru_bf16")
    emit({"lingru_train_bf16": {**lin_train_bf16, "float32": bf16_beside(lin_train),
                                "card": card}})
    lin_breakdown_bf16 = train_breakdown(torch, port, lin_result_bf16, corpus, tcfg, dev)
    ran_staged("the lingru bf16 train steps", lin_breakdown_bf16,
               ("lingru_fwd_bf16", "lingru_bwd_bf16"))
    emit({"lingru_train_breakdown_bf16": {**lin_breakdown_bf16, "card": card}})

    # -- the end-to-end quality loop: the example's recipe on true labels -----
    quality = drive_quality(torch, port, dev, counts, card)
    emit({"quality": quality})

    # -- kind="transformer": inference, stream polish, training; no kernels ---
    transformer = drive_transformer(
        torch, port, batches, contig, draft, dev, counts, polish, corpus, train, train_bf16,
        card, np.random.default_rng(SEED + 6))
    emit({"transformer": transformer})

    # -- the training data plane and run controls -----------------------------
    plane = drive_train_plane(torch, port, cfg, batches, contig, draft, dev, counts, card)
    emit({"train_plane": plane})

    # -- the bench: the system's own measurement entry point ----------------
    emit({"bench_kernel_check": {**bench_kernel_check(torch, port, dev),
                                 "atol": ATOL, "rtol": RTOL, "card": card}})
    bench_run = drive_bench(torch, port, counts)
    bench_launched = bench_run["launches"]
    emit({"bench": {**bench_run, "card": card}})

    # -- data parallelism across processes (the card shared by the ranks) ---
    mesh = drive_mesh(torch, port, dev, counts, bench_run["mesh"], card)
    emit({"mesh": mesh})
    # -- tensor and sequence parallelism of the transformer (ranks share the card)
    tp_sp = drive_tp_sp(torch, port, dev, counts, card)
    emit({"tp_sp": tp_sp})
    # -- the polishing service: subprocess, three batchers, bf16, drain ----
    serve = drive_serve(torch, port, dev, counts, card, np.random.default_rng(SEED + 22))
    emit({"serve": serve})
    serve_launches = {name: serve["launches"].get(name, 0) for name in counts.wrappers}
    # -- one session over two ranks sharing the card: serve and stream ---
    mesh_serve = drive_mesh_serve(torch, port, dev, counts, card)
    emit({"mesh_serve": mesh_serve})
    mesh_serve_fwd = (mesh_serve["serve_dp1"]["launches"]
                      + mesh_serve["stream"]["dp1"]["launches"]
                      + sum(r["serve"] + r["stream"] for r in mesh_serve["launches_by_rank"]))
    # -- cold start: four starts of a serve session, each a child process --
    coldstart = drive_coldstart(port, card)
    emit({"coldstart": coldstart})
    # -- the single-host fleet: bundles, registry, failover, rollout, drain
    fleet = drive_fleet(torch, port, dev, card, job_inputs=polish["_stream_inputs"])
    distpolish = fleet.pop("distpolish")
    emit({"fleet": fleet})
    # -- the distributed polish posted to that fleet, before its drain --
    emit({"distpolish": {**distpolish, "mode": "POST /job to the fleet phase's supervisor",
                         "unit_bases": DIST_UNIT_BASES, "card": card}})
    # -- the multi-host federation and the object-store data plane --------
    federation = drive_federation(torch, port, dev, card)
    emit({"federation": federation})
    # -- a fleet worker's session over two ranks, and the fleet's mixed sizes
    fleet_mesh = drive_fleet_mesh(torch, port, dev, card)
    emit({"fleet_mesh": fleet_mesh})
    fleet_mix = drive_fleet_mix(torch, port, dev, card)
    emit({"fleet_mix": fleet_mix})
    mesh_fwd = (mesh["nccl_world_1"]["launches"]["gru_fwd"]
                + sum(r["step"]["gru_fwd"] + r["train"]["gru_fwd"] + r["infer"]["gru_fwd"]
                      for r in mesh["gloo_2_ranks"]["launches_by_rank"])
                + mesh["gloo_2_ranks"]["launches_1_rank"]["gru_fwd"])
    mesh_bwd = (mesh["nccl_world_1"]["launches"]["gru_bwd"]
                + sum(r["step"]["gru_bwd"] + r["train"]["gru_bwd"]
                      for r in mesh["gloo_2_ranks"]["launches_by_rank"])
                + mesh["gloo_2_ranks"]["launches_1_rank"]["gru_bwd"])

    def timing(row):
        return {
            "shape": row["shape"], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{k: row[k] for k in ("ms_from", "library_note", "variant", "rows_per_block",
                                   "steps_per_stage", "stages", "blocks", "waves",
                                   "smem_bytes_per_block", "ms_by_kernel", "dw_pass", "f32_ms",
                                   "bit_equal_share", "atol", "max_ulps") if k in row},
        }

    def kernel_row(name, source, replaces, replaces_also, row, by_path, **also):
        # the transformer's paths launch no kernel (drive_transformer and
        # drive_tp_sp check it)
        by_path = {**by_path, "transformer": transformer["kernel_launches"],
                   "tp_sp": tp_sp["kernel_launches"], "serve": serve_launches[name]}
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_also": replaces_also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **timing(row), **{k: timing(r) for k, r in also.items()},
        }

    emit({"timeline": TIMELINE})
    emit({"kernels": [
        kernel_row("gru_fwd", "roko_tpu_torch/csrc/gru_fwd.cu",
                   "roko_tpu/models/pallas_gru.py:126", "roko_tpu/models/pallas_gru.py:171",
                   main_row, {"inference": launches, "polish": polish["gru_fwd_launches"],
                              "stream_polish": stream["gru_fwd_launches"], "train": train_fwd,
                              **precision_launches["gru_fwd"],
                              "train_plane": plane["launches"]["gru_fwd"],
                              "bench": bench_launched["gru_fwd"], "mesh": mesh_fwd,
                              "coldstart": coldstart["launches"]["gru_fwd"],
                              "fleet": fleet["launches"]["gru_fwd"],
                              "distpolish": distpolish["launches"]["gru_fwd"],
                              "mesh_serve": mesh_serve_fwd,
                              "cascade": cascade["launches"]["gru_fwd"],
                              "federation": federation["launches"]["gru_fwd"],
                              "quality": quality["launches"]["gru_fwd"],
                              "fleet_mesh": fleet_mesh["launches"]["gru_fwd"],
                              "fleet_mix": fleet_mix["launches"]["gru_fwd"]},
                   at_train_batch=fwd_train_row),
        kernel_row("gru_bwd", "roko_tpu_torch/csrc/gru_bwd.cu",
                   "roko_tpu/models/pallas_gru.py:200", "roko_tpu/models/pallas_gru.py:305",
                   bwd_row, {"inference": 0, "train": train_bwd,
                             "train_plane": plane["launches"]["gru_bwd"],
                             "bench": bench_launched["gru_bwd"], "mesh": mesh_bwd,
                             "quality": quality["launches"]["gru_bwd"]}),
        kernel_row("lingru_fwd", "roko_tpu_torch/csrc/lingru_fwd.cu",
                   "roko_tpu/models/pallas_lingru.py:90", None, lin_fwd_row,
                   {"inference": lin_path["lingru_fwd_launches"],
                    "stream_polish": lin_stream["lingru_fwd_launches"],
                    "cascade": cascade["launches"]["lingru_fwd"],
                    "train": lin_train["lingru_fwd_launches"],
                    "bench": bench_launched["lingru_fwd"]},
                   at_train_batch=lin_fwd_train_row),
        kernel_row("lingru_bwd", "roko_tpu_torch/csrc/lingru_bwd.cu",
                   "roko_tpu/models/pallas_lingru.py:121", None, lin_bwd_row,
                   {"inference": 0, "train": lin_train["lingru_bwd_launches"],
                    "bench": bench_launched["lingru_bwd"]}),
        kernel_row("gru_fwd_bf16", "roko_tpu_torch/csrc/gru_fwd_bf16.cu",
                   "roko_tpu/models/pallas_gru.py:126", "roko_tpu/models/pallas_gru.py:171",
                   bf16_rows["gru_fwd_bf16"][-1],
                   {**precision_launches["gru_fwd_bf16"],
                    "train": train_bf16["gru_fwd_bf16_launches"],
                    "bench": bench_launched["gru_fwd_bf16"],
                    "quality": quality["launches"]["gru_fwd_bf16"]},
                   at_batch_128=bf16_rows["gru_fwd_bf16"][1]),
        kernel_row("lingru_fwd_bf16", "roko_tpu_torch/csrc/lingru_fwd_bf16.cu",
                   "roko_tpu/models/pallas_lingru.py:90", None, bf16_rows["lingru_fwd_bf16"][-1],
                   {**precision_launches["lingru_fwd_bf16"],
                    "train": lin_train_bf16["lingru_fwd_bf16_launches"],
                    "bench": bench_launched["lingru_fwd_bf16"]},
                   at_batch_128=bf16_rows["lingru_fwd_bf16"][0]),
        kernel_row("gru_bwd_bf16", "roko_tpu_torch/csrc/gru_bwd_bf16.cu",
                   "roko_tpu/models/pallas_gru.py:200", "roko_tpu/models/pallas_gru.py:305",
                   bf16_rows["gru_bwd_bf16"][0],
                   {"inference": 0, "train": train_bf16["gru_bwd_bf16_launches"],
                    "bench": bench_launched["gru_bwd_bf16"]}),
        kernel_row("lingru_bwd_bf16", "roko_tpu_torch/csrc/lingru_bwd_bf16.cu",
                   "roko_tpu/models/pallas_lingru.py:121", None, bf16_rows["lingru_bwd_bf16"][0],
                   {"inference": 0, "train": lin_train_bf16["lingru_bwd_bf16_launches"],
                    "bench": bench_launched["lingru_bwd_bf16"]}),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
