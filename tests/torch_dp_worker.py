"""One rank of the port's data-parallel CPU tests (gloo).

Started by ``tests/test_torch_parallel.py`` and
``tests/test_torch_multiprocess.py`` as ``python -m tests.torch_dp_worker
MODE OUT_DIR`` once per rank, with ``ROKO_COORDINATOR``,
``ROKO_NUM_PROCESSES`` and ``ROKO_PROCESS_ID`` set. It imports torch and
the port only (no JAX): the test process computes the one-process and
reference numbers and compares. Each mode writes ``rank{r}.pt`` (or the
files it names) under OUT_DIR and prints ``RANK_{r}_OK``.

- ``steps``: on a tiny model of each kind, one ``grad_step`` at a global
  batch with uneven padding rows, dropout on and off; then K Adam steps
  of the gru model with dropout on; then ``evaluate`` of a small corpus.
- ``cli``: ``python -m roko_tpu_torch train``, ``inference`` and
  ``polish`` with ``--dp 2`` through ``cli.main``, counting each rank's
  checkpoint writes; ``polish --keep-hdf5`` and ``--resume``, which two
  processes refuse; then ``crosscheck_fingerprint`` with rank 1 on
  another corpus.
- ``resume``: ``loop.train`` for two epochs saving ``latest`` every
  step; the same run stopped on every rank inside the second epoch and
  resumed from its checkpoint; both runs' parameters.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.parallel import distributed
from roko_tpu_torch.parallel.mesh import make_mesh, shard_batch
from roko_tpu_torch.training.data import InMemoryDataset
from roko_tpu_torch.training.loop import evaluate, grad_step, make_optimizer, to_device

#: the port's counterpart of the reference tests' TINY_GRU, dropout on
TINY = ModelConfig(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2, dropout=0.2)
KINDS = {"gru": TINY, "lingru": dataclasses.replace(TINY, kind="lingru"),
         "transformer": dataclasses.replace(TINY, kind="transformer", d_model=32, num_heads=4)}
#: global batch of the step tests: rank 0's rows are all real, rank 1's
#: hold one real row and three of padding
GLOBAL_BATCH, REAL_ROWS = 8, 5
K_STEPS, LR = 3, 1e-2
DROPOUT_SEED = 11
EVAL_WINDOWS, EVAL_BATCH = 20, 8
#: the resume run: 4 steps an epoch at 2 ranks; stopped at the 7th step
#: (the second epoch's third batch), after ``latest`` saved the 6th
RESUME_WINDOWS, RESUME_BLOCK, RESUME_BATCH, RESUME_STOP_AT = 64, 8, 16, 7


def global_batch(n: int = GLOBAL_BATCH, n_real: int = REAL_ROWS, seed: int = 7):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, C.FEATURE_VOCAB, (n, C.WINDOW_ROWS, C.WINDOW_COLS), dtype=np.uint8)
    y = rng.integers(0, C.NUM_CLASSES, (n, C.WINDOW_COLS)).astype(np.int32)
    w = (np.arange(n) < n_real).astype(np.float32)
    return x, y, w


def fresh_model(cfg: ModelConfig) -> RokoModel:
    return RokoModel(cfg, torch.Generator().manual_seed(3))


def eval_corpus() -> InMemoryDataset:
    x, y, _ = global_batch(EVAL_WINDOWS, EVAL_WINDOWS, seed=21)
    return InMemoryDataset(x, y)


def one_step(model, batch, mesh, seed):
    """(loss, finite, {name: grad}) of one grad_step, dropout drawn from
    a generator seeded ``seed`` (None: no generator)."""
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    x, y, w = to_device(batch, torch.device("cpu"))
    loss, finite = grad_step(model, x, y, w, gen, mesh)
    return float(loss), bool(finite), {n: p.grad.clone() for n, p in model.named_parameters()}


def mode_steps(out_dir: str) -> None:
    mesh = make_mesh()
    batch = global_batch()
    local = shard_batch(mesh, batch)
    res = {"rank": mesh.rank, "dp": mesh.dp, "local_w": local[2].tolist(), "steps": {}}
    for kind, cfg in KINDS.items():
        for dropout in (True, False):
            model = fresh_model(cfg if dropout else dataclasses.replace(cfg, dropout=0.0))
            res["steps"][f"{kind}/{'dropout' if dropout else 'nodrop'}"] = {
                "state": {k: v.clone() for k, v in model.state_dict().items()},
                "result": one_step(model, local, mesh, DROPOUT_SEED if dropout else None),
            }
    # K Adam steps of the gru model, dropout on, a batch of its own each
    model = fresh_model(TINY)
    opt = make_optimizer(model, LR)
    losses = []
    for k in range(K_STEPS):
        loss, _, _ = one_step(model, shard_batch(mesh, global_batch(seed=100 + k)), mesh,
                              DROPOUT_SEED + k)
        opt.step()
        losses.append(loss)
    res["k_steps"] = {"losses": losses,
                      "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    res["evaluate"] = evaluate(fresh_model(TINY), eval_corpus(), EVAL_BATCH,
                               torch.device("cpu"), mesh)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def unsorted_draft(infer_h5: str):
    """({name: draft} of ``infer_h5``'s contigs in the order ctgB, ctgA,
    ctgC, not sorted by name; windows(only)), as ``infer.polish_windows_
    to_fasta`` reads them."""
    from roko_tpu_torch.data.hdf5 import iter_inference_windows, load_contigs

    contigs = load_contigs(infer_h5)
    return ({name: contigs[name] for name in ("ctgB", "ctgA", "ctgC")},
            lambda only: iter_inference_windows(infer_h5, 16, contig_filter=only))


def mode_cli(out_dir: str, *argv: str) -> None:
    """``argv``: train.hdf5 other.hdf5 infer.hdf5 draft.fasta reads.bam,
    then the model flags."""
    from roko_tpu_torch import cli
    from roko_tpu_torch.datapipe.manifest import (
        ManifestMismatch,
        build_manifest,
        crosscheck_fingerprint,
    )
    from roko_tpu_torch.training import checkpoint

    train_h5, other_h5, infer_h5, draft, bam, *flags = argv
    writes = []
    write = checkpoint.CheckpointManager._write

    def counted(self, name, state, val_acc):
        writes.append(str(name))
        return write(self, name, state, val_acc)

    checkpoint.CheckpointManager._write = counted
    ckpt = os.path.join(out_dir, "ckpt")
    rc_train = cli.main(["train", train_h5, ckpt, "--b", "16", "--epochs", "1", "--lr", "1e-2",
                         "--data-block-size", "8", "--dp", "2", "--device", "cpu", *flags])
    rank = distributed.rank()
    rc_infer = cli.main(["inference", infer_h5, ckpt, os.path.join(out_dir, "polished.fasta"),
                         "--b", "16", "--dp", "2", "--device", "cpu", *flags])
    rc_polish = cli.main(["polish", draft, bam, ckpt, os.path.join(out_dir, "polish.fasta"),
                          "--b", "16", "--dp", "2", "--device", "cpu", *flags])
    # a draft whose names are not sorted
    from roko_tpu_torch.infer import polish_windows_to_fasta
    from roko_tpu_torch.training.checkpoint import load_params

    model = RokoModel(ModelConfig(hidden_size=16, num_layers=1))
    model.load_state_dict(load_params(ckpt), strict=True)
    unsorted_returned = polish_windows_to_fasta(
        *unsorted_draft(infer_h5), model, os.path.join(out_dir, "unsorted.fasta"),
        device="cpu", log=lambda s: None)
    refused = {}
    for extra in (["--keep-hdf5", os.path.join(out_dir, "kept.hdf5")], ["--resume"]):
        try:
            cli.main(["polish", draft, bam, ckpt, os.path.join(out_dir, "refused.fasta"),
                      *extra, "--dp", "2", "--device", "cpu", *flags])
        except SystemExit as e:
            refused[extra[0]] = str(e.code)
    manifest, _ = build_manifest(train_h5 if rank == 0 else other_h5)
    try:
        crosscheck_fingerprint(manifest)
        mismatch = None
    except ManifestMismatch as e:
        mismatch = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rc_train": rc_train, "rc_infer": rc_infer, "rc_polish": rc_polish,
                   "unsorted_returned": unsorted_returned,
                   "refused": refused, "writes": writes,
                   "world": distributed.world_size(), "mismatch": mismatch}, f)


class Stop(Exception):
    """Ends a run inside an epoch, on every rank at the same step."""


def mode_resume(out_dir: str) -> None:
    from roko_tpu_torch.config import DataConfig, GuardConfig, TrainConfig
    from roko_tpu_torch.training import loop

    x, y, _ = global_batch(RESUME_WINDOWS, RESUME_WINDOWS, seed=31)
    corpus = InMemoryDataset(x, y)
    kw = dict(model_cfg=TINY, train_cfg=TrainConfig(batch_size=RESUME_BATCH, epochs=2, lr=LR,
                                                    log_every_steps=0),
              guard_cfg=GuardConfig(save_every_steps=1),
              data_cfg=DataConfig(block_size=RESUME_BLOCK), device="cpu")
    full = loop.train(corpus, os.path.join(out_dir, "full"), **kw)
    real, calls = loop.grad_step, []

    def stopping(*args):
        calls.append(1)
        if len(calls) == RESUME_STOP_AT:
            raise Stop
        return real(*args)

    loop.grad_step = stopping
    try:
        loop.train(corpus, os.path.join(out_dir, "cut"), **kw)
    except Stop:
        pass
    loop.grad_step = real
    logs = []
    resumed = loop.train(corpus, os.path.join(out_dir, "cut"), log=logs.append, **kw)
    torch.save({"full": {n: p.detach() for n, p in full.model.named_parameters()},
                "resumed": {n: p.detach() for n, p in resumed.model.named_parameters()},
                "steps": (full.step, resumed.step), "log": logs},
               os.path.join(out_dir, f"rank{distributed.rank()}.pt"))


def launch(mode: str, out_dir: str, *args: str, ranks: int = 2, timeout: float = 300.0,
           module: str = "tests.torch_dp_worker"):
    """Run ``ranks`` processes of ``mode`` of the worker ``module`` on
    localhost; returns their outputs, and raises with them when a rank
    fails or outlasts ``timeout`` seconds (a lost rank would otherwise hang
    its peers)."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("ROKO_")}
    env.update(ROKO_COORDINATOR=f"127.0.0.1:{port}", ROKO_NUM_PROCESSES=str(ranks),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", module, mode, out_dir,
                               *args], cwd=root, env={**env, "ROKO_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"RANK_{r}_OK" not in out:
            raise RuntimeError(f"rank {r} of {mode} failed (rc {p.returncode}):\n{out[-4000:]}")
    return outs


def main() -> None:
    torch.set_num_threads(1)
    mode, out_dir, *rest = sys.argv[1:]
    distributed.initialize(device="cpu")
    {"steps": mode_steps, "cli": mode_cli, "resume": mode_resume}[mode](out_dir, *rest)
    print(f"RANK_{distributed.rank()}_OK", flush=True)
    distributed.shutdown()


if __name__ == "__main__":
    main()
