"""One rank of the port's tensor- and sequence-parallel CPU tests (gloo).

Started by ``tests/test_torch_ring.py`` and ``tests/test_torch_tp.py``
through ``tests.torch_dp_worker.launch(..., module="tests.torch_tp_worker")``
once per rank, with ``ROKO_COORDINATOR``, ``ROKO_NUM_PROCESSES`` and
``ROKO_PROCESS_ID`` set. It imports torch and the port only (no JAX): the
test process computes the one-process and reference numbers, assembles
the ranks' blocks and compares. Each mode writes ``rank{r}.pt`` under
OUT_DIR and prints ``RANK_{r}_OK``.

- ``ring`` (6 ranks): on grids dp=3 x sp=2 and dp=2 x sp=3, each rank's
  column block of ``ring_attention`` and of its q/k/v gradients, and of
  the whole encoder with the ring; the rotation's transport.
- ``grid`` (2 or 4 ranks): for each layout of ``LAYOUTS[world]``, the
  transformer's (and the gru's, where named) eval logits and one
  ``grad_step`` with dropout 0.2 and off, each rank's block; 3 Adam steps;
  with 4 ranks, ``loop.train`` at dp=2 x tp=2 and its resume; with 2
  ranks, ``train``, ``inference`` and ``polish`` through ``cli.main`` at
  ``--tp 2`` and ``--sp 2``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from roko_tpu_torch.config import MeshConfig
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.parallel import distributed, ring
from roko_tpu_torch.parallel.mesh import make_mesh, shard_batch
from roko_tpu_torch.parallel.tp import gather_state_dict
from roko_tpu_torch.training.loop import make_optimizer
from tests import torch_dp_worker as W

TRANSFORMER = W.KINDS["transformer"]
#: ring inputs: rows, columns, width, heads
RING_B, RING_T, RING_D, RING_H = 4, 48, 32, 4
RING_GRIDS = {2: MeshConfig(dp=3, sp=2), 3: MeshConfig(dp=2, sp=3)}
#: the layouts of each world size: name -> (mesh, kinds)
LAYOUTS = {
    2: {"tp2": (MeshConfig(dp=1, tp=2), ("transformer", "gru")),
        "sp2": (MeshConfig(dp=1, sp=2), ("transformer",)),
        "dp2": (MeshConfig(dp=2), ("gru",))},
    4: {"tp2sp2": (MeshConfig(dp=1, tp=2, sp=2), ("transformer",)),
        "dp2tp2": (MeshConfig(dp=2, tp=2), ("transformer",))},
}
#: the layouts that take K Adam steps
ADAM_LAYOUTS = ("tp2sp2", "dp2tp2")
#: the model flags of the command-line runs
CLI_FLAGS = ["--model-kind", "transformer", "--hidden-size", "16", "--d-model", "32",
             "--num-heads", "4", "--num-layers", "1"]
TRAIN_WINDOWS, TRAIN_BATCH, TRAIN_BLOCK = 32, 8, 8


def ring_inputs(seed: int = 5):
    """q, k, v and the output's cotangent, [B, T, D] float32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((RING_B, RING_T, RING_D)).astype(np.float32) for _ in range(4)]


def encoder_input(seed: int = 6):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((RING_B, 90, TRANSFORMER.gru_in_size)).astype(np.float32)


def coords(mesh):
    return (mesh.d, mesh.t, mesh.s)


def mode_ring(out_dir: str) -> None:
    res = {"rank": distributed.rank(), "grids": {}}
    for sp, cfg in RING_GRIDS.items():
        mesh = make_mesh(cfg)
        cols = ring.column_block(mesh, RING_T)
        q, k, v, ct = (torch.from_numpy(a[:, cols]).requires_grad_(i < 3)
                       for i, a in enumerate(ring_inputs()))
        out = ring.ring_attention(q, k, v, RING_H, mesh)
        (out * ct).sum().backward()
        enc = layout_model("transformer", mesh).encoder
        ecols = ring.column_block(mesh, 90)
        with torch.no_grad():
            h = enc(torch.from_numpy(encoder_input()[:, ecols]), offset=ecols.start)
        res["grids"][sp] = {"coords": coords(mesh), "out": out.detach(), "dq": q.grad,
                            "dk": k.grad, "dv": v.grad, "encoder": h,
                            "transport": ring.transport(q.device)}
    torch.save(res, os.path.join(out_dir, f"rank{distributed.rank()}.pt"))


def layout_model(kind: str, mesh, dropout: bool = True) -> RokoModel:
    cfg = W.KINDS[kind] if dropout else dataclasses.replace(W.KINDS[kind], dropout=0.0)
    return RokoModel(cfg, torch.Generator().manual_seed(3), mesh=mesh)


def mode_grid(out_dir: str, *argv: str) -> None:
    world = distributed.world_size()
    res = {"rank": distributed.rank(), "layouts": {}}
    for name, (cfg, kinds) in LAYOUTS[world].items():
        mesh = make_mesh(cfg)
        row = {"coords": coords(mesh), "sizes": (mesh.dp, mesh.tp, mesh.sp), "groups": {
            axis: None if g is None else dist.get_process_group_ranks(g)
            for axis, g in (("dp", mesh.dp_group), ("tp", mesh.tp_group),
                            ("sp", mesh.sp_group), ("dp_sp", mesh.dp_sp_group))}}
        batch = shard_batch(mesh, W.global_batch())
        for kind in kinds:
            model = layout_model(kind, mesh)
            with torch.no_grad():
                row[f"{kind}/logits"] = model(torch.from_numpy(batch[0]))
            for drop in (True, False):
                model = layout_model(kind, mesh, drop)
                row[f"{kind}/{'dropout' if drop else 'nodrop'}"] = W.one_step(
                    model, batch, mesh, W.DROPOUT_SEED if drop else None)
        if name in ADAM_LAYOUTS:
            model = layout_model("transformer", mesh)
            opt = make_optimizer(model, W.LR)
            losses = []
            for k in range(W.K_STEPS):
                loss, _, _ = W.one_step(model, shard_batch(mesh, W.global_batch(seed=100 + k)),
                                        mesh, W.DROPOUT_SEED + k)
                opt.step()
                losses.append(loss)
            row["k_steps"] = {"losses": losses, "params": {
                n: p.detach().clone() for n, p in model.named_parameters()}}
        res["layouts"][name] = row
    if world == 4:
        res["train"] = train_and_resume(out_dir)
    else:
        res["cli"] = cli_runs(out_dir, *argv)
    torch.save(res, os.path.join(out_dir, f"rank{distributed.rank()}.pt"))


def train_corpus():
    from roko_tpu_torch.training.data import InMemoryDataset

    x, y, _ = W.global_batch(TRAIN_WINDOWS, TRAIN_WINDOWS, seed=41)
    return InMemoryDataset(x, y)


def train_and_resume(out_dir: str) -> dict:
    """``loop.train`` on dp=2 x tp=2 for one epoch, its parameters
    gathered; then the same run taken on to a second epoch by a resume."""
    from roko_tpu_torch.config import DataConfig, TrainConfig
    from roko_tpu_torch.training import loop

    ckpt = os.path.join(out_dir, "ckpt")
    kw = dict(model_cfg=TRANSFORMER, data_cfg=DataConfig(block_size=TRAIN_BLOCK),
              mesh_cfg=MeshConfig(dp=2, tp=2), device="cpu", log=lambda s: None)
    one = loop.train(train_corpus(), ckpt, **kw, train_cfg=TrainConfig(
        batch_size=TRAIN_BATCH, epochs=1, lr=W.LR, log_every_steps=0))
    mesh = make_mesh(MeshConfig(dp=2, tp=2))
    full = gather_state_dict(TRANSFORMER, one.model.state_dict(), mesh)
    logs = []
    two = loop.train(train_corpus(), ckpt, **{**kw, "log": logs.append}, train_cfg=TrainConfig(
        batch_size=TRAIN_BATCH, epochs=2, lr=W.LR, log_every_steps=0))
    return {"full": full, "steps": (one.step, two.step), "log": logs,
            "resumed": gather_state_dict(TRANSFORMER, two.model.state_dict(), mesh)}


def cli_runs(out_dir: str, train_h5: str, infer_h5: str, draft: str, bam: str) -> dict:
    """``train --tp 2``, then ``inference`` at ``--tp 2`` and ``--sp 2`` and
    ``polish --sp 2``, through ``cli.main``; their exit codes."""
    from roko_tpu_torch import cli

    ckpt = os.path.join(out_dir, "ckpt")
    common = ["--b", "8", "--device", "cpu", *CLI_FLAGS]
    rcs = {"train": cli.main(["train", train_h5, ckpt, "--epochs", "1", "--lr", "1e-2",
                              "--data-block-size", "8", "--tp", "2", *common])}
    for axis in ("tp", "sp"):
        rcs[f"inference_{axis}"] = cli.main([
            "inference", infer_h5, ckpt, os.path.join(out_dir, f"{axis}.fasta"),
            f"--{axis}", "2", *common])
    rcs["polish_sp"] = cli.main(["polish", draft, bam, ckpt,
                                 os.path.join(out_dir, "polish_sp.fasta"), "--sp", "2",
                                 *common])
    return rcs


def main() -> None:
    torch.set_num_threads(1)
    mode, out_dir, *rest = sys.argv[1:]
    distributed.initialize(device="cpu")
    {"ring": mode_ring, "grid": mode_grid}[mode](out_dir, *rest)
    print(f"RANK_{distributed.rank()}_OK", flush=True)
    distributed.shutdown()


if __name__ == "__main__":
    main()
