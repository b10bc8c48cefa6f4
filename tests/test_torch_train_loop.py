"""The port's train loop on the CPU: the guard against
``roko_tpu.training.guard.TrainGuard``, the checkpoint integrity chain,
resume, rollback, a short run against ``roko_tpu.training.loop.train``,
and the ``train`` / ``inference`` command line for both kinds."""

import dataclasses
import math
import os
import re

import numpy as np
import pytest

import jax
import torch

from roko_tpu import constants as JC
from roko_tpu.config import GuardConfig as JaxGuardConfig
from roko_tpu.config import MeshConfig, RokoConfig
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.config import TrainConfig as JaxTrainConfig
from roko_tpu.data.hdf5 import DataWriter
from roko_tpu.features.pipeline import run_features
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.parallel.mesh import make_mesh
from roko_tpu.sim import build_synthetic_project
from roko_tpu.training import guard as jguard
from roko_tpu.training.loop import train as jax_train
from roko_tpu_torch import cli
from roko_tpu_torch.config import GuardConfig, ModelConfig, TrainConfig
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.training import checkpoint as ck
from roko_tpu_torch.training import guard as pguard
from roko_tpu_torch.training import loop
from roko_tpu_torch.training.data import InMemoryDataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = ModelConfig(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2)


def _windows(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, JC.FEATURE_VOCAB, (n, JC.WINDOW_ROWS, JC.WINDOW_COLS)).astype(np.uint8)
    return X, (X.sum(axis=1) % JC.NUM_CLASSES).astype(np.int64)


# -- guard -----------------------------------------------------------------

SCRIPT = [1.0, 1.1, 0.9, 1.0, 1.05, 0.95, 50.0, 1.0, float("nan"), 1.02, 0.97,
          ("grads", 1.0), 60.0, float("inf"), 70.0, 1.0]


def _run_guard(guard, rollback_cls):
    decisions = []
    for step, item in enumerate(SCRIPT):
        loss, finite = (item[1], False) if isinstance(item, tuple) else (item, True)
        try:
            decisions.append(guard.check(step, loss, finite))
        except rollback_cls as rb:
            decisions.append(("rollback", rb.reason, rb.step))
            guard.note_rollback()
    return decisions


def test_guard_decisions_match_reference():
    kw = dict(warmup_steps=3, max_bad_steps=3, spike_sigma=6.0, ema_beta=0.9)
    plog, jlog = [], []
    port = pguard.TrainGuard(GuardConfig(**kw), plog.append)
    ref = jguard.TrainGuard(JaxGuardConfig(**kw), jlog.append)
    got = _run_guard(port, pguard.RollbackRequested)
    want = _run_guard(ref, jguard.RollbackRequested)
    assert got == want
    assert ("rollback", "nonfinite", 13) in got and got.count(False) == 4
    assert plog == jlog  # the same ROKO_GUARD lines
    assert port.counters == ref.counters and port.summary() == ref.summary()
    sp, sr = port.state_dict(), ref.state_dict()
    assert sp.keys() == sr.keys()
    for k in sp:
        assert sp[k] == sr[k] or (math.isnan(sp[k]) and math.isnan(sr[k]))


def test_guard_state_round_trips():
    g = pguard.TrainGuard(GuardConfig(warmup_steps=2), lambda s: None)
    for i, loss in enumerate([1.0, 0.9, 0.8, 0.85]):
        g.check(i, loss, True)
    h = pguard.TrainGuard(GuardConfig(warmup_steps=2), lambda s: None)
    h.load_state(g.state_dict())
    assert h.spike_threshold() == g.spike_threshold()
    with pytest.raises(pguard.RollbackRequested):
        h.params_nonfinite(7)


# -- checkpoints -------------------------------------------------------------

def _state(v):
    return {"model": {"w": torch.full((3,), float(v))}, "step": v}


def test_checkpoints_keep_best_and_verify(tmp_path):
    logs = []
    mgr = ck.CheckpointManager(str(tmp_path), keep=2, log=logs.append)
    for step, acc in ((10, 0.5), (20, 0.7), (30, 0.6), (40, 0.4)):
        mgr.save(step, _state(step), acc)
    assert sorted(n for n in os.listdir(tmp_path)) == ["20", "30", "latest"]
    for name in ("20", "30", "latest"):
        assert ck.verify_manifest(str(tmp_path / name))[0] == "ok"
    assert mgr.best_step() == 20
    assert mgr.restore_latest()["step"] == 40
    assert ck.load_params(str(tmp_path))["w"][0].item() == 20.0
    assert not logs


@pytest.mark.parametrize("damage", ["truncate", "delete", "no_manifest"])
def test_restore_falls_back_past_a_damaged_checkpoint(tmp_path, damage):
    logs = []
    mgr = ck.CheckpointManager(str(tmp_path), keep=3, log=logs.append)
    mgr.save(1, _state(1), 0.5)
    mgr.save(2, _state(2), 0.6)
    latest = tmp_path / "latest"
    if damage == "truncate":
        data = (latest / ck.STATE_NAME).read_bytes()
        (latest / ck.STATE_NAME).write_bytes(data[: len(data) // 2])
    elif damage == "delete":
        os.remove(latest / ck.STATE_NAME)
    else:
        os.remove(latest / ck.MANIFEST_NAME)  # a save killed before its commit
    assert mgr.restore_latest()["step"] == 2  # the numbered copy of step 2
    assert any("event=ckpt_corrupt" in line for line in logs)


def test_no_verified_checkpoint_raises(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=3, log=lambda s: None)
    assert mgr.restore_latest() is None
    mgr.save(1, _state(1), 0.5)
    for name in ("1", "latest"):
        os.remove(tmp_path / name / ck.STATE_NAME)
    with pytest.raises(ck.CheckpointIntegrityError):
        mgr.restore_latest()
    with pytest.raises(ck.CheckpointIntegrityError):
        ck.load_params(str(tmp_path))


# -- the loop ------------------------------------------------------------------

def _tiny_run(tmp_path, name, epochs, **kw):
    X, Y = _windows(40, 1)
    return loop.train(
        InMemoryDataset(X, Y), str(tmp_path / name), model_cfg=TINY,
        train_cfg=TrainConfig(batch_size=8, epochs=epochs, lr=3e-3, val_fraction=0.2),
        device="cpu", log=kw.pop("log", lambda s: None), **kw,
    )


def test_resume_gives_the_same_end_state(tmp_path):
    """Dropout on (0.2): a run cut after one epoch and resumed ends where
    an uninterrupted run ends, bit for bit."""
    full = _tiny_run(tmp_path, "full", 2)
    _tiny_run(tmp_path, "cut", 1)
    logs = []
    resumed = _tiny_run(tmp_path, "cut", 2, log=logs.append)
    assert any(line.startswith("resumed from step 4 (epoch 1") for line in logs)
    assert full.step == resumed.step == 8
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert full.history[1]["val_acc"] == resumed.history[0]["val_acc"]


def test_resume_refuses_another_data_stream(tmp_path):
    _tiny_run(tmp_path, "a", 1)
    X, Y = _windows(40, 2)
    with pytest.raises(RuntimeError, match="refusing to resume"):
        loop.train(InMemoryDataset(X, Y), str(tmp_path / "a"), model_cfg=TINY,
                   train_cfg=TrainConfig(batch_size=8, epochs=2, val_fraction=0.2),
                   device="cpu", log=lambda s: None)


def test_bad_steps_skip_then_roll_back(tmp_path, monkeypatch):
    """Three non-finite steps in a row roll back to the last checkpoint
    and the run finishes; a fault before the first save is an error."""
    real = loop.grad_step
    calls = {"n": 0}

    def faulty(model, x, y, w, gen, mesh=None):
        calls["n"] += 1
        loss, finite = real(model, x, y, w, gen, mesh)
        if 6 <= calls["n"] <= 8:  # three steps of the second epoch, once
            return loss * float("nan"), torch.zeros((), dtype=torch.bool)
        return loss, finite

    monkeypatch.setattr(loop, "grad_step", faulty)
    logs = []
    result = _tiny_run(tmp_path, "rb", 3, log=logs.append)
    assert sum("event=skip reason=nonfinite" in line for line in logs) == 3
    assert any("event=rollback reason=nonfinite" in line for line in logs)
    assert [h["epoch"] for h in result.history] == [1, 2]  # resumed after epoch 0
    assert all(torch.isfinite(p).all() for p in result.model.parameters())

    calls["n"] = 5
    with pytest.raises(RuntimeError, match="no checkpoint exists yet"):
        _tiny_run(tmp_path, "early", 1)


def short_run_against_reference(tmp_path):
    """TINY config, dropout 0, 96 windows, batch 16, 3 epochs, lr 3e-3,
    a 25 % holdout: ``roko_tpu``'s train (dp=1) and the port's from the
    same init and stream. Returns (port history, JAX val accuracies)."""
    jcfg = JaxModelConfig(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2,
                          dropout=0.0)
    X, Y = _windows(96, 4)
    path = str(tmp_path / "train.hdf5")
    pos = [np.stack([np.arange(JC.WINDOW_COLS), np.zeros(JC.WINDOW_COLS)], 1)] * len(X)
    with DataWriter(path, infer=False) as w:
        w.write_contigs([("c", "ACGT" * 100)])
        w.store("c", pos, list(X), list(Y))
    tcfg = dict(batch_size=16, epochs=3, lr=3e-3, seed=0, val_fraction=0.25)
    jlogs = []
    jax_train(RokoConfig(model=jcfg, train=JaxTrainConfig(**tcfg)), path,
              str(tmp_path / "jax"), mesh=make_mesh(MeshConfig(dp=1), jax.devices()[:1]),
              log=jlogs.append)
    want = [float(m.group(1)) for m in (re.search(r"val_acc ([0-9.]+)", s) for s in jlogs) if m]

    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, JaxRokoModel(jcfg).init(init_rng))
    got = loop.train(path, str(tmp_path / "port"),
                     model_cfg=dataclasses.replace(TINY, dropout=0.0),
                     train_cfg=TrainConfig(**tcfg), device="cpu",
                     init_params=state_dict_from_jax(params), log=lambda s: None)
    return got.history, want


def test_short_run_tracks_reference(tmp_path):
    """The port's val accuracy stays within 0.5 points of the reference's
    every epoch, and its train loss falls."""
    history, want = short_run_against_reference(tmp_path)
    accs = [h["val_acc"] for h in history]
    assert len(accs) == len(want) == 3
    assert max(abs(a - b) for a, b in zip(accs, want)) <= 0.005, (accs, want)
    assert history[-1]["train_loss"] < history[0]["train_loss"]


# -- command line --------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_features(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_cli")
    paths = build_synthetic_project(str(root / "sim"), genome_len=3000, seed=11)
    train_h5, infer_h5 = str(root / "train.hdf5"), str(root / "infer.hdf5")
    run_features(paths["draft_fasta"], paths["reads_bam"], train_h5,
                 bam_y=paths["truth_bam"], seed=5, log=lambda *a: None)
    run_features(paths["draft_fasta"], paths["reads_bam"], infer_h5, seed=5,
                 log=lambda *a: None)
    return {"root": root, "train": train_h5, "infer": infer_h5}


def test_cli_trains_then_polishes_on_cpu(sim_features, capsys):
    root = sim_features["root"]
    ckpt, out = str(root / "ckpt"), str(root / "out.fa")
    small = ["--hidden-size", "16", "--num-layers", "2", "--device", "cpu"]
    assert cli.main(["train", sim_features["train"], ckpt, "--b", "8", "--epochs", "2",
                     *small]) == 0
    text = capsys.readouterr().out
    assert re.search(r"epoch 1: train_loss [0-9.]+ val_acc [0-9.]+ .* windows/s", text)
    assert ck.verify_manifest(os.path.join(ckpt, "latest"))[0] == "ok"
    assert cli.main(["inference", sim_features["infer"], ckpt, out, "--b", "16", *small]) == 0
    records = list(read_fasta(out))
    assert records and set(records[0][1]) <= set("ACGT") and len(records[0][1]) > 1000


def test_cli_trains_then_polishes_lingru_on_cpu(sim_features, capsys):
    root = sim_features["root"]
    ckpt, out = str(root / "ckpt_lingru"), str(root / "out_lingru.fa")
    small = ["--model-kind", "lingru", "--hidden-size", "16", "--num-layers", "2",
             "--device", "cpu"]
    assert cli.main(["train", sim_features["train"], ckpt, "--b", "8", "--epochs", "1",
                     *small]) == 0
    assert re.search(r"epoch 0: train_loss [0-9.]+ val_acc", capsys.readouterr().out)
    assert ck.verify_manifest(os.path.join(ckpt, "latest"))[0] == "ok"
    assert any(k.startswith("lingru.") for k in ck.load_params(ckpt))
    assert cli.main(["inference", sim_features["infer"], ckpt, out, "--b", "16", *small]) == 0
    # one epoch of training predicts mostly GAP: the contig may collapse
    records = list(read_fasta(out))
    assert records and records[0][1] and set(records[0][1]) <= set("ACGT")


def test_cli_train_without_card_refuses_cuda(sim_features, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["train", sim_features["train"], str(tmp_path / "c"), "--epochs", "1"])
    assert not (tmp_path / "c").exists()
