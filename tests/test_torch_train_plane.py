"""The port's training run controls against ``roko_tpu`` on the CPU:
mid-epoch checkpoints that resume at the next batch (bit-identical to an
uninterrupted run, one shard and shard 1 of 2), the four refusals of a
changed data stream, the restore of a checkpoint written before the data
plane, a sharded mid-saving run against ``roko_tpu.training.loop.train``,
``--config`` layering against ``roko_tpu.cli``, ``--trace-dir``,
``inspect`` byte-equal to ``roko-tpu inspect``, and
``tools/orbax_to_pth.py``. The mirror of ``tests/test_datapipe.py``
(:479-651), ``tests/test_guard.py`` (:227-270, :473-533),
``tests/test_training.py:480`` and ``tests/test_cli.py`` (:108-160)."""

import dataclasses
import hashlib
import importlib.util
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from roko_tpu import cli as ref_cli
from roko_tpu import config as jconfig
from roko_tpu import constants as JC
from roko_tpu.features.pipeline import run_features
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.parallel.mesh import make_mesh
from roko_tpu.sim import build_synthetic_project
from roko_tpu.training.checkpoint import CheckpointManager as RefCheckpointManager
from roko_tpu.training.loop import train as ref_train
from roko_tpu_torch import cli
from roko_tpu_torch.config import DataConfig, GuardConfig, ModelConfig, RokoConfig, TrainConfig
from roko_tpu_torch.data.hdf5 import DataWriter
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.training import checkpoint as ck
from roko_tpu_torch.training import loop
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
TINY = ModelConfig(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2)
SMALL = ["--hidden-size", "16", "--num-layers", "2", "--device", "cpu"]


class Interrupt(Exception):
    pass


def interrupt_at(marker):
    def log(msg):
        if marker in msg:
            raise Interrupt(msg)
    return log


def _train_h5(path, n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, JC.FEATURE_VOCAB, (n, JC.WINDOW_ROWS, JC.WINDOW_COLS)).astype(np.uint8)
    Y = (X.sum(axis=1) % JC.NUM_CLASSES).astype(np.int64)
    pos = [np.stack([np.arange(JC.WINDOW_COLS), np.zeros(JC.WINDOW_COLS)], 1)] * n
    with DataWriter(str(path), infer=False) as w:
        w.write_contigs([("c", "ACGT" * 100)])
        w.store("c", pos, list(X), list(Y))
    return str(path)


def _run(h5, out, *, shards=0, shard_id=-1, batch=16, epochs=2, save_every=0, seed=-1,
         val_fraction=0.0, log=lambda s: None, **train_kw):
    return loop.train(
        h5, str(out), model_cfg=TINY,
        train_cfg=TrainConfig(batch_size=batch, epochs=epochs, lr=1e-2,
                              val_fraction=val_fraction, **train_kw),
        guard_cfg=GuardConfig(save_every_steps=save_every),
        data_cfg=DataConfig(shards=shards, shard_id=shard_id, block_size=16, seed=seed),
        device="cpu", log=log)


def _epoch_metrics(logs, epoch):
    for line in logs:
        m = re.match(rf"epoch {epoch}: (train_loss \S+ val_acc \S+ val_loss \S+)", line)
        if m:
            return m.group(1)
    raise AssertionError(f"no epoch {epoch} summary in {logs}")


def _assert_same_params(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# -- mid-epoch checkpoints ----------------------------------------------------

@pytest.mark.parametrize("shards,shard_id", [(0, -1), (2, 1)])
def test_mid_epoch_interrupt_resumes_bit_identical(tmp_path, shards, shard_id):
    """A run killed inside epoch 1 and resumed ends bit for bit where an
    uninterrupted one ends: parameters, step count and epoch 1's summary.
    The resume starts at the batch after the last mid-epoch save."""
    h5 = _train_h5(tmp_path / "train.hdf5")
    kw = dict(shards=shards, shard_id=shard_id, save_every=2, log_every_steps=1)
    logs_a = []
    full = _run(h5, tmp_path / "a", log=logs_a.append, **kw)
    with pytest.raises(Interrupt):
        _run(h5, tmp_path / "b", log=interrupt_at("epoch 1 step 3/4"), **kw)
    latest = tmp_path / "b" / "latest"
    assert ck.verify_manifest(str(latest))[0] == "ok"
    saved = torch.load(latest / ck.STATE_NAME, weights_only=True)["data_state"]
    assert (saved["epoch"], saved["batch"], saved["applied"]) == (1, 2, 2)
    assert saved["pipe"]["shards"] == max(shards, 1) and saved["pipe"]["local_bs"] == (
        16 // max(shards, 1))
    logs_b = []
    resumed = _run(h5, tmp_path / "b", log=logs_b.append, **kw)
    assert any("resumed from step 6 (epoch 1, batch 2," in line for line in logs_b), logs_b[:6]
    assert full.step == resumed.step == 8
    _assert_same_params(full, resumed)
    assert _epoch_metrics(logs_a, 1) == _epoch_metrics(logs_b, 1)
    if shards:
        assert any("[shard 1/2: 32 local rows" in line for line in logs_a)


# -- refusals -------------------------------------------------------------------

def test_resume_refuses_changed_shard_topology(tmp_path):
    h5 = _train_h5(tmp_path / "train.hdf5")
    _run(h5, tmp_path / "ck", shards=2, shard_id=0, epochs=1)
    with pytest.raises(RuntimeError, match=r"data-stream spec changed.*shards: 2 -> 1"):
        _run(h5, tmp_path / "ck")
    with pytest.raises(RuntimeError, match=r"data-stream spec changed.*seed: 0 -> 7"):
        _run(h5, tmp_path / "ck", shards=2, shard_id=0, seed=7)


def test_mid_epoch_resume_refuses_changed_batch_size(tmp_path):
    h5 = _train_h5(tmp_path / "train.hdf5")
    with pytest.raises(Interrupt):
        _run(h5, tmp_path / "ck", epochs=1, save_every=1, log_every_steps=1,
             log=interrupt_at("epoch 0 step 3/4"))
    with pytest.raises(RuntimeError, match=r"data-stream spec changed.*local_bs: 16 -> 8"):
        _run(h5, tmp_path / "ck", batch=8, epochs=1, save_every=1)
    logs = []
    _run(h5, tmp_path / "ck", epochs=1, save_every=1, log=logs.append)
    assert any("resumed from step 2 (epoch 0, batch 2," in line for line in logs)


def test_resume_refuses_changed_val_fraction(tmp_path):
    h5 = _train_h5(tmp_path / "train.hdf5")
    _run(h5, tmp_path / "ck", epochs=1, val_fraction=0.25)
    with pytest.raises(RuntimeError,
                       match=r"data-stream spec changed.*val_ppm: 250000 -> 500000"):
        _run(h5, tmp_path / "ck", val_fraction=0.5)


def test_resume_refuses_mutated_corpus(tmp_path):
    h5 = _train_h5(tmp_path / "train.hdf5")
    _run(h5, tmp_path / "ck", epochs=1)
    _train_h5(tmp_path / "train.hdf5", seed=999)  # regenerated in place
    with pytest.raises(RuntimeError, match=r"data-stream spec changed.*fingerprint: "):
        _run(h5, tmp_path / "ck")


def test_checkpoint_of_the_layout_before_the_data_plane_restores(tmp_path):
    """A checkpoint whose data_state holds only the epoch, the rollbacks,
    the guard and (seed, val_ppm, corpus digest) resumes at its epoch and
    ends where an uninterrupted run ends; its pinned seed still counts."""
    h5 = _train_h5(tmp_path / "train.hdf5")
    full = _run(h5, tmp_path / "full", val_fraction=0.25)
    first = _run(h5, tmp_path / "old", epochs=1, val_fraction=0.25)
    size = os.path.getsize(h5)
    legacy_fp = hashlib.sha256(json.dumps(
        [["train.hdf5", size, [["c_0-89", 64]]]]).encode()).hexdigest()
    for name in os.listdir(tmp_path / "old"):
        path = tmp_path / "old" / name / ck.STATE_NAME
        state = torch.load(path, weights_only=True)
        guard = {k: state["data_state"]["guard"][k]
                 for k in ("ema", "var", "good_steps", "consecutive_bad")}
        state["data_state"] = {"epoch": 1, "rollbacks": 0, "guard": guard,
                               "pipe": {"seed": 0, "val_ppm": 250000,
                                        "fingerprint": legacy_fp}}
        torch.save(state, path)
        ck.write_manifest(str(path.parent))
    logs = []
    resumed = _run(h5, tmp_path / "old", val_fraction=0.25, log=logs.append)
    assert any(line.startswith("resumed from step 3 (epoch 1, batch 0,") for line in logs)
    assert first.step == 3 and full.step == resumed.step == 6
    _assert_same_params(full, resumed)
    with pytest.raises(RuntimeError, match=r"seed: 0 -> 4"):
        _run(h5, tmp_path / "old", val_fraction=0.25, epochs=3, seed=4)


# -- against the reference ---------------------------------------------------------

def test_sharded_mid_saving_run_tracks_reference(tmp_path):
    """Shard 0 of 2 with mid-epoch saves, dropout 0, the guard off (one
    train step to compile in the reference), from the same init:
    the port's val accuracy stays within 0.5 points of the reference's
    every epoch (the bar of ``test_short_run_tracks_reference``), and both
    take the same steps."""
    h5 = _train_h5(tmp_path / "train.hdf5", n=64, seed=4)
    jcfg = jconfig.ModelConfig(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2,
                               dropout=0.0)
    tkw = dict(batch_size=16, epochs=2, lr=3e-3, seed=0, val_fraction=0.25)
    dkw = dict(shards=2, shard_id=0, block_size=16)
    jlogs = []
    ref_train(jconfig.RokoConfig(model=jcfg, train=jconfig.TrainConfig(**tkw),
                                 data=jconfig.DataConfig(**dkw),
                                 guard=jconfig.GuardConfig(enabled=False, save_every_steps=2)),
              h5, str(tmp_path / "jax"), mesh=make_mesh(jconfig.MeshConfig(dp=1),
                                                       jax.devices()[:1]),
              log=jlogs.append)
    want = [float(m.group(1)) for m in (re.search(r"val_acc ([0-9.]+)", s) for s in jlogs) if m]
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, JaxRokoModel(jcfg).init(init_rng))
    logs = []
    got = loop.train(h5, str(tmp_path / "port"), model_cfg=dataclasses.replace(TINY, dropout=0.0),
                     train_cfg=TrainConfig(**tkw),
                     guard_cfg=GuardConfig(enabled=False, save_every_steps=2),
                     data_cfg=DataConfig(**dkw), device="cpu",
                     init_params=state_dict_from_jax(params), log=logs.append)
    accs = [h["val_acc"] for h in got.history]
    assert len(accs) == len(want) == 2
    assert max(abs(a - b) for a, b in zip(accs, want)) <= 0.005, (accs, want)
    shard_line = next(s for s in jlogs if "[shard 0/2" in s)
    assert shard_line in logs


# -- --config ---------------------------------------------------------------------

def _reference_cfg():
    return jconfig.RokoConfig(
        window=jconfig.WindowConfig(rows=120, cols=60),
        model=jconfig.ModelConfig(hidden_size=32, num_layers=2, quantize="int8"),
        train=jconfig.TrainConfig(batch_size=64, lr=3e-3, in_memory=False, val_fraction=0.1),
        data=jconfig.DataConfig(block_size=64, input_prefetch=7, mix_blocks=4, seed=3),
        guard=jconfig.GuardConfig(spike_sigma=3.0, ema_beta=0.5, save_every_steps=9),
        pipeline=jconfig.PipelineConfig(queue_regions=3),
    )


PORTED_SECTIONS = ("window", "read_filter", "region", "model", "train", "data", "guard",
                   "serve", "pipeline", "resilience")


def _same_sections(port_cfg, ref_cfg):
    for name in PORTED_SECTIONS:
        mine = dataclasses.asdict(getattr(port_cfg, name))
        theirs = dataclasses.asdict(getattr(ref_cfg, name))
        assert mine == {k: theirs[k] for k in mine}, name


def test_reference_config_json_round_trips(tmp_path):
    ref = _reference_cfg()
    port = RokoConfig.from_json(ref.to_json())
    _same_sections(port, ref)
    back = jconfig.RokoConfig.from_json(port.to_json())  # the port's file loads there
    _same_sections(port, back)
    assert RokoConfig.from_json("{}") == RokoConfig()


@pytest.mark.parametrize("argv", [
    ["train", "in.hdf5", "out", "--b", "16", "--data-shards", "4", "--data-shard-id", "1",
     "--data-seed", "13", "--data-manifest", "/m.json", "--spike-sigma", "9.5",
     "--max-bad-steps", "2", "--save-every-steps", "11", "--quantize", "none", "--memory",
     "--hidden-size", "24"],
    ["train", "in.hdf5", "out", "--no-guard", "--input-prefetch", "5", "--guard-warmup-steps",
     "5", "--max-rollbacks", "1", "--guard-ema-beta", "0.9", "--data-block-size", "32"],
    ["inference", "d.hdf5", "ck", "o.fa", "--b", "8", "--compute-dtype", "bfloat16"],
    ["polish", "r.fa", "x.bam", "ck", "o.fa", "--window-rows", "100", "--queue-regions", "5",
     "--batch-delay-ms", "9", "--prefetch", "4", "--min-mapq", "3", "--no-proper-pair"],
    ["features", "r.fa", "x.bam", "o.hdf5", "--region-size", "5000", "--region-overlap", "30"],
])
def test_config_layering_matches_reference(tmp_path, argv):
    """defaults < the reference's JSON file < the flags, section by section
    as ``roko-tpu``'s ``_build_config`` layers them; ``--quantize none``
    clears the file's int8."""
    path = tmp_path / "cfg.json"
    path.write_text(_reference_cfg().to_json())
    full = argv + ["--config", str(path)]
    port = cli._build_config(cli.build_parser().parse_args(full))
    ref = ref_cli._build_config(ref_cli.build_parser().parse_args(full))
    _same_sections(port, ref)
    assert port.model.window_rows == ref.window.rows
    if "--quantize" in argv:
        assert port.model.quantize is None and port.train.batch_size == 16
    # without the file: the flags over the built-in defaults
    _same_sections(cli._build_config(cli.build_parser().parse_args(argv)),
                   ref_cli._build_config(ref_cli.build_parser().parse_args(argv)))


def test_every_reference_field_is_ported_refused_or_ignored():
    """Each field of ``roko_tpu``'s RokoConfig is a field of the port's,
    or stands in the table of refused fields at the reference's default,
    or in the short list of fields that load whatever they hold."""
    from roko_tpu_torch.config import _IGNORED, _NOT_PORTED

    ref = json.loads(jconfig.RokoConfig().to_json())
    port = json.loads(RokoConfig().to_json())
    for section, values in ref.items():
        for key, value in values.items():
            if key in port.get(section, {}):
                assert port[section][key] == value, (section, key)
            elif key in _NOT_PORTED.get(section, {}):
                assert _NOT_PORTED[section][key][0] == value, (section, key)
            else:
                assert key in _IGNORED.get(section, ()), (section, key)


@pytest.mark.parametrize("section,value,item", [
    # the mesh's dp, tp and sp, the kernel bundle, the fleet and its
    # federation, the cascade, the distributed polish and the store are
    # ported; the JAX cache's size bound has no nvcc counterpart
    ("compile", {"cache_max_mb": 7}, "no nvcc counterpart"),
    ("model", {"remat_scan": True}, "A12"),
])
def test_unported_config_is_refused_by_name(tmp_path, capsys, section, value, item):
    """A file that asks for what the port does not run is a usage error
    naming the field and its queue item, before anything is written."""
    raw = json.loads(jconfig.RokoConfig().to_json())
    raw[section].update(value)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", "in.hdf5", str(tmp_path / "out"), "--config", str(path), *SMALL])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{section}.{next(iter(value))}" in err and item in err
    assert not (tmp_path / "out").exists()
    # the same file at the defaults loads
    path.write_text(jconfig.RokoConfig().to_json())
    assert RokoConfig.from_json(path.read_text()) == RokoConfig()


@pytest.mark.parametrize("section,value", [
    ("store", {"cache_dir": "/s", "hedge_s": 0.5}), ("fleet", {"join": "h:1", "host_id": "h"}),
    ("store", {"endpoint": "http://h", "max_attempts": 2}),
])
def test_store_and_federation_config_loads_as_reference(section, value):
    """A file of the reference's layout that sets the store's or the
    federation's fields loads, round-trips through JSON, and equals the
    reference's reading of it."""
    raw = json.loads(jconfig.RokoConfig().to_json())
    raw[section].update(value)
    got = RokoConfig.from_json(json.dumps(raw))
    want = json.loads(jconfig.RokoConfig.from_json(json.dumps(raw)).to_json())
    assert {k: v for k, v in json.loads(got.to_json()).items() if k in ("store", "fleet")} == \
        {k: want[k] for k in ("store", "fleet")}
    assert RokoConfig.from_json(got.to_json()) == got
    assert all(getattr(getattr(got, section), k) == v for k, v in value.items())


@pytest.mark.parametrize("section,value,message", [
    ("store", {"block_bytes": 0}, "store.block_bytes must be >= 1, got 0"),
    ("fleet", {"lease_ttl_s": 0}, "lease_ttl_s must be > 0; got 0"),
    ("fleet", {"fed_breaker_failures": 0}, "fed_breaker_failures must be >= 1; got 0"),
])
def test_store_and_federation_config_validation_as_reference(section, value, message):
    raw = json.loads(jconfig.RokoConfig().to_json())
    raw[section].update(value)
    with pytest.raises(ValueError, match=re.escape(message)):
        RokoConfig.from_json(json.dumps(raw))
    with pytest.raises(ValueError, match=re.escape(message)):
        jconfig.RokoConfig.from_json(json.dumps(raw))


def test_cli_config_trains_like_the_flags(tmp_path, capsys):
    """``train --config`` with the model, train, guard and data sections
    takes the steps and reaches the losses of the same values as flags."""
    h5 = _train_h5(tmp_path / "train.hdf5", n=32)
    cfg = jconfig.RokoConfig(
        model=jconfig.ModelConfig(hidden_size=16, num_layers=2),
        train=jconfig.TrainConfig(batch_size=16, epochs=2, lr=1e-2, in_memory=False),
        guard=jconfig.GuardConfig(save_every_steps=3),
        data=jconfig.DataConfig(shards=2, shard_id=1, block_size=16))
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    assert cli.main(["train", h5, str(tmp_path / "a"), "--config", str(tmp_path / "cfg.json"),
                     "--device", "cpu"]) == 0
    by_file = capsys.readouterr().out
    assert cli.main(["train", h5, str(tmp_path / "b"), "--hidden-size", "16", "--num-layers",
                     "2", "--b", "16", "--epochs", "2", "--lr", "1e-2", "--no-memory",
                     "--save-every-steps", "3", "--data-shards", "2", "--data-shard-id", "1",
                     "--data-block-size", "16", "--device", "cpu"]) == 0
    by_flags = capsys.readouterr().out
    for epoch in (0, 1):
        assert _epoch_metrics(by_file.splitlines(), epoch) == _epoch_metrics(
            by_flags.splitlines(), epoch)
    assert "[shard 1/2: 16 local rows" in by_file


# -- --trace-dir -------------------------------------------------------------------

def _trace_events(trace_dir):
    files = list(Path(trace_dir).glob("*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
    return trace["traceEvents"]


def test_trace_dir_writes_a_trace_that_parses(tmp_path, capsys):
    h5 = _train_h5(tmp_path / "train.hdf5", n=16)
    assert cli.main(["train", h5, str(tmp_path / "ck"), "--b", "8", "--epochs", "2",
                     "--trace-dir", str(tmp_path / "tr_train"), *SMALL]) == 0
    events = _trace_events(tmp_path / "tr_train")  # the first epoch alone
    assert any("aten::" in e.get("name", "") for e in events)
    n = 8
    x = np.random.default_rng(1).integers(0, JC.FEATURE_VOCAB, (n, JC.WINDOW_ROWS,
                                                              JC.WINDOW_COLS)).astype(np.uint8)
    cols = np.arange(n)[:, None] * 30 + np.arange(JC.WINDOW_COLS)[None, :]
    pos = np.stack([cols, np.zeros_like(cols)], -1)
    from roko_tpu_torch.infer import run_inference
    from roko_tpu_torch.models.model import RokoModel

    model = RokoModel(TINY)
    run_inference(iter([(["c"] * n, pos, x)]), {"c": "A" * (n * 30 + 100)}, model,
                  device="cpu", log=lambda s: None, trace_dir=str(tmp_path / "tr_infer"))
    assert _trace_events(tmp_path / "tr_infer")


# -- inspect ---------------------------------------------------------------------

def test_inspect_stdout_is_byte_equal_to_reference(tmp_path, capsys):
    d = tmp_path / "d"
    d.mkdir()
    _train_h5(d / "a_train.hdf5", n=12)
    with DataWriter(str(d / "b_infer.hdf5"), infer=True) as w:
        w.write_contigs([(f"ctg{i}", "ACGT") for i in range(7)])
        for i in range(7):
            w.store(f"ctg{i}", [np.zeros((JC.WINDOW_COLS, 2), np.int64)] * 2,
                    list(np.zeros((2, JC.WINDOW_ROWS, JC.WINDOW_COLS), np.uint8)), None)
    with DataWriter(str(d / "c_empty.hdf5"), infer=True) as w:
        w.write_contigs([("e", "A")])
    for target in (str(d / "a_train.hdf5"), str(d)):
        assert cli.main(["inspect", target]) == 0
        got = capsys.readouterr().out
        assert ref_cli.main(["inspect", target]) == 0
        assert got == capsys.readouterr().out
        assert "total:" in got
    assert "EMPTY (no region groups)" in got and "inference" in got and "..." in got


# -- the Orbax tool ----------------------------------------------------------------

@pytest.fixture(scope="module")
def infer_project(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_plane_orbax")
    paths = build_synthetic_project(str(root / "sim"), genome_len=3000, seed=11)
    h5 = str(root / "infer.hdf5")
    run_features(paths["draft_fasta"], paths["reads_bam"], h5, seed=5, log=lambda *a: None)
    return root, h5, paths


def test_orbax_tool_gives_the_references_fasta(infer_project, tmp_path, capsys):
    """A ``roko_tpu`` checkpoint directory through ``tools/orbax_to_pth.py``:
    the port's ``inference --device cpu`` on the .pth writes the FASTA
    ``roko-tpu inference`` writes from the checkpoint, byte for byte."""
    _, h5, _ = infer_project
    jcfg = jconfig.ModelConfig(hidden_size=16, num_layers=2)
    params = JaxRokoModel(jcfg).init(jax.random.PRNGKey(8))
    mgr = RefCheckpointManager(str(tmp_path / "orbax"), log=lambda s: None)
    mgr.save(5, {"params": params, "step": jax.numpy.asarray(5, jax.numpy.int32)}, 0.5)
    mgr.close()
    pth = tmp_path / "model.pth"
    spec = importlib.util.spec_from_file_location("orbax_to_pth", ROOT / "tools" / "orbax_to_pth.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main([str(tmp_path / "orbax"), str(pth)]) == 0
    assert "wrote" in capsys.readouterr().out and pth.exists()
    want, got = tmp_path / "ref.fa", tmp_path / "port.fa"
    assert ref_cli.main(["inference", h5, str(tmp_path / "orbax"), str(want), "--b", "16",
                         "--hidden-size", "16", "--num-layers", "2"]) == 0
    assert cli.main(["inference", h5, str(pth), str(got), "--b", "16", *SMALL]) == 0
    assert len(want.read_bytes()) > 2000 and got.read_bytes() == want.read_bytes()


def test_polish_takes_config_and_trace_dir(infer_project, tmp_path, capsys):
    """``polish --config --trace-dir``: the streamed polish's FASTA with a
    file of the defaults and a trace equals the plain run's, and the
    trace parses."""
    _, _, paths = infer_project
    params = jax.tree.map(np.asarray, JaxRokoModel(
        jconfig.ModelConfig(hidden_size=16, num_layers=2)).init(jax.random.PRNGKey(3)))
    pth = tmp_path / "m.pth"
    torch.save(state_dict_from_jax(params), pth)
    (tmp_path / "cfg.json").write_text(jconfig.RokoConfig(
        model=jconfig.ModelConfig(hidden_size=16, num_layers=2),
        train=jconfig.TrainConfig(batch_size=32)).to_json())
    base = ["polish", paths["draft_fasta"], paths["reads_bam"], str(pth)]
    assert cli.main(base + [str(tmp_path / "plain.fa"), "--b", "32", *SMALL]) == 0
    assert cli.main(base + [str(tmp_path / "cfg.fa"), "--config", str(tmp_path / "cfg.json"),
                            "--trace-dir", str(tmp_path / "tr"), "--device", "cpu"]) == 0
    assert (tmp_path / "cfg.fa").read_bytes() == (tmp_path / "plain.fa").read_bytes()
    assert _trace_events(tmp_path / "tr")
    assert list(read_fasta(str(tmp_path / "cfg.fa")))
