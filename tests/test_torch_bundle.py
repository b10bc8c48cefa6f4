"""The port's cold start (``roko_tpu_torch/compile``) against the
reference's (``roko_tpu/compile``), case for case with
``tests/test_warmstart.py``: the config section and its JSON, the kernel
build cache's layered resolution, its fresh directory when off and its
hit/miss counts (a stand-in nvcc on the CPU), the ladder warmup on threads
and its failure, the session's warmup, kernel bundles (manifest, identity
and digest across a round trip, model, geometry and environment drift
refused naming the fields the reference's diff names, a missing rung, a
missing manifest, a missing or changed library), ``wrap_predict``, the
``compile`` command through the CLI and the ``/metrics`` lines.

On the CPU a bundle holds the identity and the rungs and no library: the
library checks run on a library entry the test writes into a CPU
bundle's manifest. Tiny widths (``TINY_GRU``)."""

import dataclasses
import json
import os
import shutil
import stat
import threading

import numpy as np
import pytest
import torch

from roko_tpu.compile import bundle as ref_bundle
from roko_tpu.config import CompileConfig as JCompile
from roko_tpu.config import MeshConfig as JMesh
from roko_tpu.config import RokoConfig as JRoko
from roko_tpu.parallel.mesh import make_mesh as ref_make_mesh
from roko_tpu.serve.metrics import ServeMetrics as RefMetrics
from roko_tpu_torch import cli, kernels
from roko_tpu_torch import constants as C
from roko_tpu_torch.compile import (
    BundleMismatch,
    bundle_digest,
    bundle_identity,
    check_bundle,
    export_bundle,
    load_bundle,
    read_manifest,
    warmup_ladder,
    wrap_predict,
)
from roko_tpu_torch.compile import bundle as bundle_mod
from roko_tpu_torch.compile import cache as cache_mod
from roko_tpu_torch.config import CompileConfig, ModelConfig, RokoConfig, ServeConfig
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.serve.metrics import ServeMetrics
from roko_tpu_torch.serve.session import PolishSession
from tests.test_lingru import TINY_GRU
from tests.torch_threads import one_torch_thread  # noqa: F401

WIDTHS = {f: getattr(TINY_GRU, f) for f in ("embed_dim", "read_mlp", "hidden_size", "num_layers")}
TINY = ModelConfig(**WIDTHS)
CFG = RokoConfig(model=TINY, serve=ServeConfig(ladder=(8, 16)))
REF_CFG = JRoko(model=TINY_GRU, mesh=JMesh())


def quiet(msg):
    pass


@pytest.fixture(scope="module")
def model():
    return RokoModel(TINY, generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bundle") / "kb")
    export_bundle(out, CFG, ladder=CFG.serve.ladder, device="cpu", log=quiet)
    return out


@pytest.fixture
def fresh_cache():
    cache_mod._reset_for_tests()
    yield
    cache_mod._reset_for_tests()


# -- config / cache resolution ----------------------------------------------


def test_compile_config_json_roundtrip():
    cfg = RokoConfig(compile=CompileConfig(cache_dir="/x", bundle_dir="/y", warmup_workers=3))
    back = RokoConfig.from_json(cfg.to_json())
    assert back.compile == cfg.compile
    assert back.resilience.compile_deadline_s == 1800.0
    # the reference reads the port's file, field for field
    ref = JRoko.from_json(cfg.to_json()).compile
    assert ref == JCompile(cache_dir="/x", bundle_dir="/y", warmup_workers=3)
    # and the port refuses the reference's JAX-only fields, naming why
    raw = json.loads(JRoko(compile=JCompile(cache_max_mb=7)).to_json())
    with pytest.raises(ValueError, match="compile.cache_max_mb.*no nvcc counterpart"):
        RokoConfig.from_json(json.dumps(raw))


def test_resolve_cache_dir_layering(monkeypatch):
    monkeypatch.delenv("ROKO_COMPILE_CACHE", raising=False)
    assert cache_mod.resolve_cache_dir(None).endswith(os.path.join("build", "roko_tpu_torch"))
    assert cache_mod.resolve_cache_dir(CompileConfig(cache_dir="/tmp/cc")) == "/tmp/cc"
    assert cache_mod.resolve_cache_dir(CompileConfig(enabled=False)) is None
    monkeypatch.setenv("ROKO_COMPILE_CACHE", "/tmp/env-cache")
    assert cache_mod.resolve_cache_dir(CompileConfig(cache_dir="/tmp/cc")) == "/tmp/env-cache"
    for off in ("off", "0", "none", "", "Disabled"):
        monkeypatch.setenv("ROKO_COMPILE_CACHE", off)
        assert cache_mod.resolve_cache_dir(None) is None


def test_enable_persistent_cache_real_dir_and_idempotence(tmp_path, monkeypatch, fresh_cache):
    monkeypatch.setenv("ROKO_COMPILE_CACHE", str(tmp_path / "cc"))
    d = cache_mod.enable_persistent_cache(None)
    assert d == str(tmp_path / "cc") and os.path.isdir(d)
    assert cache_mod.active_cache_dir() == d
    monkeypatch.setenv("ROKO_COMPILE_CACHE", str(tmp_path / "other"))
    notes = []
    assert cache_mod.enable_persistent_cache(None, log=notes.append) == d
    assert notes and "already configured" in notes[0]
    assert cache_mod.cache_entry_count(d) == 0 and cache_mod.cache_total_bytes(d) == 0
    (tmp_path / "cc" / "k-0123.so").write_bytes(b"x" * 5)
    (tmp_path / "cc" / "k-0123.so.7.tmp").write_bytes(b"x" * 3)  # a build in flight
    assert cache_mod.cache_entry_count(d) == 1 and cache_mod.cache_total_bytes(d) == 5


def test_cache_off_builds_into_a_fresh_directory(monkeypatch, fresh_cache):
    monkeypatch.setenv("ROKO_COMPILE_CACHE", "off")
    d = cache_mod.enable_persistent_cache(None)
    assert os.path.isdir(d) and os.listdir(d) == [] and "roko-kernels-" in d
    assert cache_mod.active_cache_dir() == d


def _fake_nvcc(tmp_path):
    """A stand-in nvcc: writes its ``-o`` target, so the build's publish
    and counting run on a machine without the toolkit."""
    path = tmp_path / "nvcc"
    path.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ "$1" = -o ]; then '
                    'echo lib > "$2"; fi; shift; done\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_counts_a_built_library_as_a_miss_and_a_found_one_as_a_hit(
        tmp_path, monkeypatch, fresh_cache):
    monkeypatch.setattr(kernels, "BUILD_DIR", None)
    monkeypatch.setattr(kernels, "_counted", set())
    monkeypatch.setattr(kernels, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setenv("ROKO_COMPILE_CACHE", str(tmp_path / "kc"))
    report = kernels.build(["gru_fwd", "lingru_fwd"])
    assert set(report) == {"gru_fwd", "lingru_fwd"}
    assert cache_mod.cache_counters() == (0, 2)
    assert kernels.library_path("gru_fwd").read_text() == "lib\n"
    assert kernels.library_path("gru_fwd").parent == tmp_path / "kc"
    assert not list((tmp_path / "kc").glob("*.tmp"))  # published by rename
    assert kernels.build(["gru_fwd"]) == {}  # counted once a process
    assert cache_mod.cache_counters() == (0, 2)
    # a second process on the same directory: found, not built
    monkeypatch.setattr(kernels, "_counted", set())
    assert kernels.build(["gru_fwd", "lingru_fwd"]) == {}
    assert cache_mod.cache_counters() == (2, 2)


def test_inference_kernels_follow_kind_and_dtype():
    assert kernels.inference_kernels(TINY) == ("gru_fwd",)
    assert kernels.inference_kernels(dataclasses.replace(TINY, compute_dtype="bfloat16")) == \
        ("gru_fwd_bf16",)
    assert kernels.inference_kernels(dataclasses.replace(TINY, kind="lingru")) == ("lingru_fwd",)
    assert kernels.inference_kernels(dataclasses.replace(TINY, quantize="int8")) == ("gru_fwd",)
    assert kernels.inference_kernels(ModelConfig(kind="transformer")) == ()


# -- parallel warmup ---------------------------------------------------------


def test_warmup_ladder_runs_every_rung_concurrently():
    started = threading.Barrier(2, timeout=10.0)
    done = []

    def compile_rung(r):
        started.wait()  # both rungs must be in flight at once
        done.append(r)

    report = warmup_ladder((8, 16), compile_rung, parallel=True, log=None)
    assert sorted(done) == [8, 16]
    assert report.mode == "parallel" and set(report.per_rung_s) == {8, 16}
    assert report.seconds > 0


def test_warmup_ladder_serial_and_failure_propagation():
    order = []
    report = warmup_ladder((4, 2), order.append, parallel=False, log=None)
    assert order == [4, 2] and report.mode == "serial"

    def boom(r):
        if r == 16:
            raise RuntimeError("rung 16 exploded")

    with pytest.raises(RuntimeError, match="rung 16 exploded"):
        warmup_ladder((8, 16), boom, parallel=True, log=None)


def test_session_parallel_warmup_runs_whole_ladder(model):
    session = PolishSession(model, CFG, device="cpu")
    assert session.warmup(parallel=True) == len(session.ladder)
    assert session.dispatched_shapes == set(session.ladder)
    rep = session.warmup_report
    assert rep is not None and rep.mode == "parallel"
    assert set(rep.per_rung_s) == set(session.ladder)
    assert rep.cache_misses == 0  # the CPU builds nothing
    rng = np.random.default_rng(0)
    for n in (3, 9, 16):
        session.predict(rng.integers(0, C.FEATURE_VOCAB, (n, 200, 90)).astype(np.uint8))
    assert session.dispatched_shapes <= set(session.ladder)


# -- kernel bundles ------------------------------------------------------------


def test_bundle_session_warms_as_aot_and_predicts_the_same(model, bundle_dir):
    plain = PolishSession(model, CFG, device="cpu")
    plain.warmup()
    cfg = dataclasses.replace(CFG, compile=CompileConfig(bundle_dir=bundle_dir))
    aot = PolishSession(model, cfg, device="cpu")
    assert aot.warmup(log=None) == len(CFG.serve.ladder)
    assert aot.warmup_report.mode == "aot" and aot.warmup_report.cache_misses == 0
    x = np.random.default_rng(1).integers(0, C.FEATURE_VOCAB, (20, 200, 90)).astype(np.uint8)
    np.testing.assert_array_equal(aot.predict(x), plain.predict(x))


def test_bundle_manifest_contents_and_digest_round_trip(bundle_dir):
    man = read_manifest(bundle_dir)
    assert man["rungs"] == [8, 16] and set(man["rung_seconds"]) == {"8", "16"}
    assert man["digest"] == bundle_digest(man["identity"])
    assert man["libraries"] == {}  # the CPU's bundle: identity only
    ident = man["identity"]
    assert ident["backend"] == "cpu" and ident["device_kind"] == "cpu"
    assert ident["torch_version"] == torch.__version__
    assert ident["mesh"] == {"dp": 1, "tp": 1, "sp": 1}
    assert ident["model"]["hidden_size"] == TINY.hidden_size
    assert ident["model"]["compute_dtype"] == "float32"  # "auto" resolved
    assert ident["kernels"] == {"gru_fwd": kernels.source_digest("gru_fwd")}
    # stable: recomputed here, through JSON, and for an explicit float32
    assert bundle_identity(CFG, backend="cpu") == ident
    assert bundle_digest(json.loads(json.dumps(ident))) == man["digest"]
    f32 = dataclasses.replace(CFG, model=dataclasses.replace(TINY, compute_dtype="float32"))
    assert bundle_digest(bundle_identity(f32, backend="cpu")) == man["digest"]
    # no path and no per-process value in the identity
    assert bundle_dir not in json.dumps(ident) and str(os.getpid()) not in json.dumps(ident)


def _fields(diff):
    return sorted(line.split(":")[0] for line in diff)


def _ref_identity(cfg):
    return ref_bundle.bundle_identity(cfg, ref_make_mesh(cfg.mesh))


@pytest.mark.parametrize("change,needle", [
    (dict(hidden_size=32), "model.hidden_size"),
    (dict(window_cols=80), "model.window_cols"),
    (dict(compute_dtype="bfloat16"), "model.compute_dtype"),
    (dict(quantize="int8"), "model.quantize"),
    (dict(kind="lingru"), "model.kind"),
])
def test_bundle_refuses_model_and_geometry_drift(bundle_dir, change, needle):
    """Any model field the kernels depend on differs: BundleMismatch
    naming it, and the model fields named are those the reference's diff
    names for the same drift."""
    drifted = dataclasses.replace(CFG, model=dataclasses.replace(TINY, **change))
    with pytest.raises(BundleMismatch, match=needle) as exc:
        load_bundle(bundle_dir, drifted, log=quiet)
    ours = bundle_mod._identity_diff(bundle_identity(drifted, backend="cpu"),
                                     read_manifest(bundle_dir)["identity"])
    ref_drifted = dataclasses.replace(REF_CFG, model=dataclasses.replace(TINY_GRU, **change))
    ref = ref_bundle._identity_diff(_ref_identity(ref_drifted), _ref_identity(REF_CFG))
    model_fields = [f for f in _fields(ours) if f.startswith("model.")]
    assert model_fields == _fields(ref) and needle in model_fields
    assert all(line in str(exc.value) for line in ours)


@pytest.mark.parametrize("field,value,ref_field,needle", [
    ("torch_version", "0.0.1", "jax_version", "torch_version"),
    ("device_kind", "NVIDIA H100 (other)", "device_kind", "device_kind"),
    ("mesh", {"dp": 4, "tp": 1, "sp": 1}, "mesh", "mesh.dp"),
])
def test_bundle_refuses_environment_drift(bundle_dir, tmp_path, field, value, ref_field,
                                          needle):
    """A bundle built under another torch, card or mesh refuses though
    every config field matches; the foreign identity is written into the
    manifest, with its digest made consistent (and, for the card, left
    stale, as an edited manifest would be)."""
    for consistent in (True, False):
        other = tmp_path / f"aged{consistent}"
        shutil.copytree(bundle_dir, other)
        man = read_manifest(str(other))
        man["identity"][field] = value
        if consistent:
            man["digest"] = bundle_digest(man["identity"])
        (other / "manifest.json").write_text(json.dumps(man))
        with pytest.raises(BundleMismatch, match=needle):
            load_bundle(str(other), CFG, log=quiet)
    ours = _fields(bundle_mod._identity_diff(bundle_identity(CFG, backend="cpu"),
                                             man["identity"]))
    ref_ident = _ref_identity(REF_CFG)
    ref_aged = dict(ref_ident, **{ref_field: value})
    ref = _fields(ref_bundle._identity_diff(ref_ident, ref_aged))
    assert ours == [f.replace("jax_version", "torch_version") for f in ref]


def test_bundle_refuses_missing_rung_and_missing_manifest(bundle_dir, tmp_path):
    with pytest.raises(BundleMismatch, match=r"missing \[24\]"):
        load_bundle(bundle_dir, CFG, rungs=(8, 16, 24), require_all=True, log=quiet)
    # a rung not required just runs as usual
    assert load_bundle(bundle_dir, CFG, rungs=(8, 24), log=quiet)["rungs"] == [8]
    for exc in (FileNotFoundError, BundleMismatch):
        with pytest.raises(exc, match="manifest.json"):
            read_manifest(str(tmp_path / "empty"))
    with pytest.raises(BundleMismatch, match="manifest.json"):
        load_bundle(str(tmp_path / "empty"), CFG, log=quiet)


def test_bundle_refuses_a_missing_or_changed_library(bundle_dir, tmp_path):
    other = tmp_path / "withlib"
    shutil.copytree(bundle_dir, other)
    (other / "lib").mkdir()
    lib = other / "lib" / "gru_fwd-0123456789abcdef.so"
    lib.write_bytes(b"kernel bytes")
    man = read_manifest(str(other))
    man["libraries"] = {"gru_fwd": {"file": "lib/" + lib.name,
                                    "sha256": bundle_mod._sha256_file(lib), "bytes": 12}}
    (other / "manifest.json").write_text(json.dumps(man))
    assert check_bundle(str(other), CFG)["paths"] == {"gru_fwd": lib}
    lib.write_bytes(b"kernel bytez")
    with pytest.raises(BundleMismatch, match="sha256"):
        load_bundle(str(other), CFG, log=quiet)
    lib.unlink()
    with pytest.raises(BundleMismatch, match="missing"):
        load_bundle(str(other), CFG, log=quiet)


def test_a_loaded_bundle_never_builds_a_kernel_it_lacks(monkeypatch, tmp_path):
    """After a bundle is installed, a kernel it lacks is refused, and a
    kernel already loaded from elsewhere cannot load from the bundle."""
    monkeypatch.setattr(kernels, "_bundle_paths", {})
    monkeypatch.setattr(kernels, "_bundle_dir", None)
    monkeypatch.setattr(kernels, "_loaded_from", {"lingru_fwd": tmp_path / "built.so"})
    monkeypatch.setattr(kernels, "nvcc_path", lambda: pytest.fail("nvcc must not run"))
    with pytest.raises(RuntimeError, match="already loaded"):
        kernels.install_bundle("b", {"lingru_fwd": tmp_path / "other.so"})
    kernels.install_bundle("b", {"gru_fwd": tmp_path / "gru.so"})
    assert kernels.build(["gru_fwd"]) == {}
    with pytest.raises(RuntimeError, match="carries no library for \\['gru_bwd'\\]"):
        kernels.build(["gru_bwd"])
    with pytest.raises(RuntimeError, match="already loaded"):
        kernels.install_bundle("c", {"gru_fwd": tmp_path / "gru.so"})


def test_wrap_predict_routes_by_batch_rows():
    hits = []
    wrapped = wrap_predict(lambda p, x: hits.append(("step", x.shape[0])),
                           {8: lambda p, x: hits.append(("aot", x.shape[0]))})
    wrapped(None, np.zeros((8, 1, 1)))
    wrapped(None, np.zeros((4, 1, 1)))
    assert hits == [("aot", 8), ("step", 4)]
    step = lambda p, x: None  # noqa: E731
    assert wrap_predict(step, {}) is step


def test_cli_compile_writes_loadable_bundle(tmp_path, capsys):
    """``compile`` through the CLI, with its fresh-process check; the
    bundle then loads for the same config."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(CFG.to_json())
    out = str(tmp_path / "bundle")
    assert cli.main(["compile", out, "--config", str(cfg_path), "--ladder", "8,16",
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "digest" in text and "verified 2 rung(s): [8, 16] (fresh process)" in text
    assert load_bundle(out, CFG, rungs=(8, 16), require_all=True, log=quiet)["rungs"] == [8, 16]


def test_cli_bundle_and_cache_flags_layer_into_config():
    args = cli.build_parser().parse_args(
        ["serve", "m.pth", "--bundle", "/b", "--compile-cache", "/c", "--no-compile-cache"])
    cfg = cli._build_config(args)
    assert cfg.compile == CompileConfig(enabled=False, cache_dir="/c", bundle_dir="/b")
    for cmd in (["inference", "d.hdf5", "m", "o.fa"], ["polish", "r.fa", "x.bam", "m", "o.fa"]):
        got = cli._build_config(cli.build_parser().parse_args(cmd + ["--bundle", "/b"]))
        assert got.compile.bundle_dir == "/b"


# -- metrics -------------------------------------------------------------------


def test_metrics_render_warmup_and_cache_lines(fresh_cache):
    m = ServeMetrics()
    text = m.render()
    assert "roko_serve_warmup_seconds NaN" in text
    assert "roko_compile_cache_hits 0" in text and "roko_compile_cache_misses 0" in text
    m.warmup_seconds = 12.5
    assert "roko_serve_warmup_seconds 12.500" in m.render()
    cache_mod.record(hit=True)
    cache_mod.record(hit=False)
    cache_mod.record(hit=False)
    text = m.render()
    assert "roko_compile_cache_hits 1\n" in text and "roko_compile_cache_misses 2\n" in text

    def series(body):
        return [ln for ln in body.splitlines() if "compile_cache" in ln or "warmup" in ln]

    # the reference renders the same rows, in the same order
    assert [ln.rsplit(" ", 1)[0] for ln in series(RefMetrics().render())] == \
        [ln.rsplit(" ", 1)[0] for ln in series(ServeMetrics().render())]


# -- bench coldstart suite -------------------------------------------------------


@pytest.mark.slow
def test_coldstart_suite_reports_four_modes():
    """The bench suite end to end on a tiny model (the reference's test of
    its suite is slow too): four child starts and an export child, the
    modes and speedups present. On the CPU nothing builds, so every
    start's misses are 0; the card's ``chip_smoke.py`` coldstart phase
    holds the cold starts to nvcc runs and the warm ones to none."""
    from roko_tpu_torch.benchmark import run_coldstart_suite

    res = run_coldstart_suite(ladder=(8,), child_budget_s=600.0, device="cpu",
                              model_overrides=WIDTHS)
    for key in ("cold", "cold_parallel", "warm_cache", "aot"):
        assert res[key]["ttfp_s"] > 0 and res[key]["compile_cache_misses"] == 0
        assert res[key]["warmup"]["mode"] in ("parallel", "serial", "aot")
    assert res["cold"]["warmup"]["mode"] == "serial"
    assert res["aot"]["warmup"]["mode"] == "aot"
    assert res["export_seconds"] > 0
    assert {"speedup_warm_cache", "speedup_aot", "speedup_cold_parallel"} <= set(res)
