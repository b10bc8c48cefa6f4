"""The port's bench (``roko_tpu_torch/benchmark.py``, ``python -m
roko_tpu_torch bench``) against the reference's ``roko_tpu/benchmark.py``
on the CPU: the accounting (FLOPs and parameter bytes a window) equal to
the reference's, ``compare_to_previous`` equal on the same results, the
suites' rows on a tiny model with the reference's keys and the right
counts, the JSON line, and the usage errors of the suites the port lacks.
Each test runs a tiny model, or none."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from roko_tpu import benchmark as RB
from roko_tpu.config import ModelConfig as RefModelConfig
from roko_tpu_torch import benchmark as B
from roko_tpu_torch import cli
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ModelConfig
from tests.test_lingru import TINY_GRU
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = {f: getattr(TINY_GRU, f) for f in ("embed_dim", "read_mlp", "hidden_size", "num_layers")}
SIZES = {"default": {}, "tiny": TINY}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kind", ["gru", "lingru"])
@pytest.mark.parametrize("size", list(SIZES))
def test_model_flops_per_window_is_the_references(size, kind, training):
    over = dict(SIZES[size], kind=kind)
    assert B.model_flops_per_window(ModelConfig(**over), training=training) == \
        RB.model_flops_per_window(RefModelConfig(**over), training=training)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["gru", "lingru"])
def test_model_param_bytes_is_the_references(kind, mode):
    """Storage bytes of the parameter tree at the default widths: float32
    whatever the compute dtype, the quantized tree for int8."""
    over = ({"quantize": "int8", "compute_dtype": "float32"} if mode == "int8"
            else {"compute_dtype": mode})
    got = B.model_param_bytes(ModelConfig(kind=kind, **over))
    assert got == RB.model_param_bytes(RefModelConfig(kind=kind, **over))
    assert B.model_param_bytes_per_window(ModelConfig(kind=kind, **over), 512) == got / 512


def _result(value, windows, precision, iterations=20, dtype="float32"):
    """A result with only the keys both packages compare: the reference
    reads none of the port's ``kernels`` columns, and the port none of the
    reference's unported suites."""
    return {"value": value, "vs_baseline": value / 3000.0, "detail": {
        "iterations": iterations, "compute_dtype": dtype, "windows_per_sec": windows,
        "precision": {k: {"f32_windows_per_sec": v, "bf16_windows_per_sec": 2 * v}
                      for k, v in precision.items()},
    }}


def test_compare_to_previous_is_the_references():
    """On two hand-made results, one headline delta inside NOISE_BAND_PCT
    (-6 %), others beyond it either way, a kind absent from the previous
    one and a compute dtype that moved: the same block as the
    reference's."""
    cur = _result(2820.0, 94.0, {"gru": 50.0, "lingru": 400.0}, dtype="bfloat16")
    prev = _result(3525.0, 100.0, {"gru": 40.0})
    want = RB.compare_to_previous(json.loads(json.dumps(cur)), json.loads(json.dumps(prev)))
    got = B.compare_to_previous(cur, prev)
    assert got == want and cur["detail"]["vs_previous"] is got
    assert B.NOISE_BAND_PCT == RB.NOISE_BAND_PCT
    m = got["metrics"]
    assert m["windows_per_sec"]["noise"] is True and "regression" not in m["windows_per_sec"]
    assert m["value"]["regression"] is True
    assert m["precision.gru.f32_windows_per_sec"]["delta_pct"] == 25.0
    assert "precision.lingru.f32_windows_per_sec" not in m
    assert "regime_change" in got


def test_compare_reads_the_ports_kernels_rows(tmp_path):
    """``--compare`` on the port's own rows (``kernels``), and an unreadable
    previous result recorded, never fatal."""
    cur = {"value": 110.0, "vs_baseline": 1.0, "detail": {
        "kernels_windows_per_sec": 105.0,
        "model_kinds": {"lingru": {"kernels_windows_per_sec": 50.0}}}}
    prev = {"value": 100.0, "detail": {
        "kernels_windows_per_sec": 100.0,
        "model_kinds": {"lingru": {"kernels_windows_per_sec": 80.0}}}}
    path = tmp_path / "prev.json"
    path.write_text(json.dumps(prev))
    B._apply_compare(cur, str(path))
    m = cur["detail"]["vs_previous"]["metrics"]
    assert m["kernels_windows_per_sec"]["noise"] is True
    assert m["model_kinds.lingru.kernels_windows_per_sec"]["regression"] is True
    B._apply_compare(cur, str(tmp_path / "missing.json"))
    assert "error" in cur["detail"]["vs_previous"]


@pytest.fixture
def quick(monkeypatch):
    """One warm-up call and a torch reference of one batch of 2 windows."""
    monkeypatch.setattr(B, "WARMUP", 1)
    ref = B.bench_torch_reference
    monkeypatch.setattr(B, "bench_torch_reference", lambda: ref(iters=1, batch=2))


def test_inference_suite_rows_on_a_tiny_model(quick):
    """The reference's keys, with the port's one path ``kernels`` in place of
    ``scan`` and ``pallas``; the batch and iterations as asked; no sweep and
    no mfu_pct off a card; the accounting of the headline config."""
    d = B.run_inference_suite(4, iters=2, device="cpu", model_overrides=TINY)
    assert d["batch"] == 4 and d["iterations"] == 2 and d["compute_dtype"] == "float32"
    assert set(d["batch_sweep"]) == {"4"}
    assert d["batch_sweep"]["4"]["kernels"] > 0
    assert d["windows_per_sec"] == d["kernels_windows_per_sec"] == d["batch_sweep"]["4"]["kernels"]
    assert d["best_batch"] == 4
    for kind, row in d["model_kinds"].items():
        assert row["model_kind"] == kind and row["batch"] == 4 and row["iterations"] == 2
        assert row["kernels_windows_per_sec"] > 0
    assert d["lingru_speedup_vs_gru"] > 0
    rec = d["recurrence_only"]
    assert rec["batch"] == 4 and rec["gru_windows_per_sec"] > 0 and rec["lingru_speedup_vs_gru"] > 0
    for kind in ("gru", "lingru"):
        row = d["precision"][kind]
        assert row["model_kind"] == kind and row["batch"] == 4
        for tag in ("f32", "bf16", "int8"):
            assert row[f"{tag}_windows_per_sec"] > 0
        assert row["f32_param_bytes_per_window"] == row["bf16_param_bytes_per_window"]
        assert row["int8_param_bytes_per_window"] < row["f32_param_bytes_per_window"]
        assert 0 < row["max_abs_logit_delta"] < 1.0 and 0 < row["int8_max_abs_logit_delta"] < 1.0
    ref_cfg = RefModelConfig(compute_dtype="float32", **TINY)
    assert d["model_flops_per_window"] == round(RB.model_flops_per_window(ref_cfg))
    assert d["model_param_bytes"] == RB.model_param_bytes(ref_cfg)
    assert d["param_bytes_per_window"] == round(d["model_param_bytes"] / 4, 1)
    assert "mfu_pct" not in d and "pallas_windows_per_sec" not in d
    assert B.ported_errors({"detail": d}) == []


def test_train_suite_rows_on_a_tiny_model(quick):
    """``train_gru``, the stress row (4 layers, twice the hidden size) and
    ``train_transformer`` (d_model twice the hidden size) timed; every
    other row of the reference's suite an error that says why or names its
    queue item."""
    out = B.run_train_suite(3, iters=1, device="cpu", model_overrides=TINY)
    assert out["batch"] == 3 and out["iterations"] == 1 and out["compute_dtype"] == "float32"
    for name in ("train_gru", "train_scan_stress", "train_transformer"):
        row = out[name]
        assert row["windows_per_sec"] > 0 and row["step_ms"] > 0 and "mfu_pct" not in row
        assert row["windows_per_sec"] == pytest.approx(3 * 1e3 / row["step_ms"], rel=1e-2)
    rows = ("train_gru_remat", "train_gru_remat_scan", "train_gru_rbg", "train_gru_pallas",
            "input_stall")
    assert all(out[r] == {"error": B.UNPORTED_TRAIN_ROWS[r]} for r in rows)
    assert "train_transformer" not in B.UNPORTED_TRAIN_ROWS and "A11" in out["input_stall"]["error"]
    assert B.ported_errors({"detail": {"train": out}}) == []


def test_train_transformer_row_builds_the_references_model(quick, monkeypatch):
    """``train_transformer`` times ``ModelConfig(kind="transformer",
    d_model=2 x hidden)`` in the suite's dtype, as ``roko_tpu/benchmark.py``
    does, and an error in it is an error of a ported row."""
    seen = {}

    def fake(cfg, batch, iters, device="cuda"):
        seen[cfg.kind] = cfg
        if cfg.kind == "transformer":
            raise RuntimeError("encoder exploded")
        return {"step_ms": 1.0, "windows_per_sec": 3000.0}

    monkeypatch.setattr(B, "bench_train", fake)
    out = B.run_train_suite(3, iters=1, device="cpu", model_overrides=TINY)
    cfg = seen["transformer"]
    assert (cfg.d_model, cfg.hidden_size, cfg.num_heads, cfg.compute_dtype) == (
        2 * TINY["hidden_size"], TINY["hidden_size"], 8, "float32")
    assert B.ported_errors({"detail": {"train": out}}) == [
        "train.train_transformer.error: RuntimeError: encoder exploded"]


def test_a_failing_row_is_recorded_and_fails_the_command(quick, monkeypatch, capsys):
    """A row that raises is recorded as its error, the suite goes on, and
    the command exits 1."""

    def infer(cfg, b, iters=1, detail=None, device="cuda"):
        if cfg.kind == "lingru":
            raise RuntimeError("lingru exploded")
        return 100.0

    monkeypatch.setattr(B, "bench_infer", infer)
    monkeypatch.setattr(B, "bench_recurrence", lambda *a, **k: 50.0)
    monkeypatch.setattr(B, "bench_precision", lambda kind, b, i, **k: {"model_kind": kind})
    rc = B.main(["--device", "cpu", "--batch", "4", "--bench-iterations", "1"],
                model_overrides=TINY)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and result["detail"]["windows_per_sec"] == 100.0
    assert "lingru exploded" in result["detail"]["model_kinds"]["lingru"]["error"]
    assert B.ported_errors(result) == ["model_kinds.lingru.error: RuntimeError: lingru exploded"]


def test_bench_json_line(quick, tmp_path, capsys):
    """One JSON line with the reference's top-level keys; value = windows/s
    x WINDOW_STRIDE; --out holds the same object; the suites the port
    lacks shown as errors naming their queue item; rc 0."""
    out = tmp_path / "bench.json"
    rc = B.main(["--device", "cpu", "--batch", "4", "--bench-iterations", "1", "--train",
                 "--out", str(out)], model_overrides=TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    assert rc == 0 and json.loads(out.read_text()) == result
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert result["metric"] == "polished_bases_per_sec_per_chip" and result["unit"] == "bases/s"
    d = result["detail"]
    assert result["value"] == round(d["windows_per_sec"] * C.WINDOW_STRIDE, 1)
    assert result["vs_baseline"] == round(d["windows_per_sec"] / d["torch_cpu_ref_windows_per_sec"],
                                          2)
    assert d["batch"] == 4 and d["iterations"] == 1 and d["train"]["batch"] == 4
    assert d["env"]["backend"] == "cpu" and d["env"]["torch"] == torch.__version__
    for key, (item, _) in B.UNPORTED_SUITES.items():
        assert d[key]["error"].startswith(f"not ported yet (ROADMAP queue item {item})")


def test_torch_reference_is_seeded():
    assert B.bench_torch_reference(iters=1, batch=2) > 0


def test_bench_asks_for_a_card_by_default():
    """Without --device cpu, bench raises when no card is present: no
    silent move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        B.main(["--batch", "4", "--bench-iterations", "1"])
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        cli.main(["bench", "--b", "4", "--bench-iterations", "1"])


@pytest.mark.parametrize("flag,value,item", [
    ("--features", None, "A11"), ("--e2e-draft", "60000", "A11"),
    ("--pipeline-draft", "60000", "A11"), ("--e2e-draft", "1", "A11b"),
    ("--pipeline-draft", "1", "A11b"), ("--input-rows", "1536", "A11"),
    ("--input-rows", "1", "A11b"),
    ("--in-process", None, "deliberately not ported"),
])
def test_unported_suite_flags_are_usage_errors(flag, value, item, capsys):
    """Each flag of a suite the port lacks is a usage error (rc 2) naming
    its queue item, from the CLI and from benchmark.main, before anything
    is measured; its off value (0) is not."""
    argv = [flag] + ([value] if value else [])
    for run in (lambda: cli.main(["bench", "--device", "cpu", *argv]),
                lambda: B.main(["--device", "cpu", *argv])):
        with pytest.raises(SystemExit) as e:
            run()
        assert e.value.code == 2
        assert item in capsys.readouterr().err
    if value:
        args = cli.build_parser().parse_args(["bench", flag, "0"])
        assert B.unported_flag(args) is None


def test_peaks_are_the_h100_data_sheet():
    assert B.card_peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    assert B.card_peaks("NVIDIA H100 80GB HBM3", "bf16") == (989e12, 3.35e12)
    assert B.card_peaks("NVIDIA H100 PCIe", "f32") == (51.2e12, 2.0e12)
    assert B.card_peaks("NVIDIA H100 PCIe", "bf16") == (756e12, 2.0e12)
    assert B._device_peak_flops("cpu", "float32") is None


def test_stress_row_doubles_the_hidden_size(monkeypatch):
    """The stress row's config: 4 layers and twice the hidden size (256 at
    the default widths, as the reference's)."""
    seen = []
    monkeypatch.setattr(B, "bench_train", lambda cfg, *a, **k: seen.append(cfg) or {
        "step_ms": 1.0, "windows_per_sec": 1.0})
    B.run_train_suite(2, iters=1, device="cpu")
    assert dataclasses.replace(seen[0], num_layers=4, hidden_size=256) == seen[1]


def test_mesh_suite_contract(monkeypatch):
    """The mesh suite on the CPU (the contract of
    ``tests/test_mesh_serve.py::test_bench_mesh_suite_contract``): a fresh
    group of child processes for each count, ONE session over them (dp =
    the ranks), windows/s rows, class ids byte-identical across counts,
    the efficiency against the smallest count, and counts that do not
    divide the global batch refused."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the children's torch threads
    out = B.run_mesh_suite((1, 2), iterations=2, global_batch=32, device="cpu",
                           model_overrides=TINY)
    assert out["byte_identical"] is True
    assert out["rows"]["1"]["windows_per_sec"] > 0
    assert out["rows"]["2"]["per_device_batch"] == 16
    assert (out["rows"]["1"]["mesh_dp"], out["rows"]["2"]["mesh_dp"]) == (1, 2)
    assert out["rows"]["2"]["backend"] == "cpu (2 ranks, gloo)"
    assert len(out["rows"]["2"]["launches_by_rank"]) == 2
    assert "2" in out["scaling_efficiency"] and out["efficiency_vs_devices"] == 1
    assert "columns_differing" not in out["rows"]["2"]
    with pytest.raises(ValueError, match="divide"):
        B.run_mesh_suite((3,), global_batch=32, device="cpu")


def test_mesh_devices_flag_runs_the_suite_and_compares(tmp_path, monkeypatch):
    """``--mesh-devices`` reaches the suite from the CLI and from
    ``benchmark.main`` ("0" is off), and ``--compare`` pairs its rows."""
    seen = []

    def fake(counts, **kw):
        seen.append((counts, kw["device"], kw["iterations"]))
        return {"rows": {str(n): {"windows_per_sec": 100.0 * n} for n in counts}}

    monkeypatch.setattr(B, "run_mesh_suite", fake)
    monkeypatch.setattr(B, "bench_torch_reference", lambda: 1.0)
    monkeypatch.setattr(B, "run_inference_suite",
                        lambda *a, **k: {"windows_per_sec": 1.0, "iterations": 1})
    prev = tmp_path / "prev.json"
    assert cli.main(["bench", "--device", "cpu", "--bench-iterations", "1",
                     "--mesh-devices", "1,2", "--out", str(prev)]) == 0
    assert B.main(["--device", "cpu", "--mesh-devices", "1,2", "--compare", str(prev)]) == 0
    assert B.main(["--device", "cpu", "--mesh-devices", "0"]) == 0
    assert seen == [((1, 2), "cpu", 1), ((1, 2), "cpu", B.ITERS)]
    assert B.parse_counts("1,2,4") == (1, 2, 4) and B.parse_counts(None) == ()
    result = B._assemble_result({"windows_per_sec": 1.0,
                                 "mesh": fake((1, 2), device="cpu", iterations=1)}, 1.0)
    block = B.compare_to_previous(result, json.loads(prev.read_text()))
    assert block["metrics"]["mesh.2.windows_per_sec"]["delta_pct"] == 0.0


def _key_paths(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _key_paths(v, prefix + k + ".")
    return out


def test_serve_suite_rows_are_the_references():
    """The serve suite on a tiny model at a tiny mix (8 requests of 2 and
    8 windows): the row keys of ``roko_tpu.benchmark.run_serve_suite`` on
    the same mix and widths, its ``autoscale`` row (the fleet's
    Autoscaler on the batcher's real backlog) included, with the
    reference's worker trajectory; every mode byte-identical and
    error-free; and no error counts against the command."""
    from roko_tpu.config import RokoConfig as RefRokoConfig

    got = B.run_serve_suite("2:50,8:50", iterations=8, device="cpu", model_overrides=TINY)
    want = RB.run_serve_suite("2:50,8:50", iterations=8,
                              config_json=RefRokoConfig(model=RefModelConfig(**TINY)).to_json())
    assert _key_paths(got) == _key_paths(want)
    assert B.UNPORTED_SERVE_ROWS == {}
    assert got["autoscale"]["scaled_up"] and got["autoscale"]["scaled_down"]
    assert [p["phase"] for p in got["autoscale"]["phases"]] == ["idle", "flood", "drain"]
    assert got["ladder"] == want["ladder"] == [8] and got["iterations"] == 8
    for mode, row in got["modes"].items():
        assert row["byte_identical"] is True and row["client_errors"] == 0, mode
        assert sum(c["requests"] for c in row["size_classes"].values()) == 8
    assert got["modes"]["ragged"]["padding_efficiency"] == 1.0
    assert got["precision"]["modes"]["float32+int8"]["byte_identical"] is True
    assert B.ported_errors({"detail": {"serve": got}}) == []


def test_serve_mix_flag_runs_the_suite(monkeypatch):
    """``--serve-mix`` reaches the suite from the CLI and from
    ``benchmark.main``: bare, the device's default mix; "off" and absent,
    no suite; a failing suite is a ported error."""
    seen = []

    def fake(mix, **kw):
        seen.append((mix, kw["device"].type, kw["iterations"]))
        return {"modes": {}, "autoscale": {"worker_trajectory": [2]}}

    monkeypatch.setattr(B, "run_serve_suite", fake)
    monkeypatch.setattr(B, "bench_torch_reference", lambda: 1.0)
    monkeypatch.setattr(B, "run_inference_suite",
                        lambda *a, **k: {"windows_per_sec": 1.0, "iterations": 1})
    assert cli.main(["bench", "--device", "cpu", "--serve-mix"]) == 0
    assert B.main(["--device", "cpu", "--serve-mix", "2:50,8:50", "--bench-iterations", "3"]) == 0
    assert B.main(["--device", "cpu", "--serve-mix", "off"]) == 0
    assert B.main(["--device", "cpu"]) == 0
    assert seen == [(B.SERVE_MIX_DEFAULT_CPU, "cpu", B.SERVE_SUITE_REQUESTS),
                    ("2:50,8:50", "cpu", 3)]
    assert (B.SERVE_MIX_DEFAULT_TPU, B.SERVE_SUITE_REQUESTS, B.SERVE_SUITE_CLIENTS) == \
        (RB.SERVE_MIX_DEFAULT_TPU, RB.SERVE_SUITE_REQUESTS, RB.SERVE_SUITE_CLIENTS)
    monkeypatch.setattr(B, "run_serve_suite", lambda mix, **kw: {"error": "boom"})
    assert B.main(["--device", "cpu", "--serve-mix", "2:100"]) == 1
    with pytest.raises(ValueError, match="sum to"):
        B._parse_mix("2:50")


def test_coldstart_and_fleet_flags_run_their_suites(monkeypatch):
    """``--coldstart-ladder`` and ``--fleet-workers`` reach their suites
    from the CLI and from ``benchmark.main``; 0 and absent run neither; a
    failing suite is a ported error."""
    seen = []
    monkeypatch.setattr(B, "run_coldstart_suite",
                        lambda ladder, **kw: seen.append(("cold", ladder, kw["device"])) or {})
    monkeypatch.setattr(B, "run_fleet_suite",
                        lambda counts, **kw: seen.append(("fleet", counts, kw["iterations"]))
                        or {})
    monkeypatch.setattr(B, "bench_torch_reference", lambda: 1.0)
    monkeypatch.setattr(B, "run_inference_suite",
                        lambda *a, **k: {"windows_per_sec": 1.0, "iterations": 1})
    assert cli.main(["bench", "--device", "cpu", "--coldstart-ladder", "8,16"]) == 0
    assert B.main(["--device", "cpu", "--fleet-workers", "1,2", "--bench-iterations", "3"]) == 0
    assert B.main(["--device", "cpu", "--coldstart-ladder", "0", "--fleet-workers", "0"]) == 0
    assert seen == [("cold", (8, 16), "cpu"), ("fleet", (1, 2), 3)]
    assert (B.FLEET_ITERS, B.FLEET_CLIENTS, B.FLEET_REQUEST_WINDOWS) == \
        (RB.FLEET_ITERS, RB.FLEET_CLIENTS, RB.FLEET_REQUEST_WINDOWS)
    assert B.DEFAULT_COLDSTART_LADDER == RB.DEFAULT_COLDSTART_LADDER
    monkeypatch.setattr(B, "run_fleet_suite", lambda counts, **kw: {"error": "boom"})
    assert B.main(["--device", "cpu", "--fleet-workers", "2"]) == 1


def test_fleet_suite_rows_are_the_references():
    """The fleet suite on a tiny model over real ``serve --device cpu``
    workers: the reference's rows (req/s, p99, mean, errors a worker
    count, the scaling efficiency, the SIGKILL phase) plus each count's
    ready seconds; no client error, the killed worker back."""
    got = B.run_fleet_suite((1, 2), iterations=2, device="cpu", model_overrides=TINY)
    assert set(got["workers"]) == {"1", "2"} and "scaling_efficiency" in got
    for row in got["workers"].values():
        assert {"req_per_s", "p99_s", "mean_s", "client_errors", "ready_s"} <= set(row)
        assert row["client_errors"] == 0
    kill = got["forced_kill"]
    assert kill["client_errors"] == 0 and kill["worker_rejoined"] and kill["restarts"] >= 1
    assert set(kill) == {"workers", "req_per_s_during_kill", "p99_s", "client_errors",
                         "failovers", "restarts", "worker_rejoined"}


#: the cascade suite's rows in ``roko_tpu.benchmark.run_cascade_suite``
REF_CASCADE_ROWS = {"draft_len", "coverage", "threshold", "windows", "reference_windows_per_sec",
                    "threshold0_identical", "cascade_windows_per_sec", "speedup_vs_reference",
                    "escalation_pct", "cold_cache_hit_rate", "cache_hit_rate"}


def test_cascade_suite_rows_are_the_references():
    """The cascade suite on a tiny model and a 4 kb sim draft: the
    reference's rows; threshold 0's FASTA the plain one's; the warm run
    over the shared on-disk cache hits every window; the escalation share
    is the reference router's on the same windows."""
    from roko_tpu.cascade import Calibration as RefCalibration
    from roko_tpu.cascade import CascadeRouter as RefRouter

    got = B.run_cascade_suite(4000, coverage=8, device="cpu", model_overrides=TINY)
    assert set(got) == REF_CASCADE_ROWS
    assert got["threshold0_identical"] is True and got["windows"] > 50
    assert got["cold_cache_hit_rate"] == 0.0 and got["cache_hit_rate"] == 1.0
    _, batches = B.cascade_corpus(4000, coverage=8)
    ref = RefRouter(threshold=0.05, params_digest="p", cache_bytes=0,
                    calibration=RefCalibration(temperature=8.0))
    for _, _, x in batches:
        ref.route(x, lambda xs: np.zeros(xs.shape[::2], np.int32))
    assert got["escalation_pct"] == round(100.0 * ref.stats()["escalation_fraction"], 1)
    assert B.ported_errors({"detail": {"cascade": got}}) == []


def test_cascade_draft_flag_runs_the_suite(monkeypatch):
    """``--cascade-draft`` reaches the suite from the CLI and from
    ``benchmark.main``; 0 and absent run none; a failing suite is a ported
    error."""
    seen = []
    monkeypatch.setattr(B, "run_cascade_suite",
                        lambda n, **kw: seen.append((n, kw["device"].type)) or {})
    monkeypatch.setattr(B, "bench_torch_reference", lambda: 1.0)
    monkeypatch.setattr(B, "run_inference_suite",
                        lambda *a, **k: {"windows_per_sec": 1.0, "iterations": 1})
    assert cli.main(["bench", "--device", "cpu", "--cascade-draft", "5000"]) == 0
    assert B.main(["--device", "cpu", "--cascade-draft", "0"]) == 0
    assert B.main(["--device", "cpu"]) == 0
    assert seen == [(5000, "cpu")]
    monkeypatch.setattr(B, "run_cascade_suite", lambda n, **kw: {"error": "boom"})
    assert B.main(["--device", "cpu", "--cascade-draft", "100"]) == 1


# -- the fleet suite's mixed-size phase ----------------------------------------


@pytest.mark.parametrize("spec", ["4:90,256:10", "2:50,8:50", "4:90,64:10", "1:33,5:33,9:34",
                                  "16:100", "3:0,7:100", "8:60.5,2:39.5"])
def test_parse_mix_is_the_references(spec):
    assert B._parse_mix(spec) == RB._parse_mix(spec)


@pytest.mark.parametrize("spec", ["4:90,256", "a:50,b:50", "0:100", "4:-5,8:105", "2:50",
                                  "", "4:90;256:10"])
def test_parse_mix_refuses_as_the_reference(spec):
    with pytest.raises(ValueError) as want:
        RB._parse_mix(spec)
    with pytest.raises(ValueError) as got:
        B._parse_mix(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("total", [1, 8, 48, 75])
@pytest.mark.parametrize("spec", ["4:90,256:10", "2:50,8:50", "1:33,5:33,9:34", "3:0,7:100"])
def test_mix_schedule_is_the_references(spec, total, seed):
    """One seed, one schedule: the size classes and their order."""
    mix = B._parse_mix(spec)
    got = B._mix_schedule(mix, total, seed=seed)
    assert got == RB._mix_schedule(RB._parse_mix(spec), total, seed=seed)
    assert set(got) == {s for s, p in mix if p}


def test_mixed_latency_row_is_the_references():
    rng = np.random.default_rng(3)
    lat = {4: list(rng.random(9)), 256: list(rng.random(2)), 64: []}
    assert B._mixed_latency_row(1.25, 12, lat) == RB._mixed_latency_row(1.25, 12, lat)
    assert B._mixed_latency_row(0.0, 0, {4: []}) == RB._mixed_latency_row(0.0, 0, {4: []})


def test_fleet_suite_refuses_a_bad_mix_before_any_fleet(monkeypatch):
    """A typo'd mix fails at once, before the suite's fleets start."""

    def no_fleet(*a, **k):
        raise AssertionError("a fleet started")

    monkeypatch.setattr(B, "_FleetBench", no_fleet)
    with pytest.raises(ValueError, match="sum to 50"):
        B.run_fleet_suite((1, 2), device="cpu", mix="2:50")
    with pytest.raises(ValueError, match="bad --serve-mix"):
        B.run_fleet_mixed_phase("2:x", device="cpu")


def test_serve_mix_reaches_the_fleet_suite(monkeypatch):
    """An explicit ``--serve-mix`` (bare: the device's default mix) is the
    fleet suite's ``mix``; without one, or with ``off``, the suite runs
    without its mixed phase."""
    seen = []
    monkeypatch.setattr(B, "run_fleet_suite",
                        lambda counts, **kw: seen.append((counts, kw["mix"])) or {})
    monkeypatch.setattr(B, "run_serve_suite", lambda mix, **kw: {"modes": {}})
    monkeypatch.setattr(B, "bench_torch_reference", lambda: 1.0)
    monkeypatch.setattr(B, "run_inference_suite",
                        lambda *a, **k: {"windows_per_sec": 1.0, "iterations": 1})
    assert B.main(["--device", "cpu", "--fleet-workers", "1,2", "--serve-mix", "2:50,8:50"]) == 0
    assert cli.main(["bench", "--device", "cpu", "--fleet-workers", "2", "--serve-mix"]) == 0
    assert B.main(["--device", "cpu", "--fleet-workers", "1", "--serve-mix", "off"]) == 0
    assert B.main(["--device", "cpu", "--fleet-workers", "1"]) == 0
    assert seen == [((1, 2), "2:50,8:50"), ((2,), B.SERVE_MIX_DEFAULT_CPU), ((1,), None),
                    ((1,), None)]


#: the keys of ``roko_tpu.benchmark.run_fleet_suite``'s ``results["mixed"]``
#: (:3066-3070, :3163-3197): the phase, and each mode's
#: ``_mixed_latency_row`` with ``client_errors`` and ``padding_efficiency``
REF_MIXED_KEYS = {"mix", "workers", "requests", "modes"}
REF_MIXED_MODE_KEYS = set(RB._mixed_latency_row(1.0, 1, {2: [0.5]})) | {
    "client_errors", "padding_efficiency"}


def test_fleet_suite_mixed_phase_rows_are_the_references():
    """``run_fleet_suite((1,), mix="2:50,8:50")`` on a tiny model over a
    real ``serve --device cpu`` worker: ``results["mixed"]`` with the
    reference's keys for both batchers, every scheduled request answered
    without a client error, both size classes timed, the padding
    efficiency of the timed pass within (0, 1]."""
    got = B.run_fleet_suite((1,), iterations=2, device="cpu", model_overrides=TINY,
                            mix="2:50,8:50")
    assert set(got["workers"]) == {"1"} and got["workers"]["1"]["client_errors"] == 0
    mixed = got["mixed"]
    assert set(mixed) == REF_MIXED_KEYS and set(mixed["modes"]) == {"deadline", "continuous"}
    schedule = RB._mix_schedule(RB._parse_mix("2:50,8:50"), B.FLEET_CLIENTS * 2)
    assert (mixed["mix"], mixed["workers"], mixed["requests"]) == ("2:50,8:50", 1,
                                                                   len(schedule))
    for mode, row in mixed["modes"].items():
        assert set(row) == REF_MIXED_MODE_KEYS, mode
        assert row["client_errors"] == 0 and row["requests_scheduled"] == len(schedule)
        assert {int(s): c["requests"] for s, c in row["size_classes"].items()} == \
            {s: schedule.count(s) for s in set(schedule)}
        assert 0.0 < row["padding_efficiency"] <= 1.0
    assert B.ported_errors({"detail": {"fleet": got}}) == []
