"""The port's bench (``roko_tpu_torch/benchmark.py``, ``python -m
roko_tpu_torch bench``) against the reference's ``roko_tpu/benchmark.py``
on the CPU: the accounting (FLOPs and parameter bytes a window) equal to
the reference's, ``compare_to_previous`` equal on the same results, the
suites' rows on a tiny model with the reference's keys and the right
counts, the JSON line, and the usage errors of the suites the port lacks.
Each test runs a tiny model, or none."""

import dataclasses
import json

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
    ("--pipeline-draft", "60000", "A11"), ("--cascade-draft", "40000", "A10"),
    ("--coldstart-ladder", "32,128", "A9.3"), ("--input-rows", "1536", "A11"),
    ("--fleet-workers", "1,2", "A9"),
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
    group of child processes for each count, windows/s rows, class ids
    byte-identical across counts, the efficiency against the smallest
    count, and counts that do not divide the global batch refused."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the children's torch threads
    out = B.run_mesh_suite((1, 2), iterations=2, global_batch=32, device="cpu",
                           model_overrides=TINY)
    assert out["byte_identical"] is True
    assert out["rows"]["1"]["windows_per_sec"] > 0
    assert out["rows"]["2"]["per_device_batch"] == 16
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
