"""One polishing session over several ranks (``roko_tpu_torch/serve/
session.py`` on a ``parallel.mesh.Mesh``), the port's counterpart of
``tests/test_mesh_serve.py``, on the CPU with gloo ranks.

Each process group starts once per module: ``tests/torch_dp_worker.py``'s
``mesh_serve`` mode on 2 and on 4 ranks, and four ``python -m
roko_tpu_torch serve`` groups of 2. The weights are the reference's
random ``TINY`` parameters carried over by ``models/convert.py``.

- the sessions over 2 and 4 ranks return the class ids of the reference's
  ``PolishSession`` on 2 and 4 of the conftest's fake devices and of the
  port's one-rank session, padded and ragged, with every dispatched shape
  on the ladder; the auto ladder is ``ladder_base x dp``, and the
  continuous and ragged batchers pack it to the one-rank predictions;
- ``resolve_ladder`` and ``validate_ladder`` against the reference's;
- the stream on 2 ranks writes the one-rank stream's FASTA bytes and
  ``roko_tpu``'s stream on a dp=2 mesh; a one-rank bundle is refused by
  the 2-rank session, naming the mesh;
- ``serve --dp 2``: ``/healthz`` names the grid, replies equal the
  one-rank server's under the continuous and ragged batchers, SIGTERM on
  rank 0 exits both ranks 0, and a killed follower makes rank 0 answer
  5xx, report the session broken and exit non-zero;
- ``serve --tp 2`` and ``--sp 2`` of a tiny transformer answer with the
  one-rank session's replies.

Every wait is bounded: a rank that hangs fails its test."""

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from roko_tpu.config import MeshConfig as JMesh
from roko_tpu.config import ModelConfig as JModelConfig
from roko_tpu.config import RokoConfig as JRoko
from roko_tpu.config import ServeConfig as JServe
from roko_tpu.config import resolve_ladder as ref_resolve_ladder
from roko_tpu.config import validate_ladder as ref_validate_ladder
from roko_tpu.models.model import RokoModel as JModel
from roko_tpu.parallel.mesh import make_mesh as ref_make_mesh
from roko_tpu.pipeline import run_streaming_polish as ref_streaming_polish
from roko_tpu.serve.session import PolishSession as RefSession
from roko_tpu_torch import constants as C
from roko_tpu_torch.compile import export_bundle
from roko_tpu_torch.config import ModelConfig, RokoConfig, ServeConfig, resolve_ladder
from roko_tpu_torch.config import validate_ladder
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.pipeline import run_streaming_polish
from roko_tpu_torch.serve import server as port_server
from roko_tpu_torch.serve.client import PolishClient
from roko_tpu_torch.serve.scheduler import _RETRY_AFTER_MAX_S, _RETRY_AFTER_MIN_S
from roko_tpu_torch.serve.session import PolishSession
from tests import torch_dp_worker as W
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=1)
LADDER = (8, 16)
SIZES = (1, 8, 13, 16, 20, 40)
RAGGED = (0, 1, 8, 13, 16)
BATCHER_SIZES = (3, 16, 1, 9, 24)
STREAM = dict(seed=5, batch=16)
SERVE = dict(ladder=LADDER, max_queue_age_ms=20.0, max_delay_ms=20.0)
#: the transformer of the tp and sp groups: 4 heads over tp 2, 90 columns over sp 2
TRANSFORMER = ModelConfig(kind="transformer", d_model=32, num_heads=4, **TINY)
LAUNCH_S = 300.0


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The reference's random TINY parameters, the port's model of them
    (and its ``.pth``), the windows, a 4 kb simulated project and a
    one-rank kernel bundle."""
    from roko_tpu_torch.sim import build_synthetic_project

    root = tmp_path_factory.mktemp("mesh_serve")
    params = jax.tree.map(np.asarray, JModel(JModelConfig(**TINY)).init(jax.random.PRNGKey(0)))
    model = RokoModel(ModelConfig(**TINY))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    weights = str(root / "m.pth")
    torch.save(model.state_dict(), weights)
    rng = np.random.default_rng(3)
    x = rng.integers(0, C.FEATURE_VOCAB, (max(SIZES), C.WINDOW_ROWS, C.WINDOW_COLS)
                     ).astype(np.uint8)
    slab = rng.integers(0, C.FEATURE_VOCAB, (LADDER[-1], C.WINDOW_ROWS, C.WINDOW_COLS)
                        ).astype(np.uint8)
    np.savez(root / "windows.npz", x=x, slab=slab)
    project = build_synthetic_project(str(root / "proj"), genome_len=4000, seed=3, coverage=10)
    bundle = str(root / "bundle1")
    export_bundle(bundle, RokoConfig(model=ModelConfig(**TINY)), ladder=(8,), device="cpu",
                  log=quiet)
    return dict(root=root, params=params, model=model, weights=weights, x=x, slab=slab,
                project=project, bundle=bundle)


def _launch(work, ranks: int, **extra):
    out = work["root"] / f"ranks{ranks}"
    out.mkdir()
    spec = dict(model=TINY, weights=work["weights"], windows=str(work["root"] / "windows.npz"),
                ladder=LADDER, sizes=SIZES, ragged=RAGGED, batcher_sizes=BATCHER_SIZES, **extra)
    (out / "spec.json").write_text(json.dumps(spec))
    W.launch("mesh_serve", str(out), ranks=ranks, timeout=LAUNCH_S)
    got = dict(np.load(out / "mesh_serve.npz"))
    return got, json.loads((out / "mesh_serve.json").read_text()), out


@pytest.fixture(scope="module")
def ranks(work):
    """Rank 0's results of the 2-rank group (with the bundle and the
    stream) and of the 4-rank group."""
    p = work["project"]
    two = _launch(work, 2, bundle=work["bundle"],
                  project=dict(ref=p["draft_fasta"], bam=p["reads_bam"], **STREAM))
    return {2: two, 4: _launch(work, 4)}


@pytest.fixture(scope="module")
def one_rank(work):
    """The port's one-rank session on the same weights and windows."""
    s = PolishSession(work["model"], RokoConfig(model=ModelConfig(**TINY)), device="cpu",
                      ladder=LADDER)
    padded = {n: s.predict(work["x"][:n]) for n in SIZES}
    ragged = {n: s.predict_ragged(work["slab"].copy(), n) for n in RAGGED}
    return padded, ragged


def _ref_session(params, dp):
    cfg = JRoko(model=JModelConfig(**TINY), mesh=JMesh(dp=dp))
    return RefSession(params, cfg, mesh=ref_make_mesh(cfg.mesh, jax.devices()[:dp]),
                      ladder=LADDER)


# -- the session over ranks ---------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4])
def test_session_over_ranks_equals_reference_and_one_rank(work, ranks, one_rank, dp):
    got, info, _ = ranks[dp]
    padded, ragged = one_rank
    ref = _ref_session(work["params"], dp)
    assert (ref.dp, info["dp"], info["n_devices"]) == (dp, dp, dp)
    for n in SIZES:
        want = np.asarray(ref.predict(work["x"][:n]))
        np.testing.assert_array_equal(got[f"padded{n}"], want, err_msg=f"padded {n}")
        np.testing.assert_array_equal(padded[n], want, err_msg=f"one rank {n}")
    for n in RAGGED:
        want = np.asarray(ref.predict_ragged(work["slab"].copy(), n))
        np.testing.assert_array_equal(got[f"ragged{n}"], want, err_msg=f"ragged {n}")
        np.testing.assert_array_equal(ragged[n], want, err_msg=f"one rank ragged {n}")
    assert set(info["dispatched"]) <= set(info["ladder"]) == set(LADDER)
    assert ref.dispatched_shapes <= set(LADDER)
    # every global rung reached every rank
    assert info["dispatches"] >= len(SIZES) + len(RAGGED)


@pytest.mark.parametrize("dp", [2, 4])
def test_auto_ladder_scales_and_batchers_pack_over_ranks(work, ranks, one_rank, dp):
    """``ladder_base`` (2, 4) x dp, as the reference's session resolves it;
    both batchers start empty and answer the one-rank predictions."""
    got, info, _ = ranks[dp]
    ref = RefSession(work["params"], JRoko(model=JModelConfig(**TINY), mesh=JMesh(dp=dp),
                                           serve=JServe(ladder_base=(2, 4))),
                     mesh=ref_make_mesh(JMesh(dp=dp), jax.devices()[:dp]))
    assert info["auto_ladder"] == list(ref.ladder) == [2 * dp, 4 * dp]
    one = PolishSession(work["model"], RokoConfig(model=ModelConfig(**TINY)), device="cpu",
                        ladder=LADDER)
    top = info["auto_ladder"][-1]
    for cls in ("ContinuousBatcher", "RaggedBatcher"):
        assert info[f"{cls}_occupancy0"] == 0.0
        # the slot slab, the snapshot and the Retry-After EMA in global rungs
        d = info[f"{cls}_denomination"]
        assert d["ladder"] == info["auto_ladder"] and d["slab"] == top
        assert d["retry_after_s"] == pytest.approx(
            min(_RETRY_AFTER_MAX_S, max(_RETRY_AFTER_MIN_S, top / d["ema_windows_per_s"])))
        for n in BATCHER_SIZES:
            np.testing.assert_array_equal(got[f"{cls}{n}"], one.predict(work["x"][:n]),
                                          err_msg=f"{cls} {n}")
    assert set(info["auto_dispatched"]) <= set(info["auto_ladder"])


@pytest.mark.parametrize("dp,base,ladder", [
    (1, None, None), (8, None, None), (4, (2, 4), None), (4, None, (8, 16)), (3, (5,), None),
    (2, None, (6, 2, 6)),
])
def test_resolve_ladder_equals_reference(dp, base, ladder):
    kw = {k: v for k, v in (("ladder_base", base), ("ladder", ladder)) if v is not None}
    assert resolve_ladder(ServeConfig(**kw), dp) == ref_resolve_ladder(JServe(**kw), dp)


def test_resolve_ladder_refuses_dp_0_as_reference():
    for fn, serve in ((resolve_ladder, ServeConfig()), (ref_resolve_ladder, JServe())):
        with pytest.raises(ValueError, match="dp axis must be >= 1"):
            fn(serve, 0)


@pytest.mark.parametrize("rungs,dp", [
    ((6,), 4), ((12,), 8), ((-8,), 8), ((0, 3, 7), 2), ((8, 16), 8), ((5,), 1),
])
def test_validate_ladder_equals_reference(rungs, dp):
    errors = []
    for fn in (validate_ladder, ref_validate_ladder):
        try:
            fn(rungs, dp)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    if errors[0] is not None:
        assert f"dp axis (dp={dp})" in errors[0]


def test_ladder_error_names_the_dp_axis_at_session_build(work):
    from roko_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError) as e:
        PolishSession(work["model"], device="cpu", mesh=Mesh(dp=4), ladder=(6,))
    assert "dp axis (dp=4)" in str(e.value) and "6 -> 4 or 8" in str(e.value)


def test_stream_on_two_ranks_equals_one_rank_and_reference(work, ranks, tmp_path):
    p = work["project"]
    _, _, out = ranks[2]
    got = (out / "stream.fasta").read_bytes()
    one = tmp_path / "one.fasta"
    run_streaming_polish(p["draft_fasta"], p["reads_bam"], work["model"],
                         RokoConfig(model=ModelConfig(**TINY)), out_path=str(one),
                         seed=STREAM["seed"], batch_size=STREAM["batch"], device="cpu", log=quiet)
    ref = tmp_path / "ref.fasta"
    ref_streaming_polish(p["draft_fasta"], p["reads_bam"], work["params"],
                         JRoko(model=JModelConfig(**TINY), mesh=JMesh(dp=2)),
                         out_path=str(ref), seed=STREAM["seed"], batch_size=STREAM["batch"],
                         mesh=ref_make_mesh(JMesh(dp=2), jax.devices()[:2]), log=quiet)
    # random weights vote mostly GAP, so the polished contig is short
    assert got == one.read_bytes() == ref.read_bytes() and got.startswith(b">ctg\n")


def test_stream_refuses_a_batch_that_does_not_divide_over_dp(work):
    from roko_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="batch_size 15 not divisible by dp=2"):
        run_streaming_polish(None, None, work["model"], device="cpu", batch_size=15,
                             mesh=Mesh(dp=2), log=quiet)


def test_one_rank_bundle_refused_by_two_rank_session(ranks):
    _, info, _ = ranks[2]
    assert "mesh.dp: bundle=1 run=2" in info["bundle"]


# -- serve over ranks through the command line --------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raw(base, path, payload=None, timeout=60.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def start_ranks(tmp_path, argv, ranks=2):
    """``ranks`` processes of ``python -m roko_tpu_torch ARGV`` under
    ``ROKO_*``, each logging to ``rank{r}.log``; (procs, log paths)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ROKO_")
           and k != "PYTHONPATH"}
    env.update(ROKO_COORDINATOR=f"127.0.0.1:{_free_port()}", ROKO_NUM_PROCESSES=str(ranks),
               OMP_NUM_THREADS="1")
    logs = [tmp_path / f"rank{r}.log" for r in range(ranks)]
    procs = []
    for r in range(ranks):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "roko_tpu_torch", *argv, "--device", "cpu"],
                cwd=str(ROOT), env={**env, "ROKO_PROCESS_ID": str(r)}, stdout=f,
                stderr=subprocess.STDOUT))
    return procs, logs


@contextlib.contextmanager
def serve_ranks(tmp_path, model_cfg, weights, argv, ranks=2):
    """``ranks`` processes of ``python -m roko_tpu_torch serve`` under
    ``ROKO_*``; yields (procs, base url, log paths) once rank 0 is ready,
    and kills what is left at the end."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(RokoConfig(model=model_cfg).to_json())
    announce = tmp_path / "announce.json"
    procs, logs = start_ranks(tmp_path, [
        "serve", weights, "--config", str(cfg), "--port", "0", "--announce", str(announce),
        "--ladder", ",".join(map(str, LADDER)), *argv], ranks)
    try:
        t0 = time.monotonic()
        while not announce.exists():
            assert all(p.poll() is None for p in procs), [f.read_text() for f in logs]
            assert time.monotonic() - t0 < LAUNCH_S
            time.sleep(0.05)
        base = f"http://127.0.0.1:{json.loads(announce.read_text())['port']}"
        while _raw(base, "/healthz")[0] != 200:
            assert procs[0].poll() is None, logs[0].read_text()
            assert time.monotonic() - t0 < LAUNCH_S
            time.sleep(0.05)
        yield procs, base, logs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _payloads(seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for n in (0, 3, 7, 21):
        x = rng.integers(0, C.FEATURE_VOCAB, (n, C.WINDOW_ROWS, C.WINDOW_COLS)).astype(np.uint8)
        positions = np.zeros((n, C.WINDOW_COLS, 2), np.int64)
        for i in range(n):
            positions[i, :, 0] = np.arange(i * C.WINDOW_STRIDE,
                                           i * C.WINDOW_STRIDE + C.WINDOW_COLS)
        out.append(("".join(rng.choice(list("ACGT"), 900)), positions, x))
    return out


def _one_rank_replies(model, model_cfg, batching):
    """The one-rank server's ``polished`` replies to :func:`_payloads`."""
    session = PolishSession(model, RokoConfig(model=model_cfg), device="cpu", ladder=LADDER)
    srv = port_server.make_server(session, ServeConfig(batching=batching, **SERVE), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        client = PolishClient(f"http://127.0.0.1:{srv.server_address[1]}", timeout=60.0)
        return [client.polish(d, pos, x)["polished"] for d, pos, x in _payloads()]
    finally:
        srv.shutdown()
        srv.batcher.stop()
        srv.server_close()
        thread.join(5.0)


def _polished(base):
    client = PolishClient(base, timeout=60.0)
    return [client.polish(d, pos, x)["polished"] for d, pos, x in _payloads()]


def test_serve_dp2_continuous_replies_healthz_and_sigterm(work, tmp_path):
    """``serve --dp 2``: the grid in ``/healthz`` and the ready line, the
    one-rank server's replies, and SIGTERM on rank 0 stopping both ranks
    with exit 0."""
    model_cfg = ModelConfig(**TINY)
    want = _one_rank_replies(work["model"], model_cfg, "continuous")
    with serve_ranks(tmp_path, model_cfg, work["weights"],
                     ["--dp", "2", "--batching", "continuous"]) as (procs, base, logs):
        status, health = _raw(base, "/healthz")
        assert (status, health["mesh_dp"], health["devices"]) == (200, 2, 2)
        assert health["ladder"] == list(LADDER) and health["batching"] == "continuous"
        assert _polished(base) == want
        procs[0].send_signal(signal.SIGTERM)
        assert [p.wait(60) for p in procs] == [0, 0], [f.read_text() for f in logs]
    out0, out1 = logs[0].read_text(), logs[1].read_text()
    assert "mesh dp=2 over 2 device(s); warming predict ladder (8, 16) = 2 x per-device " \
        "(4, 8)" in out0 and "drained clean" in out0
    assert "rank 1 of 2 (dp=2 tp=1 sp=1)" in out1 and "stopped by rank 0" in out1


def test_serve_dp2_ragged_replies_then_a_killed_follower_fails_loudly(work, tmp_path):
    """Under the ragged batcher the replies are the one-rank server's; then
    rank 1 is SIGKILLed: rank 0 answers 5xx, ``/healthz`` says the session
    broke, and rank 0 exits non-zero instead of hanging."""
    model_cfg = ModelConfig(**TINY)
    want = _one_rank_replies(work["model"], model_cfg, "ragged")
    with serve_ranks(tmp_path, model_cfg, work["weights"],
                     ["--dp", "2", "--batching", "ragged", "--predict-deadline", "30"]) as \
            (procs, base, logs):
        assert _polished(base) == want
        procs[1].kill()
        procs[1].wait()
        draft, positions, x = _payloads()[2]
        import base64

        payload = {"draft": draft, "n": len(x),
                   "positions": base64.b64encode(positions.astype("<i8").tobytes()).decode(),
                   "examples": base64.b64encode(x.tobytes()).decode()}
        t0 = time.monotonic()
        status, body = _raw(base, "/polish", payload)
        assert status >= 500, body
        assert time.monotonic() - t0 < 35.0
        status, health = _raw(base, "/healthz")
        assert status == 503 and health["status"] == "broken" and health["broken"]
        assert procs[0].wait(60) != 0
    assert "session broken" in logs[0].read_text()


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_serve_transformer_over_tp_or_sp_equals_one_rank(tmp_path, axis):
    model = RokoModel(TRANSFORMER, torch.Generator().manual_seed(2))
    weights = str(tmp_path / "t.pth")
    torch.save(model.state_dict(), weights)
    want = _one_rank_replies(model, TRANSFORMER, "continuous")
    with serve_ranks(tmp_path, TRANSFORMER, weights,
                     [f"--{axis}", "2", "--batching", "continuous"]) as (procs, base, logs):
        health = _raw(base, "/healthz")[1]
        assert (health["mesh_dp"], health["devices"]) == (1, 2)
        assert _polished(base) == want
        procs[0].send_signal(signal.SIGTERM)
        assert [p.wait(60) for p in procs] == [0, 0], [f.read_text() for f in logs]


def test_compile_over_two_ranks_writes_one_bundle_of_the_grid(tmp_path):
    """``compile --dp 2`` as two processes: the ladder resolves against dp
    (``ladder_base`` x 2), rank 0 alone writes the bundle, its identity
    names the grid, and the fresh-process check passes."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(RokoConfig(model=ModelConfig(**TINY),
                              serve=ServeConfig(ladder_base=(2, 4))).to_json())
    out = tmp_path / "bundle"
    procs, logs = start_ranks(tmp_path, ["compile", str(out), "--config", str(cfg),
                                         "--dp", "2"])
    try:
        assert [p.wait(LAUNCH_S) for p in procs] == [0, 0], [f.read_text() for f in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["identity"]["mesh"] == {"dp": 2, "tp": 1, "sp": 1}
    assert manifest["rungs"] == [4, 8]
    assert "mesh=dp2xtp1xsp1" in logs[0].read_text()
    assert "verified 2 rung(s): [4, 8] (fresh process)" in logs[0].read_text()


def test_serve_fleet_flags_under_several_processes_are_usage_errors(tmp_path, capsys,
                                                                    monkeypatch):
    """``--workers``, ``--federation``, ``--host-agent`` and ``--join`` run
    process trees of their own: under ``ROKO_*`` they are usage errors, read
    before any process group forms."""
    from roko_tpu_torch import cli

    monkeypatch.setenv("ROKO_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("ROKO_NUM_PROCESSES", "2")
    monkeypatch.setenv("ROKO_PROCESS_ID", "0")
    for argv, flag in ((["m.pth", "--workers", "2"], "--workers"), (["--federation"],
                       "--federation"), (["m.pth", "--host-agent", "--join", "h:1",
                                          "--workers", "1"], "--workers"),
                       (["m.pth", "--join", "h:1"], "--join")):
        with pytest.raises(SystemExit) as e:
            cli.main(["serve", *argv, "--device", "cpu"])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert f"serve {flag} runs a process tree of its own; run it from one process" in err
    assert list(tmp_path.iterdir()) == []


def test_session_over_ranks_marks_itself_broken_and_refuses(work):
    """A failed dispatch of a session over several ranks breaks it: the
    reason is kept, the callbacks run once, and every later dispatch
    raises ``SessionBroken`` at once (one rank re-arms instead)."""
    from roko_tpu_torch.parallel.mesh import Mesh
    from roko_tpu_torch.serve.session import SessionBroken

    session = PolishSession(work["model"], device="cpu", ladder=LADDER,
                            mesh=Mesh(dp=1, group=object()))
    seen = []
    session.on_broken(seen.append)
    with pytest.raises(Exception):
        session.predict(work["x"][:3])  # not a process group: the header fails
    assert session.broken and len(seen) == 1 and seen[0] == session.broken
    with pytest.raises(SessionBroken):
        session.predict(work["x"][:3])
    session.stop()  # a broken session sends nothing
