"""The port's model lifecycle (``roko_tpu_torch/serve/registry.py`` and
``rollout.py``), case for case with ``tests/test_rollout.py``: the
registry's entries and refusals, the journal and its recovery decision,
the canary gate, and the REAL rollout machinery — drain/restart one
worker at a time, automatic rollback on a restart storm and on canary
errors, journaled crash recovery (SIGKILL of a stub supervisor
subprocess) — over the port's stub worker (``torch_fleet_stub_worker.py``,
no torch import a worker). Beside them, the reference's own functions on
the same inputs: ``recover_rollout``'s decision, ``_gate_verdict``'s
verdict, ``params_manifest`` and the registry entry's fields. The real
``serve`` fleet runs in ``tests/test_torch_fleet.py``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from roko_tpu_torch.config import FleetConfig, RokoConfig, ServeConfig
from roko_tpu_torch.serve.client import PolishClient
from roko_tpu_torch.serve.fleet import (
    BOOT_VERSION,
    READY,
    Fleet,
    WorkerLaunchSpec,
)
from roko_tpu_torch.serve.registry import (
    RegistryError,
    RegistryMismatch,
    list_models,
    register_model,
    resolve_model,
)
from roko_tpu_torch.serve.rollout import (
    Baseline,
    RolloutController,
    RolloutJournal,
    WorkerStats,
    parse_worker_stats,
    recover_rollout,
)
from roko_tpu_torch.serve.supervisor import make_front_server

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
STUB = os.path.join(TESTS_DIR, "torch_fleet_stub_worker.py")
DRIVER = os.path.join(TESTS_DIR, "torch_rollout_stub_supervisor.py")


def wait_until(pred, timeout=30.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    pytest.fail(f"timed out after {timeout}s waiting for {msg}")


def get_json(port, path):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def post_json(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# -- registry -----------------------------------------------------------------


def fake_bundle(tmp_path, name="bundle", digest="d" * 64, kind="gru"):
    """A directory that satisfies read_manifest (registry units don't
    need real executables, only the identity contract)."""
    bdir = tmp_path / name
    bdir.mkdir()
    manifest = {
        "bundle_version": 1,
        "digest": digest,
        "rungs": [8],
        "files": {},
        "identity": {
            "model": {"kind": kind, "compute_dtype": "float32",
                      "quantize": None},
        },
    }
    (bdir / "manifest.json").write_text(json.dumps(manifest))
    return str(bdir)


def fake_params(tmp_path, name="ckpt", blob=b"weights-v1"):
    pdir = tmp_path / name
    pdir.mkdir()
    (pdir / "params.bin").write_bytes(blob)
    (pdir / "meta.json").write_text("{}")
    return str(pdir)


def test_registry_register_resolve_list(tmp_path):
    reg = str(tmp_path / "registry")
    bundle = fake_bundle(tmp_path)
    params = fake_params(tmp_path)
    entry = register_model(reg, "v1", bundle, params, log=lambda m: None)
    assert entry["bundle_digest"] == "d" * 64
    assert entry["params_manifest"]["files"]["params.bin"]["bytes"] == 10
    got = resolve_model(reg, "v1")
    assert got["name"] == "v1"
    assert got["bundle_dir"] == os.path.abspath(bundle)
    assert got["model"]["kind"] == "gru"
    # bundle-only version (rolls against the incumbent checkpoint)
    register_model(reg, "v2", bundle, None, log=lambda m: None)
    assert resolve_model(reg, "v2")["params_path"] is None
    names = [e["name"] for e in list_models(reg)]
    assert names == ["v1", "v2"]
    # a half-written file is skipped by listing, not fatal
    (tmp_path / "registry" / "torn.json").write_text("{not json")
    assert [e["name"] for e in list_models(reg)] == ["v1", "v2"]


def test_registry_refuses_bundle_and_params_drift(tmp_path):
    reg = str(tmp_path / "registry")
    bundle = fake_bundle(tmp_path)
    params = fake_params(tmp_path)
    register_model(reg, "v1", bundle, params, log=lambda m: None)
    # a file ADDED to the checkpoint dir refuses too: the loader picks
    # steps dynamically, so unregistered bytes could otherwise ship
    extra = os.path.join(params, "step_999.bin")
    with open(extra, "wb") as f:
        f.write(b"sneaky")
    with pytest.raises(RegistryMismatch, match="grew"):
        resolve_model(reg, "v1")
    os.unlink(extra)
    assert resolve_model(reg, "v1")["name"] == "v1"
    # params mutated since registration -> refuse
    with open(os.path.join(params, "params.bin"), "wb") as f:
        f.write(b"weights-v2")
    with pytest.raises(RegistryMismatch, match="sha256 mismatch"):
        resolve_model(reg, "v1")
    # truncation refuses by size before hashing
    with open(os.path.join(params, "params.bin"), "wb") as f:
        f.write(b"w")
    with pytest.raises(RegistryMismatch, match="bytes"):
        resolve_model(reg, "v1")
    os.unlink(os.path.join(params, "params.bin"))
    with pytest.raises(RegistryMismatch, match="missing"):
        resolve_model(reg, "v1")
    # bundle re-exported since registration -> refuse naming both digests
    (tmp_path / "ckpt" / "params.bin").write_bytes(b"weights-v1")
    man_path = os.path.join(bundle, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["digest"] = "e" * 64
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(RegistryMismatch, match="re-exported"):
        resolve_model(reg, "v1")
    # verify=False is the listing path: no disk re-check
    assert resolve_model(reg, "v1", verify=False)["name"] == "v1"


def test_registry_names_and_reregister(tmp_path):
    reg = str(tmp_path / "registry")
    bundle = fake_bundle(tmp_path)
    with pytest.raises(RegistryError, match="bad model version name"):
        register_model(reg, "../evil", bundle, log=lambda m: None)
    with pytest.raises(RegistryError, match="registry is empty"):
        resolve_model(reg, "ghost")
    register_model(reg, "v1", bundle, log=lambda m: None)
    with pytest.raises(RegistryError, match="known: v1"):
        resolve_model(reg, "ghost")
    # idempotent re-register of the SAME identity passes...
    register_model(reg, "v1", bundle, log=lambda m: None)
    # ...a different identity refuses without --force
    other = fake_bundle(tmp_path, name="bundle2", digest="f" * 64)
    with pytest.raises(RegistryError, match="force"):
        register_model(reg, "v1", other, log=lambda m: None)
    register_model(reg, "v1", other, force=True, log=lambda m: None)
    assert resolve_model(reg, "v1")["bundle_digest"] == "f" * 64


def test_cli_compile_register_flags_parse():
    from roko_tpu_torch.cli import build_parser

    args = build_parser().parse_args(
        ["compile", "out/", "--register", "v2", "--params", "ckpt/",
         "--registry", "/tmp/reg", "--force"]
    )
    assert (args.register, args.params, args.force) == ("v2", "ckpt/", True)
    args = build_parser().parse_args(
        ["rollout", "v2", "--bake-s", "5", "--no-wait"]
    )
    assert args.name == "v2" and args.bake_s == 5.0 and args.no_wait


def test_cli_rollout_knobs_layer_into_fleet_config():
    from roko_tpu_torch.cli import _build_config, build_parser

    args = build_parser().parse_args(
        ["serve", "ckpt/", "--workers", "2", "--registry", "/tmp/reg",
         "--bake-s", "7", "--rollback-error-pct", "1.5",
         "--rollback-p99-x", "2.5"]
    )
    cfg = _build_config(args)
    assert cfg.fleet.registry_dir == "/tmp/reg"
    assert cfg.fleet.bake_s == 7.0
    assert cfg.fleet.rollback_error_pct == 1.5
    assert cfg.fleet.rollback_p99_x == 2.5
    assert RokoConfig.from_json(cfg.to_json()).fleet == cfg.fleet


# -- rollout units ------------------------------------------------------------


def test_parse_worker_stats_ignores_size_class_rows():
    text = (
        "roko_serve_requests_total 42\n"
        "roko_serve_errors_total 3\n"
        'roko_serve_request_latency_seconds{quantile="0.5"} 0.01\n'
        'roko_serve_request_latency_seconds{quantile="0.99"} 0.25\n'
        'roko_serve_request_latency_seconds{quantile="0.99",size_class="le8"} 9.0\n'
    )
    stats = parse_worker_stats(text)
    assert (stats.requests, stats.errors, stats.p99_s) == (42, 3, 0.25)


def test_rollout_journal_roundtrip_and_unreadable(tmp_path):
    journal = RolloutJournal(str(tmp_path / "rollout.json"))
    assert journal.load() is None
    journal.write({"state": "rolling", "done": [0], "workers": 2})
    rec = journal.load()
    assert rec["state"] == "rolling" and rec["format"] == 1
    journal.delete()
    assert journal.load() is None
    journal.delete()  # idempotent
    # unreadable journal: loud line, treated as absent (safe revert)
    with open(journal.path, "w") as f:
        f.write("{torn")
    logs = []
    assert journal.load(logs.append) is None
    assert any("journal_unreadable" in m for m in logs)


def test_recover_rollout_decision(tmp_path):
    journal = RolloutJournal(str(tmp_path / "rollout.json"))
    logs = []
    assert recover_rollout(journal, logs.append) is None

    def rec(state, done, workers=2):
        return {
            "state": state, "done": done, "workers": workers,
            "from": {"version": "v1", "model_path": "m1",
                     "bundle_dir": "b1"},
            "to": {"version": "v2", "model_path": "m2",
                   "bundle_dir": "b2"},
        }

    # mid-roll -> revert to the journaled incumbent
    journal.write(rec("rolling", [0]))
    out = recover_rollout(journal, logs.append)
    assert out["action"] == "revert"
    # mid-rollback -> revert too
    journal.write(rec("rolling_back", [0, 1]))
    assert recover_rollout(journal, logs.append)["action"] == "revert"
    # every worker rolled, only the completion mark lost -> finalize
    journal.write(rec("rolling", [0, 1]))
    assert recover_rollout(journal, logs.append)["action"] == "finalize"
    assert any("ROKO_ROLLOUT event=recovered" in m for m in logs)


# -- stub fleet helpers -------------------------------------------------------


def stub_spec(version, extra_env=None):
    env = {"STUB_VERSION": version}
    env.update(extra_env or {})
    return WorkerLaunchSpec(
        lambda wid, announce: [sys.executable, STUB, "--announce", announce],
        env=lambda wid: dict(env),
        version=version,
        meta={"model_path": f"ckpt-{version}",
              "bundle_dir": f"bundle-{version}"},
    )


def make_versioned_fleet(tmp_path, workers=2, v2_env=None, logs=None,
                         **fleet_kw):
    base = dict(
        workers=workers,
        heartbeat_interval_s=0.1,
        heartbeat_timeout_s=2.0,
        heartbeat_misses=3,
        spawn_deadline_s=20.0,
        term_grace_s=2.0,
        restart_base_delay_s=0.05,
        restart_max_delay_s=0.2,
        storm_threshold=2,
        storm_reset_s=3600.0,
        stable_after_s=0.2,
        bake_s=0.3,
        rollout_ready_timeout_s=15.0,
    )
    base.update(fleet_kw)
    cfg = RokoConfig(
        serve=ServeConfig(max_queue=8, retry_after_s=0.2),
        fleet=FleetConfig(**base),
    )
    sink = logs if logs is not None else []
    fleet = Fleet(
        cfg,
        lambda *_: [],
        runtime_dir=str(tmp_path / "fleet"),
        log=sink.append,
    )
    fleet.install_boot_spec(stub_spec("v1"))
    fleet.add_launch_spec(stub_spec("v2", v2_env))
    return fleet


def make_controller(fleet, tmp_path, **kw):
    journal = RolloutJournal(str(tmp_path / "rollout.json"))
    logs = kw.pop("logs", [])
    ctl = RolloutController(
        fleet, "v2", journal=journal, log=logs.append, **kw
    )
    fleet.rollout = ctl
    return ctl, journal, logs


def test_launch_spec_cannot_swap_under_live_workers(tmp_path):
    fleet = make_versioned_fleet(tmp_path)
    # v1 is the boot version every worker targets: swapping it refuses
    with pytest.raises(ValueError, match="live on the fleet"):
        fleet.add_launch_spec(stub_spec("v1"))
    # an unreferenced version may be replaced freely
    fleet.add_launch_spec(stub_spec("v2", {"STUB_P99_S": "0.5"}))
    # rolling to a version with no spec refuses
    with pytest.raises(ValueError, match="no launch spec"):
        fleet.roll_worker(fleet.workers[0], "ghost")


def test_gate_verdict_math(tmp_path):
    fleet = make_versioned_fleet(tmp_path)
    ctl, _, logs = make_controller(
        fleet, tmp_path, rollback_error_pct=2.0, rollback_p99_x=3.0
    )
    ctl.baseline = Baseline(error_pct=0.5, p99_s=0.1, requests=200)
    w = fleet.workers[0]

    def verdict(start, end):
        return ctl._gate_verdict(w, start, end)

    # healthy canary passes
    ok = verdict(WorkerStats(0, 0, None), WorkerStats(100, 1, 0.12))
    assert ok is None
    # error rate past the threshold (and the baseline) rolls back
    why = verdict(WorkerStats(0, 0, None), WorkerStats(100, 10, 0.1))
    assert "error rate 10.00%" in why
    # error rate above threshold but BELOW a noisy baseline passes
    ctl.baseline = Baseline(error_pct=15.0, p99_s=0.1, requests=200)
    assert verdict(WorkerStats(0, 0, None), WorkerStats(100, 10, 0.1)) is None
    ctl.baseline = Baseline(error_pct=0.0, p99_s=0.1, requests=200)
    # p99 regression rolls back
    why = verdict(WorkerStats(0, 0, None), WorkerStats(100, 0, 0.5))
    assert "p99" in why and "3" in why
    # no traffic during the bake: health gate only
    assert verdict(WorkerStats(5, 0, None), WorkerStats(5, 0, None)) is None
    # unscrapeable metrics on a READY worker: pass, loudly
    assert verdict(None, WorkerStats(5, 0, None)) is None
    assert any("metrics_unscrapeable" in m for m in logs)
    # no baseline p99 -> p99 gate cannot fire
    ctl.baseline = Baseline(error_pct=0.0, p99_s=None, requests=0)
    assert verdict(WorkerStats(0, 0, None), WorkerStats(10, 0, 9.9)) is None


# -- stub fleet end-to-end ----------------------------------------------------


def drain_fleet(fleet):
    fleet.stop(rolling=False)


def test_rollout_one_worker_at_a_time_zero_downtime(tmp_path):
    """The tentpole happy path: both workers move v1 -> v2 one at a
    time under continuous client load — zero client-visible errors,
    never fewer than N-1 ready workers, journal gone at the end, and
    the per-worker version metric flips."""
    fleet = make_versioned_fleet(tmp_path)
    fleet.start()
    server = thread = None
    stop_load = threading.Event()
    errors, replies, min_ready = [], [], [2]
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        server = make_front_server(fleet, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        client = PolishClient(f"http://127.0.0.1:{port}")

        def load():
            while not stop_load.is_set():
                try:
                    replies.append(
                        client.polish(
                            "ACGT",
                            np.zeros((1, 2, 2), np.int64),
                            np.zeros((1, 2, 3), np.uint8),
                            retries=4,
                        )
                    )
                except Exception as e:
                    errors.append(repr(e))
                min_ready[0] = min(min_ready[0], fleet.ready_count())
                time.sleep(0.01)

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        time.sleep(0.2)  # some v1 traffic first
        ctl, journal, logs = make_controller(fleet, tmp_path)
        ctl.start()
        ctl.join(60.0)
        stop_load.set()
        loader.join(10.0)
        assert ctl.state == "done"
        assert errors == []
        assert min_ready[0] >= 1  # N-1 ready throughout
        assert sorted(ctl.done) == [0, 1]
        assert fleet.active_version == "v2"
        assert all(w.version == "v2" for w in fleet.workers)
        assert journal.load() is None  # consumed on completion
        # the landed version is durably pinned beside the journal, so a
        # plain supervisor restart cannot silently revert to v1
        pinned = ctl.current.load()
        assert pinned["version"] == "v2"
        assert pinned["model_path"] == "ckpt-v2"
        # traffic moved versions: v1 replies first, v2 replies last
        versions = [r.get("version") for r in replies]
        assert versions[0] == "v1" and versions[-1] == "v2"
        text = fleet.render_metrics()
        assert 'roko_fleet_model_version{worker="0",version="v2"} 1' in text
        assert 'roko_fleet_model_version{worker="1",version="v2"} 1' in text
        assert "roko_rollout_state 0" in text
        assert any("ROKO_ROLLOUT event=done" in m for m in logs)
        # a crashed worker AFTER the rollout restarts on v2, not v1
        w0 = fleet.workers[0]
        w0.proc.kill()
        wait_until(
            lambda: w0.state == READY and w0.alive(), msg="w0 restarted"
        )
        assert w0.version == "v2"
        # and the status surface reports done
        code, status = get_json(port, "/rollout")
        assert code == 200 and status["state"] == "done"
    finally:
        stop_load.set()
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(5.0)
        drain_fleet(fleet)


def test_rollout_restart_storm_rolls_back(tmp_path):
    """A version whose workers die at start trips the per-version
    restart storm: the rollout halts and every touched worker returns
    to the incumbent — loudly."""
    fleet = make_versioned_fleet(
        tmp_path, v2_env={"STUB_FAIL_START": "1"}
    )
    fleet.start()
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        ctl, journal, logs = make_controller(fleet, tmp_path)
        ctl.start()
        ctl.join(60.0)
        assert ctl.state == "rolled_back"
        assert "restart storm" in ctl.reason
        wait_until(lambda: fleet.ready_count() == 2, msg="fleet recovered")
        assert all(w.version == "v1" for w in fleet.workers)
        assert fleet.active_version == "v1"
        assert journal.load() is None
        # the pointer tracks what the fleet actually runs after the
        # rollback (v1 here is a named version, not the CLI incumbent)
        assert ctl.current.load()["version"] == "v1"
        assert any("ROKO_ROLLOUT event=rollback" in m for m in logs)
        assert any("ROKO_ROLLOUT event=rolled_back" in m for m in logs)
        assert fleet.render_metrics().count("roko_rollout_state 0") == 1
    finally:
        drain_fleet(fleet)


def test_rollout_canary_error_gate_rolls_back(tmp_path):
    """The metrics half of the gate: the new version comes up healthy
    but serves errors under live load — the bake-window error rate
    crosses rollback_error_pct and the fleet auto-rolls back."""
    fleet = make_versioned_fleet(
        tmp_path,
        v2_env={"STUB_ERROR_EVERY": "2"},  # every 2nd polish is a 500
        bake_s=0.8,
    )
    fleet.start()
    server = thread = None
    stop_load = threading.Event()
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        server = make_front_server(fleet, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        client = PolishClient(f"http://127.0.0.1:{port}")

        def load():
            while not stop_load.is_set():
                try:
                    client.polish(
                        "ACGT",
                        np.zeros((1, 2, 2), np.int64),
                        np.zeros((1, 2, 3), np.uint8),
                        retries=0,
                    )
                except Exception:
                    pass  # 500s ARE the point here
                time.sleep(0.005)

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        ctl, journal, logs = make_controller(
            fleet, tmp_path, rollback_error_pct=5.0
        )
        ctl.start()
        ctl.join(60.0)
        stop_load.set()
        loader.join(5.0)
        assert ctl.state == "rolled_back"
        assert "error rate" in ctl.reason
        wait_until(lambda: fleet.ready_count() == 2, msg="fleet recovered")
        assert all(w.version == "v1" for w in fleet.workers)
        assert journal.load() is None
    finally:
        stop_load.set()
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(5.0)
        drain_fleet(fleet)


def test_front_rollout_routes(tmp_path):
    """HTTP surface: GET /rollout is idle with no controller; POST
    answers 501 on a bare front end (no starter wired) and relays the
    starter's code/body when one is."""
    fleet = make_versioned_fleet(tmp_path, workers=1)
    server = make_front_server(fleet, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        code, body = get_json(port, "/rollout")
        assert code == 200 and body == {"state": "idle"}
        code, body = post_json(port, "/rollout", {"name": "v2"})
        assert code == 501
        calls = []
        server._start_rollout = lambda p: (calls.append(p) or (202, {"ok": 1}))
        code, body = post_json(port, "/rollout", {"name": "v2", "bake_s": 1})
        assert code == 202 and body == {"ok": 1}
        assert calls == [{"name": "v2", "bake_s": 1}]
        code, _ = post_json(port, "/rollout", ["not", "an", "object"])
        assert code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(5.0)


def test_dynamic_retry_after_uses_live_worker_hint(tmp_path):
    """Satellite: fleet 503s carry the max LIVE worker Retry-After
    (reported via worker healthz) and fall back to the static config
    value only when no worker is up."""
    fleet = make_versioned_fleet(tmp_path, workers=2)
    # one worker hints high, the other low: the max wins
    fleet.install_boot_spec(WorkerLaunchSpec(
        lambda wid, announce: [sys.executable, STUB, "--announce", announce],
        env=lambda wid: {
            "STUB_VERSION": "v1",
            "STUB_RETRY_AFTER_S": "7.3" if wid == 0 else "2.0",
        },
        version="v1",
    ))
    fleet.start()
    server = thread = None
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        wait_until(
            lambda: all(w.retry_hint is not None for w in fleet.workers),
            msg="hints cached from healthz",
        )
        assert fleet.live_retry_after_s() == 7.3
        server = make_front_server(fleet, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        # draining 503 at the front door carries the live hint
        server._draining.set()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/polish", data=b"{}",
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 503
        assert exc.value.headers["Retry-After"] == "7"
        assert json.loads(exc.value.read())["retry_after_s"] == 7.3
        server._draining.clear()
        # no live workers -> static fallback
        for w in fleet.workers:
            w.proc.kill()
        wait_until(
            lambda: all(not w.alive() for w in fleet.workers),
            msg="workers dead",
        )
        assert fleet.live_retry_after_s() == fleet.cfg.serve.retry_after_s
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(5.0)
        drain_fleet(fleet)


# -- supervisor SIGKILL fault injection (stub driver) -------------------------


def start_driver(tmp_path, runtime_dir, *extra):
    announce = str(
        tmp_path / f"front-{len(os.listdir(str(tmp_path)))}.announce.json"
    )
    proc = subprocess.Popen(
        [sys.executable, DRIVER, "--runtime-dir", runtime_dir,
         "--announce", announce, *extra],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    wait_until(
        lambda: os.path.exists(announce) or proc.poll() is not None,
        timeout=30.0, msg="driver announce",
    )
    assert proc.poll() is None, proc.communicate()[0][-2000:]
    with open(announce) as f:
        port = json.load(f)["port"]
    return proc, port


def kill_stub_workers(runtime_dir):
    """SIGKILL the (orphaned) stub workers a killed supervisor leaves
    behind, via the pids in their announce files."""
    try:
        names = os.listdir(runtime_dir)
    except OSError:
        return
    for name in names:
        if not name.endswith(".announce.json"):
            continue
        try:
            with open(os.path.join(runtime_dir, name)) as f:
                os.kill(int(json.load(f)["pid"]), signal.SIGKILL)
        except (OSError, ValueError, KeyError):
            pass


def test_supervisor_sigkill_mid_rollout_reverts(tmp_path):
    """Satellite fault injection: SIGKILL the supervisor while the
    rollout is half done (worker 0 on v2, worker 1 mid-bake). The
    restarted supervisor must detect the journal, announce the
    interrupted rollout loudly, and boot EVERY worker on the journaled
    incumbent — never a silently mixed fleet."""
    runtime_dir = str(tmp_path / "fleet")
    proc, port = start_driver(tmp_path, runtime_dir, "--bake-s", "3.0")
    try:
        wait_until(
            lambda: get_json(port, "/healthz")[1].get("workers_up") == 2,
            msg="stub fleet up",
        )
        code, _ = post_json(port, "/rollout", {"name": "v2"})
        assert code == 202
        wait_until(
            lambda: get_json(port, "/rollout")[1].get("workers_done") == [0],
            timeout=30.0, msg="worker 0 rolled, worker 1 pending",
        )
        proc.kill()  # SIGKILL: no drain, no journal cleanup
        proc.communicate(timeout=30.0)
        kill_stub_workers(runtime_dir)
        journal = RolloutJournal(
            os.path.join(runtime_dir, RolloutJournal.FILENAME)
        )
        rec = journal.load()
        assert rec is not None and rec["state"] == "rolling"
        assert rec["done"] == [0]

        proc2, port2 = start_driver(tmp_path, runtime_dir)
        try:
            wait_until(
                lambda: get_json(port2, "/healthz")[1].get("workers_up") == 2,
                msg="recovered fleet up",
            )
            code, health = get_json(port2, "/healthz")
            assert health["version"] == "v1"  # reverted, not mixed
            assert all(
                wrk["version"] == "v1"
                for wrk in health["workers"].values()
            )
            assert journal.load() is None  # consumed by recovery
            code, status = get_json(port2, "/rollout")
            assert status == {"state": "idle"}
            proc2.send_signal(signal.SIGTERM)
            out2, _ = proc2.communicate(timeout=30.0)
            assert proc2.returncode == 0
            assert "ROKO_ROLLOUT event=recovered" in out2
            assert "action=revert" in out2
        finally:
            if proc2.poll() is None:
                proc2.kill()
                proc2.communicate(timeout=10.0)
                kill_stub_workers(runtime_dir)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10.0)
            kill_stub_workers(runtime_dir)


def test_supervisor_recovery_finalizes_when_all_done(tmp_path):
    """The resume half: a journal that shows EVERY worker already on
    the new version (only the completion mark was lost) finalizes
    forward instead of reverting."""
    runtime_dir = str(tmp_path / "fleet")
    os.makedirs(runtime_dir)
    journal = RolloutJournal(
        os.path.join(runtime_dir, RolloutJournal.FILENAME)
    )
    journal.write({
        "state": "rolling",
        "done": [0, 1],
        "workers": 2,
        "from": {"version": "v1", "model_path": "ckpt-v1",
                 "bundle_dir": "bundle-v1"},
        "to": {"version": "v2", "model_path": "ckpt-v2",
               "bundle_dir": "bundle-v2"},
        "started_unix": 0,
    })
    proc, port = start_driver(tmp_path, runtime_dir)
    try:
        wait_until(
            lambda: get_json(port, "/healthz")[1].get("workers_up") == 2,
            msg="finalized fleet up",
        )
        _, health = get_json(port, "/healthz")
        assert health["version"] == "v2"
        assert all(
            wrk["version"] == "v2" for wrk in health["workers"].values()
        )
        assert journal.load() is None
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30.0)
        assert proc.returncode == 0
        assert "action=finalize" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10.0)
            kill_stub_workers(runtime_dir)


# -- the reference's functions on the same inputs ------------------------------


def _both_journals(tmp_path, rec):
    from roko_tpu.serve.rollout import RolloutJournal as RefJournal

    port = RolloutJournal(str(tmp_path / "port.json"))
    ref = RefJournal(str(tmp_path / "ref.json"))
    for j in (port, ref):
        if rec is None:
            j.delete()
        elif isinstance(rec, str):
            with open(j.path, "w") as f:
                f.write(rec)
        else:
            j.write(rec)
    return port, ref


@pytest.mark.parametrize("rec", [
    None,
    {"state": "rolling", "done": [0], "workers": 2},
    {"state": "rolling", "done": [0, 1], "workers": 2},
    {"state": "rolling", "done": [1, 0, 1], "workers": 2},
    {"state": "rolling_back", "done": [0, 1], "workers": 2},
    {"state": "rolling", "done": [], "workers": 0},
    {"state": "failed", "done": [0, 1, 2], "workers": 3},
    {"state": "rolling", "done": [0, 1, 2], "workers": 3, "from": None},
    "{torn",
])
def test_recover_rollout_equals_reference(tmp_path, rec):
    from roko_tpu.serve.rollout import recover_rollout as ref_recover

    if isinstance(rec, dict):
        rec = dict({"from": {"version": "v1", "model_path": "m1", "bundle_dir": "b1"},
                    "to": {"version": "v2", "model_path": "m2", "bundle_dir": "b2"}}, **rec)
    port, ref = _both_journals(tmp_path, rec)
    port_logs, ref_logs = [], []
    got = recover_rollout(port, port_logs.append)
    want = ref_recover(ref, ref_logs.append)
    assert (got is None) == (want is None)
    if got is not None:
        assert got == want
    assert [m.replace(port.path, "P") for m in port_logs] == \
        [m.replace(ref.path, "P") for m in ref_logs]


@pytest.mark.parametrize("baseline,start,end", [
    ((0.5, 0.1, 200), (0, 0, None), (100, 1, 0.12)),
    ((0.5, 0.1, 200), (0, 0, None), (100, 10, 0.1)),
    ((15.0, 0.1, 200), (0, 0, None), (100, 10, 0.1)),
    ((0.0, 0.1, 200), (0, 0, None), (100, 0, 0.5)),
    ((0.0, 0.1, 200), (5, 0, None), (5, 0, None)),
    ((0.0, 0.1, 200), None, (5, 0, None)),
    ((0.0, None, 0), (0, 0, None), (10, 0, 9.9)),
    ((1.0, 0.2, 50), (40, 3, 0.1), (30, 2, 0.7)),
    ((0.0, 0.05, 10), (0, 0, None), (3, 1, 0.2)),
])
def test_gate_verdict_equals_reference(tmp_path, baseline, start, end):
    from roko_tpu.config import FleetConfig as JFleet
    from roko_tpu.config import RokoConfig as JRoko
    from roko_tpu.serve.fleet import Fleet as RefFleet
    from roko_tpu.serve.fleet import WorkerLaunchSpec as RefSpec
    from roko_tpu.serve.rollout import Baseline as RefBaseline
    from roko_tpu.serve.rollout import RolloutController as RefController
    from roko_tpu.serve.rollout import RolloutJournal as RefJournal
    from roko_tpu.serve.rollout import WorkerStats as RefStats

    fleet = make_versioned_fleet(tmp_path)
    ctl, _, logs = make_controller(fleet, tmp_path, rollback_error_pct=2.0, rollback_p99_x=3.0)
    ref_fleet = RefFleet(JRoko(fleet=JFleet(workers=2)), lambda *_: [],
                         runtime_dir=str(tmp_path / "ref"), log=lambda m: None)
    ref_fleet.add_launch_spec(RefSpec(lambda *_: [], version="v2"))
    ref_logs = []
    ref_ctl = RefController(ref_fleet, "v2", journal=RefJournal(str(tmp_path / "r.json")),
                            log=ref_logs.append, rollback_error_pct=2.0, rollback_p99_x=3.0)
    ctl.baseline = Baseline(*baseline)
    ref_ctl.baseline = RefBaseline(*baseline)

    def stats(cls, v):
        return None if v is None else cls(*v)

    got = ctl._gate_verdict(fleet.workers[0], stats(WorkerStats, start), stats(WorkerStats, end))
    want = ref_ctl._gate_verdict(ref_fleet.workers[0], stats(RefStats, start),
                                 stats(RefStats, end))
    assert got == want
    assert logs == ref_logs


def test_registry_entries_and_manifests_equal_reference(tmp_path):
    """``params_manifest`` over the same files, and the entry written for
    the same bundle and params, equal the reference's field for field."""
    from roko_tpu.serve import registry as ref_registry

    bundle = fake_bundle(tmp_path)
    params = fake_params(tmp_path)
    pth = tmp_path / "model.pth"
    pth.write_bytes(b"state dict bytes")
    for p in (params, str(pth)):
        from roko_tpu_torch.serve.registry import params_manifest

        assert params_manifest(p) == ref_registry.params_manifest(p)
    got = register_model(str(tmp_path / "port"), "v1", bundle, str(pth), log=lambda m: None)
    want = ref_registry.register_model(str(tmp_path / "ref"), "v1", bundle, str(pth),
                                       log=lambda m: None)
    for entry in (got, want):
        entry.pop("registered_unix")
    assert got == want
    for bad in ("../evil", "", "-x"):
        for fn in (register_model, ref_registry.register_model):
            with pytest.raises(RegistryError if fn is register_model
                               else ref_registry.RegistryError, match="bad model version"):
                fn(str(tmp_path / "r"), bad, bundle, log=lambda m: None)


def test_registry_dir_layering(tmp_path, monkeypatch):
    from roko_tpu_torch.serve import registry

    monkeypatch.delenv("ROKO_REGISTRY", raising=False)
    assert registry.resolve_registry_dir(None).endswith(
        os.path.join("build", "roko_tpu_torch_registry"))
    assert registry.resolve_registry_dir("/r") == "/r"
    monkeypatch.setenv("ROKO_REGISTRY", str(tmp_path))
    assert registry.resolve_registry_dir("/r") == str(tmp_path)
