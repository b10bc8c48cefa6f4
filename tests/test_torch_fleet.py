"""The port's serving fleet (``roko_tpu_torch/serve/fleet.py`` and
``supervisor.py``), case for case with ``tests/test_fleet.py`` and
``tests/test_autoscale.py``: the REAL supervision machinery — subprocess
spawn, waitpid, SIGTERM/SIGKILL escalation, restart backoff, storm
breaker, failover routing, rolling drain, admission control, metrics
aggregation, elastic resizing — over the port's stub worker
(``tests/torch_fleet_stub_worker.py``, ~100 ms a spawn), the card-slice
overlay and topology (``CUDA_VISIBLE_DEVICES``), the CLI's fleet flags,
the ``Autoscaler``'s decisions against the reference's on the same fake
clock and load trace, and one real 2-worker fleet of ``python -m
roko_tpu_torch serve --device cpu`` whose ``/polish`` reply is
byte-identical to the port's ``run_inference`` and to ``roko-tpu serve``
on the same converted weights."""

import dataclasses
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from roko_tpu_torch.config import FleetConfig, RokoConfig, ServeConfig
from roko_tpu_torch.parallel.mesh import (
    fleet_worker_env,
    fleet_worker_slice,
    resolve_fleet_topology,
)
from roko_tpu_torch.serve.client import PolishClient, ServerBusy, ServiceUnavailable
from roko_tpu_torch.serve.fleet import (
    DEAD,
    FAILED,
    READY,
    STOPPED,
    WARMING,
    Fleet,
)
from roko_tpu_torch.serve.metrics import parse_metric_values
from roko_tpu_torch.serve.supervisor import Autoscaler, make_front_server, rolling_drain

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_fleet_stub_worker.py")


def stub_command(worker_id, announce_path):
    return [sys.executable, STUB, "--announce", announce_path]


def fast_fleet_cfg(workers=2, **kw):
    """Supervision knobs scaled to test time (ms heartbeats, sub-second
    backoff) — same machinery, faster clock."""
    base = dict(
        workers=workers,
        heartbeat_interval_s=0.1,
        heartbeat_timeout_s=2.0,
        heartbeat_misses=3,
        spawn_deadline_s=20.0,
        term_grace_s=2.0,
        restart_base_delay_s=0.05,
        restart_max_delay_s=0.2,
        storm_threshold=3,
        storm_reset_s=3600.0,
        stable_after_s=0.3,
    )
    base.update(kw)
    return FleetConfig(**base)


def make_fleet(tmp_path, workers=2, env_for=None, **fleet_kw):
    cfg = RokoConfig(
        serve=ServeConfig(max_queue=8, retry_after_s=0.2),
        fleet=fast_fleet_cfg(workers, **fleet_kw),
    )
    return Fleet(
        cfg,
        stub_command,
        worker_env=env_for or (lambda wid: {}),
        runtime_dir=str(tmp_path / "fleet"),
        log=lambda m: None,
    )


def wait_until(pred, timeout=30.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    pytest.fail(f"timed out after {timeout}s waiting for {msg}")


def start_front(fleet):
    server = make_front_server(fleet, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop_front(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(5.0)


def get_json(port, path):
    """GET that treats HTTP error codes as answers (PolishClient maps
    503 to ServerBusy, which healthz asserts here must see raw)."""
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def post(client, retries=4, **kw):
    return client.polish(
        "ACGT",
        np.zeros((1, 2, 2), np.int64),
        np.zeros((1, 2, 3), np.uint8),
        retries=retries,
        **kw,
    )


# -- pure units ---------------------------------------------------------------


def test_restart_backoff_schedule(tmp_path):
    """The restart delays follow the shared RetryPolicy shape:
    base * 2^(k-1) capped at the max (jitter rides on top)."""
    fleet = make_fleet(tmp_path)
    exact = dataclasses.replace(fleet.restart_policy, jitter=0.0)
    assert [exact.delay_for(k) for k in range(1, 5)] == [0.05, 0.1, 0.2, 0.2]
    # default production schedule: 0.5 doubling to the 30 s cap
    prod = dataclasses.replace(
        Fleet(
            RokoConfig(fleet=FleetConfig(workers=1)),
            stub_command,
            runtime_dir=str(tmp_path / "prod"),
            log=lambda m: None,
        ).restart_policy,
        jitter=0.0,
    )
    assert [prod.delay_for(k) for k in range(1, 9)] == [
        0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 30.0,
    ]
    # jittered delays stay within +10%
    noisy = fleet.restart_policy.delay_for(2)
    assert 0.1 <= noisy <= 0.1 * 1.1 + 1e-9


def test_note_death_schedules_backoff(tmp_path):
    fleet = make_fleet(tmp_path)
    w = fleet.workers[0]
    fleet._note_death(w, 100.0, "test")
    assert w.state == DEAD
    assert w.attempt == 1
    assert w.restart_at >= 100.0 + 0.05
    fleet._note_death(w, 200.0, "test")
    assert w.attempt == 2
    assert w.restart_at >= 200.0 + 0.1


def test_fleet_worker_slice_and_env(monkeypatch):
    assert fleet_worker_slice(0, 4, 2) == [0, 1]
    assert fleet_worker_slice(3, 4, 2) == [6, 7]
    with pytest.raises(ValueError, match="outside fleet"):
        fleet_worker_slice(4, 4, 2)
    with pytest.raises(ValueError, match="devices_per_worker"):
        fleet_worker_slice(0, 4, 0)
    assert fleet_worker_env(1, 2, 2) == {"CUDA_VISIBLE_DEVICES": "2,3"}
    assert fleet_worker_env(0, 2, 4, backend="cuda") == {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}
    # the same slices as the reference's GPU overlay
    from roko_tpu.parallel.mesh import fleet_worker_env as ref_env

    for wid, n, k in ((0, 2, 1), (1, 2, 1), (2, 4, 2), (1, 3, 0)):
        assert fleet_worker_env(wid, n, k) == ref_env(wid, n, k, backend="gpu")
    # shared cards and the CPU: empty overlay, workers see everything
    assert fleet_worker_env(0, 2, 0) == {}
    assert fleet_worker_env(1, 2, 4, backend="cpu") == {}


def test_resolve_fleet_topology(monkeypatch):
    """``--workers auto`` is one worker a visible card (or a slice of
    them); an explicit count x slice above the visible cards is refused
    before anything spawns; shared cards and the CPU never are."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    assert resolve_fleet_topology(FleetConfig(workers=-1)) == \
        FleetConfig(workers=4, devices_per_worker=1)
    assert resolve_fleet_topology(FleetConfig(workers=-1, devices_per_worker=2)).workers == 2
    with pytest.raises(ValueError, match="oversubscribes"):
        resolve_fleet_topology(FleetConfig(workers=3, devices_per_worker=2))
    same = FleetConfig(workers=3, devices_per_worker=0)
    assert resolve_fleet_topology(same) is same
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(ValueError, match="cannot host even one worker"):
        resolve_fleet_topology(FleetConfig(workers=-1))
    assert resolve_fleet_topology(FleetConfig(workers=-1), backend="cpu").workers == 1
    assert resolve_fleet_topology(FleetConfig(workers=5, devices_per_worker=2),
                                  backend="cpu").workers == 5


def test_cli_workers_flag_layers_into_config():
    from roko_tpu_torch.cli import _build_config, build_parser

    args = build_parser().parse_args(
        ["serve", "ckpt/", "--workers", "2", "--devices-per-worker", "4",
         "--heartbeat-interval", "0.5"]
    )
    cfg = _build_config(args)
    assert cfg.fleet.workers == 2
    assert cfg.fleet.devices_per_worker == 4
    assert cfg.fleet.heartbeat_interval_s == 0.5
    # defaults: no fleet
    default = _build_config(build_parser().parse_args(["serve", "ckpt/"]))
    assert default.fleet.workers == 0
    # fleet section survives the config JSON round trip
    assert RokoConfig.from_json(cfg.to_json()).fleet == cfg.fleet


def test_parse_metric_values():
    text = (
        "# TYPE a counter\na 3\nb 4.5\n"
        'labeled{x="1"} 9\nmalformed line here\n'
    )
    assert parse_metric_values(text, ("a", "b", "labeled")) == {
        "a": "3", "b": "4.5",
    }


def test_client_retry_exhaustion_is_typed():
    """Exhausting the retry budget against 503s raises the typed
    ServiceUnavailable (a ServerBusy subclass, so existing handlers
    keep working) carrying the attempt count."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Busy(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body = json.dumps({"error": "busy", "retry_after_s": 2.5}).encode()
            self.send_response(503)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Busy)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        client = PolishClient(f"http://127.0.0.1:{srv.server_address[1]}")
        client._sleep = lambda s: None
        with pytest.raises(ServiceUnavailable) as exc:
            post(client, retries=2)
        assert exc.value.attempts == 3
        assert exc.value.retry_after_s == 2.5
        assert isinstance(exc.value, ServerBusy)
        assert "3 attempt(s)" in str(exc.value)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(5.0)


# -- supervision with real (stub) processes ----------------------------------


def test_fleet_routes_and_aggregates(tmp_path):
    """Happy path: two workers spawn, announce, enter rotation; the
    front end routes /polish, aggregates /healthz, and re-exports
    per-worker gauges labeled by worker id."""
    fleet = make_fleet(tmp_path, workers=2)
    fleet.start()
    server = thread = None
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        server, thread = start_front(fleet)
        port = server.server_address[1]
        code, health = get_json(port, "/healthz")
        assert code == 200
        assert health["status"] == "ok"
        assert health["workers_up"] == 2
        assert health["workers"]["0"]["state"] == READY
        client = PolishClient(f"http://127.0.0.1:{port}")
        reply = post(client)
        assert reply["polished"].startswith("STUB-")
        assert reply["windows"] == 1
        text = client.metrics()
        assert "roko_fleet_workers 2" in text
        assert "roko_fleet_workers_up 2" in text
        assert "roko_fleet_requests_total 1" in text
        assert "roko_fleet_restarts_total 0" in text
        # per-worker passthrough, labeled by worker id
        assert 'roko_serve_breaker_state{worker="0"} 0' in text
        assert 'roko_serve_breaker_trips_total{worker="1"} 1' in text
        assert 'roko_compile_cache_hits{worker="0"} 5' in text
        assert 'roko_fleet_worker_state{worker="1"} 0' in text
    finally:
        if server is not None:
            stop_front(server, thread)
        fleet.stop(rolling=False)
    assert all(w.state == STOPPED for w in fleet.workers)
    assert all(not w.alive() for w in fleet.workers)


def test_fleet_restarts_crashed_worker(tmp_path):
    """SIGKILL a worker: waitpid notices, the restart lands after
    backoff, the replacement announces a fresh port and rejoins."""
    fleet = make_fleet(tmp_path, workers=2)
    fleet.start()
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        w0 = fleet.workers[0]
        pid0 = w0.proc.pid
        w0.proc.kill()
        wait_until(
            lambda: fleet.counter("restarts") >= 1, msg="restart counted"
        )
        wait_until(lambda: fleet.ready_count() == 2, msg="worker rejoined")
        assert w0.proc.pid != pid0
        assert w0.restarts == 1
        # the replacement eventually counts as stable and the backoff
        # schedule resets
        wait_until(lambda: w0.stable, msg="replacement stable")
        assert w0.attempt == 0
    finally:
        fleet.stop(rolling=False)


def test_fleet_failover_worker_death_midrequest(tmp_path):
    """Worker 0 dies mid-request without replying (os._exit inside the
    handler): the front end retries on worker 1 transparently — every
    client call still returns 200 and the failover is counted."""
    fleet = make_fleet(
        tmp_path,
        workers=2,
        env_for=lambda wid: (
            {"STUB_CRASH_ON_POLISH": "1"} if wid == 0 else {}
        ),
    )
    fleet.start()
    server = thread = None
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        server, thread = start_front(fleet)
        client = PolishClient(f"http://127.0.0.1:{server.server_address[1]}")
        for _ in range(4):
            reply = post(client)
            # every reply came from the healthy worker
            assert reply["polished"] == f"STUB-{fleet.workers[1].proc.pid}"
        assert fleet.counter("failovers") >= 1
    finally:
        if server is not None:
            stop_front(server, thread)
        fleet.stop(rolling=False)


def test_fleet_storm_breaker_degrades_not_flaps(tmp_path):
    """A worker that dies at every start trips its restart-storm
    breaker after storm_threshold deaths: it is marked FAILED (no more
    respawn attempts until the breaker's reset) and the fleet reports
    degraded-but-serving on the survivor."""
    fleet = make_fleet(
        tmp_path,
        workers=2,
        env_for=lambda wid: ({"STUB_FAIL_START": "1"} if wid == 1 else {}),
        storm_threshold=2,
        storm_reset_s=3600.0,
    )
    fleet.start()
    try:
        wait_until(lambda: fleet.ready_count() == 1, msg="worker 0 ready")
        w1 = fleet.workers[1]
        wait_until(lambda: w1.state == FAILED, msg="storm breaker opens")
        restarts_then = w1.restarts
        assert restarts_then >= 1  # it did try before giving up
        time.sleep(0.5)  # many would-be backoff periods
        assert w1.restarts == restarts_then  # no flapping
        assert w1.state == FAILED
        summary = fleet.summary()
        assert summary["status"] == "degraded"
        assert summary["code"] == 200
        assert summary["workers_up"] == 1
    finally:
        fleet.stop(rolling=False)


def test_fleet_hung_worker_killed_and_restarted(tmp_path):
    """A worker whose process is alive but stops answering /healthz is
    declared hung after heartbeat_misses unanswered probes, killed
    (SIGTERM->SIGKILL escalation), and restarted."""
    fleet = make_fleet(
        tmp_path,
        workers=1,
        env_for=lambda wid: {"STUB_HANG_AFTER_S": "0.4"},
        heartbeat_timeout_s=0.3,
        heartbeat_misses=2,
        term_grace_s=0.5,
    )
    fleet.start()
    try:
        wait_until(
            lambda: fleet.workers[0].restarts >= 1,
            msg="hung worker killed and restarted",
        )
    finally:
        fleet.stop(rolling=False)


def test_front_sheds_when_no_worker_ready(tmp_path):
    """All workers warming: /healthz says warming (503) and /polish is
    shed with 503 + Retry-After; the typed ServiceUnavailable surfaces
    once the client's retry budget is gone."""
    fleet = make_fleet(
        tmp_path, workers=1, env_for=lambda wid: {"STUB_WARM_S": "60"}
    )
    fleet.start()
    server = thread = None
    try:
        wait_until(
            lambda: fleet.workers[0].state == WARMING, msg="worker warming"
        )
        server, thread = start_front(fleet)
        port = server.server_address[1]
        code, health = get_json(port, "/healthz")
        assert code == 503
        assert health["status"] == "warming"
        client = PolishClient(f"http://127.0.0.1:{port}")
        client._sleep = lambda s: None
        with pytest.raises(ServerBusy):
            post(client, retries=0)
        with pytest.raises(ServiceUnavailable) as exc:
            post(client, retries=1)
        assert exc.value.attempts == 2
    finally:
        if server is not None:
            stop_front(server, thread)
        fleet.stop(rolling=False)


def test_rolling_drain_zero_dropped_inflight(tmp_path):
    """SIGTERM semantics: requests in flight when the drain begins ALL
    complete with 200 (front end finishes its relays before workers are
    touched; workers then drain one at a time); new work is refused."""
    fleet = make_fleet(
        tmp_path,
        workers=2,
        env_for=lambda wid: {"STUB_POLISH_DELAY_S": "0.6"},
    )
    fleet.start()
    server = thread = None
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        server, thread = start_front(fleet)
        port = server.server_address[1]
        client = PolishClient(f"http://127.0.0.1:{port}")
        results = []
        errors = []

        def one():
            try:
                results.append(post(client, retries=0))
            except Exception as e:  # anything non-200 is a drop
                errors.append(repr(e))

        clients = [
            threading.Thread(target=one, daemon=True) for _ in range(4)
        ]
        for t in clients:
            t.start()
        time.sleep(0.25)  # all four are now in flight (0.6 s polish)
        rolling_drain(server, fleet, log=lambda m: None)
        for t in clients:
            t.join(15.0)
        assert errors == []
        assert len(results) == 4
        assert all(r["polished"].startswith("STUB-") for r in results)
        # fleet is gone: workers exited, new connections refused
        assert all(not w.alive() for w in fleet.workers)
        server.server_close()
        with pytest.raises(OSError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=2
            )
    finally:
        fleet.stop(rolling=False)  # idempotent
        if thread is not None:
            thread.join(5.0)


def test_front_admission_control(tmp_path):
    """In-flight relays past the fleet's aggregate capacity are shed at
    the front door with 503 + Retry-After and counted as rejected."""
    fleet = make_fleet(
        tmp_path,
        workers=1,
        env_for=lambda wid: {"STUB_POLISH_DELAY_S": "0.8"},
    )
    fleet.max_inflight = 2  # tiny cap so the third request trips it
    fleet.start()
    server = thread = None
    try:
        wait_until(lambda: fleet.ready_count() == 1, msg="worker ready")
        server, thread = start_front(fleet)
        port = server.server_address[1]
        client = PolishClient(f"http://127.0.0.1:{port}")
        done = []
        hold = [
            threading.Thread(
                target=lambda: done.append(post(client, retries=4)),
                daemon=True,
            )
            for _ in range(2)
        ]
        for t in hold:
            t.start()
        wait_until(
            lambda: server._inflight >= 2, timeout=5.0, msg="relays in flight"
        )
        shed = PolishClient(f"http://127.0.0.1:{port}")
        shed._sleep = lambda s: None
        with pytest.raises(ServerBusy):
            post(shed, retries=0)
        assert fleet.counter("rejected") >= 1
        for t in hold:
            t.join(15.0)
        assert len(done) == 2
    finally:
        if server is not None:
            stop_front(server, thread)
        fleet.stop(rolling=False)


def test_metrics_aggregation_survives_worker_death_mid_scrape(tmp_path):
    """Supervisor /metrics with a worker dying around the scrape: the
    passthrough simply omits the unanswering worker — fleet-level
    series and the surviving worker's labeled rows still render, no
    exception ever escapes to the scraper."""
    fleet = make_fleet(tmp_path, workers=2)
    fleet.start()
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 workers ready")
        # (a) worker killed between heartbeat and scrape: proc dead,
        # state/port still READY-looking to render_metrics
        w0 = fleet.workers[0]
        w0.proc.kill()
        w0.proc.wait(10.0)
        text = fleet.render_metrics()
        assert "roko_fleet_workers 2" in text
        assert 'roko_serve_breaker_state{worker="1"} 0' in text
        assert 'roko_serve_breaker_state{worker="0"}' not in text
        # (b) worker alive but its socket gone (stale port): the scrape
        # gets connection-refused and the worker is omitted, not fatal
        import socket

        w1 = fleet.workers[1]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            stale = s.getsockname()[1]
        real_port = w1.port
        w1.port = stale
        try:
            text = fleet.render_metrics()
            assert "roko_fleet_workers_up" in text
            assert 'roko_serve_breaker_state{worker="1"}' not in text
        finally:
            w1.port = real_port
        # (c) every worker unanswering: fleet series alone, no
        # passthrough TYPE headers for absent series
        w1.proc.kill()
        w1.proc.wait(10.0)
        text = fleet.render_metrics()
        assert "roko_fleet_restarts_total" in text
        assert "roko_serve_breaker_state" not in text
    finally:
        fleet.stop(rolling=False)


# -- elastic sizing (stub workers) -------------------------------------------


def test_scale_to_spawns_and_retires_stub_workers(tmp_path):
    """scale_to with the real supervision machinery on stub workers:
    up spawns fresh workers onto the boot spec, down drain-retires the
    highest ids LIFO, freed ids (= device slices) are reused on the
    next grow so ids stay dense, and the derived admission cap tracks
    the live count."""
    fleet = make_fleet(tmp_path, workers=2)
    fleet.start()
    try:
        wait_until(lambda: fleet.ready_count() == 2, msg="2 stubs ready")
        assert fleet.max_inflight == 2 * 8
        assert fleet.scale_to(3, reason="unit") == 3
        wait_until(lambda: fleet.ready_count() == 3, msg="3rd stub ready")
        assert sorted(w.id for w in fleet.workers) == [0, 1, 2]
        assert fleet.max_inflight == 3 * 8
        assert fleet.counter("scale_ups") == 1
        fleet.scale_to(1, reason="unit")
        assert [w.id for w in fleet.workers] == [0]  # LIFO shrink
        assert fleet.max_inflight == 1 * 8
        wait_until(
            lambda: not fleet._retiring, msg="retired workers drained"
        )
        assert fleet.counter("scale_downs") == 1
        # freed slices are reused: the regrow mints ids 1 and 2 again
        fleet.scale_to(3, reason="unit")
        assert sorted(w.id for w in fleet.workers) == [0, 1, 2]
        wait_until(lambda: fleet.ready_count() == 3, msg="regrow ready")
    finally:
        fleet.stop(rolling=False)


def test_scale_to_refused_while_draining(tmp_path):
    fleet = make_fleet(tmp_path, workers=2)
    fleet._draining = True
    assert fleet.scale_to(3) == 2  # no-op, never grows into a drain
    assert fleet.counter("scale_ups") == 0


def test_scale_to_clamps_at_one(tmp_path):
    fleet = make_fleet(tmp_path, workers=2)
    assert fleet.scale_to(0) == 1  # a fleet never scales to nothing


# -- the autoscaler (the cases of tests/test_autoscale.py) ---------------------


def _quiet(*_a, **_k):
    pass


#: fast, test-friendly elastic band: up at >8 windows/worker, down at
#: <=2 after a 5s continuous idle stretch, 2s cooldown, no smoothing
#: lag (beta=0 -> the EMA IS the instantaneous observation)
FC = FleetConfig(
    workers=2, min_workers=1, max_workers=4,
    autoscale_up_backlog=8.0, autoscale_down_backlog=2.0,
    autoscale_idle_s=5.0, autoscale_cooldown_s=2.0,
    autoscale_ema_beta=0.0,
)


class ScaleFleet:
    """The narrow surface Autoscaler consumes: fleet_cfg, workers,
    backlog_windows(), jobs_parked, scale_to() — the same contract the
    real Fleet honours, recording every resize."""

    def __init__(self, fc=FC, n=None):
        self.fleet_cfg = fc
        self.workers = list(range(fc.workers if n is None else n))
        self.jobs_parked = False
        self.backlog = 0
        self.resizes = []

    def backlog_windows(self):
        return self.backlog

    def scale_to(self, n, reason=""):
        self.resizes.append((len(self.workers), n, reason))
        self.workers = list(range(n))
        return n


def make_scaler(fleet):
    """Autoscaler on a synthetic clock the test advances by hand."""
    clock = [0.0]
    scaler = Autoscaler(fleet, log=_quiet, clock=lambda: clock[0])
    return scaler, clock


# -- autoscaler decisions (tests/test_autoscale.py) ----------------------------


# -- enablement ---------------------------------------------------------------


def test_disabled_without_headroom():
    """min == max (or both unset) leaves no room: the scaler reports
    disabled and never resizes, whatever the backlog does."""
    fixed = dataclasses.replace(FC, min_workers=2, max_workers=2)
    fleet = ScaleFleet(fixed)
    scaler, clock = make_scaler(fleet)
    assert not scaler.enabled
    fleet.backlog = 10_000
    for _ in range(20):
        clock[0] += 10.0
        assert scaler.tick() is None
    assert fleet.resizes == []


def test_bounds_default_from_workers():
    """min_workers 0 with a max set floors at the static worker count
    (a configured fleet never shrinks below what was asked for)."""
    fc = dataclasses.replace(FC, min_workers=0)
    scaler, _ = make_scaler(ScaleFleet(fc))
    assert scaler.min_workers == fc.workers
    assert scaler.max_workers == 4


# -- scale-up -----------------------------------------------------------------


def test_scales_up_fast_on_backlog_spike():
    """One tick over the up threshold is enough: +1 worker immediately,
    no waiting period on the way up."""
    fleet = ScaleFleet()
    scaler, clock = make_scaler(fleet)
    fleet.backlog = 40  # 20 windows/worker > 8
    assert scaler.tick() == "up"
    assert len(fleet.workers) == 3


def test_scale_up_stops_at_max_workers():
    fleet = ScaleFleet()
    scaler, clock = make_scaler(fleet)
    fleet.backlog = 10_000
    for _ in range(10):
        clock[0] += FC.autoscale_cooldown_s
        scaler.tick()
    assert len(fleet.workers) == 4
    assert all(new <= 4 for _, new, _ in fleet.resizes)


def test_cooldown_paces_consecutive_steps():
    """Two up decisions inside one cooldown window collapse to one —
    the second tick holds even though the threshold is still crossed."""
    fleet = ScaleFleet()
    scaler, clock = make_scaler(fleet)
    fleet.backlog = 10_000
    assert scaler.tick() == "up"
    clock[0] += FC.autoscale_cooldown_s / 2
    assert scaler.tick() is None  # still cooling
    clock[0] += FC.autoscale_cooldown_s
    assert scaler.tick() == "up"


# -- scale-down ---------------------------------------------------------------


def _grow_to(fleet, scaler, clock, n):
    fleet.backlog = 10_000
    while len(fleet.workers) < n:
        clock[0] += FC.autoscale_cooldown_s
        scaler.tick()
    fleet.backlog = 0


def test_scale_down_requires_sustained_idle():
    """Backlog at zero does NOT shrink the fleet until the idle
    stretch has lasted autoscale_idle_s continuously."""
    fleet = ScaleFleet()
    scaler, clock = make_scaler(fleet)
    _grow_to(fleet, scaler, clock, 3)
    clock[0] += FC.autoscale_cooldown_s
    assert scaler.tick() is None  # arms the stretch
    clock[0] += FC.autoscale_idle_s / 2
    assert scaler.tick() is None  # idle, but not LONG enough
    clock[0] += FC.autoscale_idle_s
    assert scaler.tick() == "down"
    assert len(fleet.workers) == 2


def test_each_step_down_needs_a_fresh_stretch():
    """The idle stretch re-arms after every step down: a 4-worker fleet
    does not collapse straight to min in one long-idle tick."""
    fleet = ScaleFleet()
    scaler, clock = make_scaler(fleet)
    _grow_to(fleet, scaler, clock, 4)
    downs = 0
    for _ in range(40):
        clock[0] += 1.0
        if scaler.tick() == "down":
            downs += 1
            # the very next tick must never double-step
            clock[0] += 0.5
            assert scaler.tick() is None
    assert downs == 3 and len(fleet.workers) == scaler.min_workers


def test_excursion_voids_idle_stretch():
    """Any excursion above the down threshold — even inside the
    hysteresis band, without triggering an up — resets the idle clock
    to zero."""
    fleet = ScaleFleet()
    scaler, clock = make_scaler(fleet)
    _grow_to(fleet, scaler, clock, 3)
    clock[0] += FC.autoscale_cooldown_s
    scaler.tick()  # arm
    clock[0] += FC.autoscale_idle_s - 1.0
    fleet.backlog = 5 * len(fleet.workers)  # band: 2 < 5 <= 8
    assert scaler.tick() is None
    fleet.backlog = 0
    clock[0] += 2.0  # idle_s would long since have elapsed pre-reset
    assert scaler.tick() is None  # stretch restarted from the excursion
    clock[0] += FC.autoscale_idle_s
    assert scaler.tick() == "down"


def test_never_flaps_under_oscillating_load():
    """Load bouncing across the band every tick must not bounce the
    worker count: the up/down thresholds + idle stretch are the
    hysteresis. At most the initial climb, never an up-down-up saw."""
    fleet = ScaleFleet()
    scaler, clock = make_scaler(fleet)
    sizes = [len(fleet.workers)]
    for i in range(60):
        clock[0] += 1.0
        fleet.backlog = (10 if i % 2 == 0 else 0) * len(fleet.workers)
        scaler.tick()
        sizes.append(len(fleet.workers))
    # direction changes along the size trajectory: a clean climb has
    # exactly one monotone run; flapping shows up as many reversals
    deltas = [b - a for a, b in zip(sizes, sizes[1:]) if b != a]
    reversals = sum(
        1 for a, b in zip(deltas, deltas[1:]) if (a > 0) != (b > 0)
    )
    assert reversals == 0, f"worker count flapped: {sizes}"
    # and the oscillation (which never leaves a sustained idle stretch)
    # must not have scaled the fleet down at all
    assert all(d > 0 for d in deltas)


# -- background-job parking ---------------------------------------------------


def test_parks_on_spike_resumes_after_drain():
    fleet = ScaleFleet()
    scaler, clock = make_scaler(fleet)
    fleet.backlog = 40
    scaler.tick()
    assert fleet.jobs_parked
    # inside the band: still parked (park honours the same hysteresis)
    fleet.backlog = 5 * len(fleet.workers)
    clock[0] += 1.0
    scaler.tick()
    assert fleet.jobs_parked
    fleet.backlog = 0
    clock[0] += 1.0
    scaler.tick()
    assert not fleet.jobs_parked


def test_parking_works_even_when_sizing_is_pinned():
    """A fleet pinned at max_workers (or with the sizing disabled)
    still sheds its background job on an interactive spike — parking is
    independent of resize headroom."""
    fixed = dataclasses.replace(FC, min_workers=2, max_workers=2)
    fleet = ScaleFleet(fixed)
    scaler, clock = make_scaler(fleet)
    fleet.backlog = 40
    scaler.tick()
    assert fleet.jobs_parked and fleet.resizes == []
    fleet.backlog = 0
    clock[0] += 1.0
    scaler.tick()
    assert not fleet.jobs_parked


def test_ema_smooths_single_tick_blips():
    """With real smoothing (beta=0.5) a one-tick backlog blip does not
    cross the up threshold — the EMA needs sustained pressure."""
    fc = dataclasses.replace(FC, autoscale_ema_beta=0.5)
    fleet = ScaleFleet(fc)
    scaler, clock = make_scaler(fleet)
    fleet.backlog = 0
    scaler.tick()  # seed the EMA at 0
    fleet.backlog = 9 * len(fleet.workers)  # just past the raw threshold
    clock[0] += 1.0
    assert scaler.tick() is None  # EMA 4.5 <= 8: no resize yet
    ticks_to_up = 1
    while len(fleet.workers) == 2 and ticks_to_up < 10:
        clock[0] += FC.autoscale_cooldown_s
        fleet.backlog = 9 * len(fleet.workers)
        scaler.tick()
        ticks_to_up += 1
    # sustained pressure DOES get through, just not on the first tick
    assert len(fleet.workers) == 3 and ticks_to_up >= 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscaler_decisions_equal_reference(seed):
    """Given the same fake clock and load trace, the port's Autoscaler
    resizes and parks exactly as the reference's does."""
    from roko_tpu.config import FleetConfig as JFleet
    from roko_tpu.serve.supervisor import Autoscaler as RefAutoscaler

    fields = {f.name: getattr(FC, f.name) for f in dataclasses.fields(FC)}
    beta = (0.0, 0.5, 0.3)[seed]
    port_fleet = ScaleFleet(dataclasses.replace(FC, autoscale_ema_beta=beta))
    ref_fleet = ScaleFleet(JFleet(**dict(fields, autoscale_ema_beta=beta)))
    clock = [0.0]
    port = Autoscaler(port_fleet, log=_quiet, clock=lambda: clock[0])
    ref = RefAutoscaler(ref_fleet, log=_quiet, clock=lambda: clock[0])
    assert (port.enabled, port.min_workers, port.max_workers) == \
        (ref.enabled, ref.min_workers, ref.max_workers)
    rng = np.random.default_rng(seed)
    trace = []
    for phase in (0, 60, 3, 25, 0, 12, 1):  # idle, flood, drain, ...
        trace += [int(v) for v in rng.poisson(phase * 2 + 0.5, 15)]
    for backlog in trace:
        clock[0] += float(rng.choice([0.5, 1.0, 2.5]))
        port_fleet.backlog = ref_fleet.backlog = backlog
        assert port.tick() == ref.tick()
        assert port.ema == ref.ema
        assert port_fleet.jobs_parked == ref_fleet.jobs_parked
    assert port_fleet.resizes == ref_fleet.resizes and port_fleet.resizes


def test_front_job_routes_name_a10(tmp_path):
    """The distributed polish's routes (ported from queue item A10): a
    bare front end reads no job (``GET /jobz`` idle) and has no job
    starter wired (``POST /job`` 501, as the reference's bare front end)."""
    fleet = make_fleet(tmp_path, workers=1)
    server, thread = start_front(fleet)
    port = server.server_address[1]
    try:
        assert get_json(port, "/jobz") == (200, {"state": "idle"})
        req = urllib.request.Request(f"http://127.0.0.1:{port}/job", data=b"{}",
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 501 and "not configured" in json.loads(exc.value.read())["error"]
    finally:
        stop_front(server, thread)


def test_cli_fleet_flags_layer_as_reference():
    """The fleet flags build the reference's fleet section, the
    federation's fields at their defaults."""
    from roko_tpu.cli import _build_config as ref_build
    from roko_tpu.cli import build_parser as ref_parser
    from roko_tpu_torch.cli import _build_config, build_parser

    argv = ["serve", "ckpt/", "--workers", "auto", "--devices-per-worker", "1",
            "--heartbeat-interval", "0.5", "--registry", "/r", "--bake-s", "4",
            "--rollback-error-pct", "1.5", "--rollback-p99-x", "2", "--min-workers", "1",
            "--max-workers", "3", "--ab-lane", "v2:0.25"]
    got = json.loads(_build_config(build_parser().parse_args(argv)).to_json())["fleet"]
    want = json.loads(ref_build(ref_parser().parse_args(argv)).to_json())["fleet"]
    assert got == want and got["workers"] == -1
    with pytest.raises(SystemExit):
        build_parser().parse_args(["serve", "m", "--ab-lane", "v2:1.5"])


def test_real_two_worker_fleet_reply_equals_run_inference_and_reference(tmp_path):
    """A real fleet of ``python -m roko_tpu_torch serve --device cpu``:
    the supervisor and two workers as processes, its ``/polish`` reply
    byte-identical to the port's ``run_inference`` and to ``roko-tpu
    serve``'s on the same converted weights; SIGTERM drains it to exit 0
    with no worker left."""
    import signal
    import subprocess

    import jax
    import torch

    from roko_tpu.config import MeshConfig as JMesh
    from roko_tpu.config import RokoConfig as JRoko
    from roko_tpu.config import ServeConfig as JServe
    from roko_tpu.models import RokoModel as JModel
    from roko_tpu.parallel.mesh import make_mesh
    from roko_tpu.serve import server as ref_server
    from roko_tpu.serve.session import PolishSession as RefSession
    from roko_tpu_torch.config import ModelConfig
    from roko_tpu_torch.infer import run_inference
    from roko_tpu_torch.models.convert import state_dict_from_jax
    from roko_tpu_torch.models.model import RokoModel
    from tests.test_lingru import TINY_GRU

    widths = {f: getattr(TINY_GRU, f) for f in ("embed_dim", "read_mlp", "hidden_size",
                                                 "num_layers")}
    params = jax.tree.map(np.asarray, JModel(TINY_GRU).init(jax.random.PRNGKey(5)))
    sd = state_dict_from_jax(params)
    pth = str(tmp_path / "m.pth")
    torch.save(sd, pth)
    cfg = RokoConfig(model=ModelConfig(**widths), serve=ServeConfig(ladder=(8,)),
                     fleet=fast_fleet_cfg(2, heartbeat_interval_s=0.2, spawn_deadline_s=60.0,
                                          runtime_dir=str(tmp_path / "rt")))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    rng = np.random.default_rng(4)
    n, cols, stride = 7, 90, 30
    x = rng.integers(0, 12, (n, 200, cols)).astype(np.uint8)
    positions = np.zeros((n, cols, 2), np.int64)
    for i in range(n):
        positions[i, :, 0] = np.arange(i * stride, i * stride + cols)
    draft = "".join(rng.choice(list("ACGT"), (n - 1) * stride + cols + 10))
    model = RokoModel(cfg.model)
    model.load_state_dict(sd, strict=True)
    want = run_inference(iter([(["c"] * n, positions, x)]), {"c": draft}, model,
                         device="cpu", log=lambda m: None)["c"]
    jcfg = JRoko(model=TINY_GRU, mesh=JMesh(dp=1), serve=JServe(ladder=(8,)))
    ref_sess = RefSession(params, jcfg, mesh=make_mesh(jcfg.mesh, jax.devices()[:1]))
    ref_sess.warmup()
    ref_srv = ref_server.make_server(ref_sess, jcfg.serve, port=0)
    ref_thread = threading.Thread(target=ref_srv.serve_forever, daemon=True)
    ref_thread.start()
    try:
        ref_reply = PolishClient(f"http://127.0.0.1:{ref_srv.server_address[1]}").polish(
            draft, positions, x, contig="c")
    finally:
        ref_srv.shutdown()
        ref_srv.batcher.stop()
        ref_srv.server_close()
        ref_thread.join(5.0)
    announce = str(tmp_path / "front.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ROKO_COMPILE_CACHE"] = "off"
    proc = subprocess.Popen(
        [sys.executable, "-m", "roko_tpu_torch", "serve", pth, "--config", str(cfg_path),
         "--workers", "2", "--device", "cpu", "--port", "0", "--announce", announce],
        cwd=str(Path(__file__).resolve().parent.parent), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    pids = []
    try:
        wait_until(lambda: os.path.exists(announce) or proc.poll() is not None,
                   timeout=60.0, msg="front announce")
        assert proc.poll() is None, proc.stdout.read()
        port = json.load(open(announce))["port"]
        wait_until(lambda: get_json(port, "/healthz")[1].get("workers_up") == 2,
                   timeout=60.0, msg="2 workers ready")
        _, health = get_json(port, "/healthz")
        assert health["workers_up"] == 2 and health["status"] == "ok"
        reply = PolishClient(f"http://127.0.0.1:{port}").polish(draft, positions, x,
                                                                contig="c")
        assert reply["polished"] == want == ref_reply["polished"]
        assert reply["windows"] == n
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                         timeout=10).read().decode()
        assert 'roko_compile_cache_misses{worker="0"} 0' in metrics
        for wid in (0, 1):
            with open(tmp_path / "rt" / f"worker-{wid}.announce.json") as f:
                pids.append(json.load(f)["pid"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        try:  # the supervisor leads its own group: no worker outlives a failure
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
