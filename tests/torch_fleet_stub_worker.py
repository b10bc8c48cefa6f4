"""Stand-in fleet worker for the port's supervision tests (a copy of
``tests/fleet_stub_worker.py`` whose histogram rows come from
``roko_tpu_torch.obs.hist``): the real serve surface (``/healthz`` /
``/metrics`` / ``POST /polish``, port-0 bind + announce file, graceful
SIGTERM drain) with no torch import, so ``tests/test_torch_fleet.py`` and
``tests/test_torch_rollout.py`` exercise the REAL kill/waitpid/restart
machinery in tier-1 — spawn is ~100 ms.

Failure modes are injected through the environment:

- ``STUB_FAIL_START=1``      — exit(1) before binding (crash loop)
- ``STUB_WARM_S=N``          — report ``warming`` (503) for N seconds
- ``STUB_CRASH_ON_POLISH=1`` — ``os._exit(9)`` mid-request, no reply
  (the failover trigger)
- ``STUB_CRASH_AFTER=N``     — exit(1) after N successful polishes
- ``STUB_HANG_AFTER_S=T``    — stop answering anything T seconds after
  start (the hung-worker signature: process alive, heartbeats missed)
- ``STUB_POLISH_DELAY_S=T``  — hold each polish T seconds (lets a test
  pin requests in flight across a drain)
- ``STUB_UNHEALTHY=1``       — healthz 503 "unhealthy" (breaker-open
  stand-in: alive, out of rotation)
- ``STUB_VERSION=NAME``      — model version label carried in healthz
  and polish replies (rollout tests tell versions apart by it)
- ``STUB_RETRY_AFTER_S=T``   — report this live Retry-After hint in
  healthz (the PR 10 dynamic-backpressure stand-in); absent = no hint
- ``STUB_ERROR_EVERY=N``     — every Nth polish replies 500 and counts
  in errors_total (the rollout canary-gate trigger)
- ``STUB_P99_S=T``           — report this request p99 in /metrics
- ``STUB_HIST_MS=T``         — render a one-observation
  ``roko_request_latency_seconds`` histogram whose sample sits at T
  milliseconds (the supervisor bucket-sum aggregation tests tell
  workers apart by it)

Replies carry this process's pid so tests can see WHICH incarnation
answered across restarts (and echo ``X-Roko-Request-Id`` as
``request_id``, like the real server, so request-id propagation across
failover is testable on the stub fleet); /metrics renders live
requests/errors counters beside the static passthrough series.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

START = time.monotonic()
DRAINING = threading.Event()
INFLIGHT = 0
INFLIGHT_LOCK = threading.Lock()
POLISHED = 0

WARM_S = float(os.environ.get("STUB_WARM_S", "0"))
CRASH_ON_POLISH = os.environ.get("STUB_CRASH_ON_POLISH") == "1"
CRASH_AFTER = int(os.environ.get("STUB_CRASH_AFTER", "0"))
HANG_AFTER_S = float(os.environ.get("STUB_HANG_AFTER_S", "0"))
POLISH_DELAY_S = float(os.environ.get("STUB_POLISH_DELAY_S", "0"))
UNHEALTHY = os.environ.get("STUB_UNHEALTHY") == "1"
VERSION = os.environ.get("STUB_VERSION", "")
RETRY_AFTER_S = os.environ.get("STUB_RETRY_AFTER_S", "")
ERROR_EVERY = int(os.environ.get("STUB_ERROR_EVERY", "0"))
P99_S = os.environ.get("STUB_P99_S", "")
HIST_MS = os.environ.get("STUB_HIST_MS", "")
ERRORS = 0


def _hist_rows():
    """A minimal mergeable-histogram body: one observation at
    STUB_HIST_MS milliseconds over the shared fixed buckets."""
    # the stub launches as a script (sys.path[0] = tests/), so the repo
    # root needs adding before roko_tpu_torch.obs resolves; obs.hist
    # imports no torch, keeping the stub's ~100 ms spawn intact
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    from roko_tpu_torch.obs.hist import HistogramFamily

    fam = HistogramFamily("roko_request_latency_seconds")
    fam.observe(float(HIST_MS) / 1e3)
    return chr(10).join(fam.render()) + chr(10)

METRICS = """\
# TYPE roko_serve_breaker_state gauge
roko_serve_breaker_state 0
# TYPE roko_serve_breaker_trips_total counter
roko_serve_breaker_trips_total 1
# TYPE roko_compile_cache_hits counter
roko_compile_cache_hits 5
# TYPE roko_compile_cache_misses counter
roko_compile_cache_misses 2
"""


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _maybe_hang(self):
        if HANG_AFTER_S and time.monotonic() - START > HANG_AFTER_S:
            time.sleep(3600)

    def _reply(self, code, body, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self.wfile.flush()

    def _reply_json(self, code, obj):
        self._reply(code, json.dumps(obj).encode())

    def _health_body(self, status):
        body = {"status": status, "worker_pid": os.getpid()}
        if VERSION:
            body["version"] = VERSION
        if RETRY_AFTER_S:
            body["retry_after_s"] = float(RETRY_AFTER_S)
        return body

    def do_GET(self):  # noqa: N802
        self._maybe_hang()
        if self.path == "/healthz":
            if DRAINING.is_set():
                self._reply_json(503, self._health_body("draining"))
            elif time.monotonic() - START < WARM_S:
                self._reply_json(503, self._health_body("warming"))
            elif UNHEALTHY:
                body = self._health_body("unhealthy")
                body["breaker"] = "open"
                self._reply_json(503, body)
            else:
                self._reply_json(200, self._health_body("ok"))
        elif self.path == "/metrics":
            text = METRICS + (
                "# TYPE roko_serve_requests_total counter\n"
                f"roko_serve_requests_total {POLISHED}\n"
                "# TYPE roko_serve_errors_total counter\n"
                f"roko_serve_errors_total {ERRORS}\n"
            )
            if P99_S:
                text += (
                    "# TYPE roko_serve_request_latency_seconds summary\n"
                    'roko_serve_request_latency_seconds{quantile="0.99"} '
                    f"{float(P99_S)}\n"
                )
            if HIST_MS:
                text += _hist_rows()
            self._reply(200, text.encode(), ctype="text/plain")
        else:
            self._reply_json(404, {"error": "no route"})

    def do_POST(self):  # noqa: N802
        global POLISHED, ERRORS
        self._maybe_hang()
        length = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(length)
        if CRASH_ON_POLISH:
            os._exit(9)  # mid-request death: no reply, socket resets
        with INFLIGHT_LOCK:
            global INFLIGHT
            INFLIGHT += 1
        try:
            if DRAINING.is_set():
                self._reply_json(
                    503, {"error": "draining", "retry_after_s": 1.0}
                )
                return
            if time.monotonic() - START < WARM_S:
                self._reply_json(
                    503, {"error": "warming", "retry_after_s": 1.0}
                )
                return
            if POLISH_DELAY_S:
                time.sleep(POLISH_DELAY_S)
            try:
                n = int(json.loads(raw or b"{}").get("n", 0))
            except ValueError:
                n = 0
            POLISHED += 1
            if ERROR_EVERY and POLISHED % ERROR_EVERY == 0:
                # injected canary failure: a 500 counted in errors_total
                # (what the rollout gate watches), relayed verbatim by
                # the front end
                ERRORS += 1
                self._reply_json(500, {"error": "injected canary failure"})
                return
            reply = {"contig": "stub", "polished": f"STUB-{os.getpid()}",
                     "windows": n}
            rid = self.headers.get("X-Roko-Request-Id")
            if rid:
                reply["request_id"] = rid
            if VERSION:
                reply["version"] = VERSION
            self._reply_json(200, reply)
            if CRASH_AFTER and POLISHED >= CRASH_AFTER:
                time.sleep(0.05)  # let the reply bytes leave the socket
                os._exit(1)
        finally:
            with INFLIGHT_LOCK:
                INFLIGHT -= 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--announce", required=True)
    args = ap.parse_args()
    if os.environ.get("STUB_FAIL_START") == "1":
        print("stub: failing at start as instructed", file=sys.stderr)
        return 1
    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    tmp = args.announce + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "port": server.server_address[1]}, f)
    os.replace(tmp, args.announce)

    def on_sigterm(signum, frame):
        DRAINING.set()

        def drain_and_exit():
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                with INFLIGHT_LOCK:
                    if INFLIGHT == 0:
                        break
                time.sleep(0.02)
            server.shutdown()

        threading.Thread(target=drain_and_exit, daemon=True).start()

    import signal

    signal.signal(signal.SIGTERM, on_sigterm)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
