"""The HTTP plumbing the polishing service and the fleet's front end
share (split out of ``serve/server.py``, the port's copy of the
reference's, so the supervisor imports no torch): the JSON handler base
with bounded body reads and drain-aware in-flight accounting, the
lifecycle state, the tenant and model-pin headers, the port announce
file, the graceful drain and the blocking serve loop. Pure Python."""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from roko_tpu_torch.obs import events as obs_events

#: request bodies above this are refused before parsing; one window is
#: about 26 kB of base64 JSON, so this admits about 10k windows a request
MAX_BODY_BYTES = 256 * 2**20

#: ceiling on one handler's wait for its predict result: a hung batcher
#: must surface as an error reply, not pin handler threads forever
REQUEST_TIMEOUT_S = 600.0

class _BadRequest(ValueError):
    pass


#: tenant and model-name grammar: a malformed id is a client bug (400),
#: never a new accounting bucket
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def request_tenant(headers, payload: Dict[str, Any]) -> Optional[str]:
    """The request's tenant id: the ``X-Roko-Tenant`` header first, then
    the payload's ``tenant`` field; None = the default tenant."""
    tenant = headers.get("X-Roko-Tenant") or payload.get("tenant")
    if tenant is None:
        return None
    if not isinstance(tenant, str) or not _NAME_RE.match(tenant):
        raise _BadRequest("tenant id must match [A-Za-z0-9][A-Za-z0-9._-]{0,63}")
    return tenant


def check_model_pin(headers, payload: Dict[str, Any], own: Optional[str]) -> None:
    """A request pinned to ``model=`` must land on a process RUNNING that
    version (``ROKO_MODEL_VERSION``); anything else refuses loudly in the
    reference's RegistryMismatch shape."""
    model = headers.get("X-Roko-Model") or payload.get("model")
    if model is None:
        return
    if not isinstance(model, str) or not _NAME_RE.match(model):
        raise _BadRequest("model name must match [A-Za-z0-9][A-Za-z0-9._-]{0,63}")
    if own is None:
        raise _BadRequest(
            f"RegistryMismatch: request pinned model={model!r} but this "
            "worker has no registry version identity (started outside "
            "a versioned rollout)"
        )
    if model != own:
        raise _BadRequest(
            f"RegistryMismatch: request pinned model={model!r} but this "
            f"worker runs {own!r}"
        )


class JsonRequestHandler(BaseHTTPRequestHandler):
    """Handler base: JSON replies, bounded body reads, and drain-aware
    in-flight accounting over the lifecycle state ``init_lifecycle``
    attaches to the server object."""

    protocol_version = "HTTP/1.1"
    #: socket timeout of one request's reads: a peer that stalls mid-body
    #: must not pin a handler thread forever
    timeout = 120.0

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # quiet; metrics carry the signal

    def _reply(self, code: int, body: bytes, content_type: str = "application/json",
               extra: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj: Dict[str, Any], **kw: Any) -> None:
        self._reply(code, json.dumps(obj).encode(), **kw)

    def _read_body(self, max_bytes: int = MAX_BODY_BYTES) -> Optional[bytes]:
        """Validate ``Content-Length`` and read the body; on a bad header
        (400) or an oversized body (413) the error reply is sent here and
        None returned."""
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = -1
        if length < 0:
            # the stream cannot be resynchronised (and rfile.read(-1)
            # would block until the peer closes): reply and close
            self.close_connection = True
            self._reply_json(400, {"error": "bad Content-Length header"})
            return None
        if length > max_bytes:
            self.close_connection = True
            self._reply_json(413, {"error": f"body exceeds {max_bytes} bytes"})
            return None
        return self.rfile.read(length)

    @contextlib.contextmanager
    def _track_inflight(self):
        """Count this request in the server's in-flight set, which
        ``drain`` waits on."""
        srv = self.server
        with srv._inflight_lock:
            srv._inflight += 1
        try:
            yield
        finally:
            with srv._inflight_lock:
                srv._inflight -= 1


def init_lifecycle(server: ThreadingHTTPServer, drain_deadline_s: float,
                   warming: bool = False) -> None:
    """Attach the drain and warming state ``drain`` and
    :class:`JsonRequestHandler` expect."""
    server.daemon_threads = True
    server._draining = threading.Event()  # type: ignore[attr-defined]
    server._warming = threading.Event()  # type: ignore[attr-defined]
    if warming:
        server._warming.set()  # type: ignore[attr-defined]
    server._inflight = 0  # type: ignore[attr-defined]
    server._inflight_lock = threading.Lock()  # type: ignore[attr-defined]
    server.drain_deadline_s = drain_deadline_s  # type: ignore[attr-defined]


def write_announce(path: str, port: int) -> None:
    """Publish a bound port as ``{"pid", "port"}`` by atomic rename (the
    port's copy of ``roko_tpu/serve/fleet.py:141``): whoever started a
    ``--port 0`` server reads its address here."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "port": int(port)}, f)
    os.replace(tmp, path)


def drain(server: ThreadingHTTPServer, deadline_s: Optional[float] = None, log=print) -> bool:
    """Graceful shutdown: reject NEW ``/polish`` work with 503 +
    ``Retry-After`` at once, wait up to ``deadline_s`` for in-flight
    requests to finish, then stop the accept loop. True when every
    in-flight request completed inside the deadline. A second call while
    draining is a no-op."""
    if server._draining.is_set():  # type: ignore[attr-defined]
        return True
    if deadline_s is None:
        deadline_s = getattr(server, "drain_deadline_s", 20.0)
    server._draining.set()  # type: ignore[attr-defined]
    log(f"roko serve: draining — rejecting new work, waiting up to {deadline_s:.0f}s for "
        "in-flight requests")
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        with server._inflight_lock:  # type: ignore[attr-defined]
            left = server._inflight  # type: ignore[attr-defined]
        if left == 0:
            break
        time.sleep(0.05)
    with server._inflight_lock:  # type: ignore[attr-defined]
        left = server._inflight  # type: ignore[attr-defined]
    if left:
        log(f"roko serve: drain deadline expired with {left} request(s) still in flight; "
            "shutting down anyway")
    else:
        log("roko serve: drained clean")
    server.shutdown()
    return left == 0


def sigusr2_dump(server: ThreadingHTTPServer, log=None) -> None:
    """Post-mortem without killing the service (``kill -USR2 <pid>``):
    every thread's stack plus the live scheduler snapshot, to stderr."""
    from roko_tpu_torch.resilience.watchdog import dump_thread_stacks

    snap = None
    snap_fn = getattr(getattr(server, "batcher", None), "snapshot", None)
    if snap_fn is not None:
        try:
            snap = snap_fn()
        except Exception:  # diagnostics never take the service down
            pass
    emit_log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    obs_events.emit("serve", "sigusr2_dump", log=emit_log, threads=threading.active_count(),
                    scheduler=json.dumps(snap) if snap is not None else "n/a")
    emit_log(dump_thread_stacks())


def serve_forever(server: ThreadingHTTPServer, log=print, drain_fn=None) -> None:
    """Blocking loop with a clean stop on Ctrl-C and a graceful SIGTERM
    drain (finish in-flight, reject new, then exit). Signal handlers are
    set only from the main thread; a test that serves from another
    thread calls :func:`drain` itself."""
    host, port = server.server_address[:2]
    log(f"roko serve: listening on http://{host}:{port} "
        "(POST /polish, GET /healthz, GET /metrics)")
    if drain_fn is None:
        drain_fn = lambda: drain(server, log=log)  # noqa: E731

    def _on_sigterm(signum, frame):
        # drain blocks and calls shutdown, which must not run on the
        # serve_forever thread: hand it to a thread of its own
        threading.Thread(target=drain_fn, name="roko-serve-drain", daemon=True).start()

    def _on_sigusr2(signum, frame):
        sigusr2_dump(server)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
        if hasattr(signal, "SIGUSR2"):
            signal.signal(signal.SIGUSR2, _on_sigusr2)
    except ValueError:  # not the main thread
        pass
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log("roko serve: shutting down")
    finally:
        batcher = getattr(server, "batcher", None)
        if batcher is not None:
            batcher.stop()
        server.server_close()
