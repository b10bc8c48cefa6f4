"""Standard-library HTTP front end of the polishing service (the port's
copy of ``roko_tpu/serve/server.py``): ``ThreadingHTTPServer`` and
``BaseHTTPRequestHandler`` only; the warm session, the batching plane and
backpressure live behind it.

Routes:

- ``POST /polish`` — JSON body, two forms:

  1. **windows** (the wire format): ``contig``, ``draft``, ``n`` plus
     ``positions`` / ``examples`` as base64 raw little-endian arrays
     (``int64[n, cols, 2]`` / ``uint8[n, rows, cols]``) or small nested
     lists. Returns the stitched contig.
  2. **ref + bam** (server-local paths, confined to ``data_root`` when
     one is set): the region fan-out of the streaming polish
     (``features.pipeline.open_region_stream``) extracts every region in
     memory, its windows go through the same batcher, and the reply is
     ``{"contigs": {name: polished}}``. The reference writes a temporary
     HDF5 file here; the replies are the same.
  3. **unit** (ref + bam + a ``unit`` object): one work unit of the
     distributed polish (``pipeline/distpolish.py``): the unit's region
     slice is extracted, predicted, and either stitched (``emit:
     "contig"``) or returned as raw per-window predictions (``emit:
     "preds"``, a span unit the coordinator votes and stitches).

  Each form goes through the server's cascade router when it was started
  with one (``cascade/``); ``"cascade": false`` takes the plain path for
  one request and ``"cascade": {"threshold": t}`` a same-identity router
  at another threshold.
- ``GET /healthz`` — liveness, the ladder, the batching policy, the
  session's grid (``mesh_dp``, ``devices``), the live Retry-After hint
  and tenant backlogs; **503** while the ladder warms, while the circuit
  breaker is open, while the server drains, and ``"broken"`` (with the
  reason) once a session over several ranks broke.
- ``GET /metrics`` — Prometheus text (``serve/metrics.py``).
- ``GET /tracez`` — the request-trace ring (last N + slowest N replies
  with their span breakdowns) and a live scheduler snapshot.
- ``POST /profilez?seconds=N`` — ``torch.profiler`` over the next N
  seconds (the card's activity on a card, the host's elsewhere), its
  Chrome trace written into a fresh directory whose path the reply
  returns; 409 while another capture runs.

Every ``POST /polish`` reply carries a ``request_id`` (minted here or
honoured from ``X-Roko-Request-Id``) and a ``timings`` span breakdown.
``X-Roko-Tenant`` bills a request to a tenant; ``X-Roko-Model`` pins it
to this process's ``ROKO_MODEL_VERSION``. Backpressure — queue full,
breaker open, draining, warming — is **503** with ``Retry-After``; a
tenant past its quota **429**; malformed payloads **400**; anything
unexpected **500** with the exception type only (the traceback goes to
the server's stderr).

Shutdown is graceful: SIGTERM (or :func:`drain`) stops admitting work,
lets in-flight requests finish under ``resilience.drain_deadline_s``,
then exits.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import threading
import time
import traceback
import urllib.parse
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from roko_tpu_torch import constants as C
from roko_tpu_torch.config import FeaturesConfig, ServeConfig
from roko_tpu_torch.infer import VoteBoard
from roko_tpu_torch.obs import events as obs_events
from roko_tpu_torch.obs.trace import RequestTrace, TraceRing, new_request_id
from roko_tpu_torch.resilience import CircuitBreaker
from roko_tpu_torch.serve.batcher import Backpressure, MicroBatcher, QuotaExceeded
from roko_tpu_torch.serve.httpbase import (  # noqa: F401 - the server's public names
    _NAME_RE,
    MAX_BODY_BYTES,
    REQUEST_TIMEOUT_S,
    JsonRequestHandler,
    _BadRequest,
    check_model_pin,
    drain,
    init_lifecycle,
    request_tenant,
    serve_forever,
    sigusr2_dump,
    write_announce,
)
from roko_tpu_torch.serve.metrics import ServeMetrics
from roko_tpu_torch.serve.session import PolishSession

#: Retry-After of the warming 503: the first dispatch of each rung builds
#: the kernels on the card, which takes far longer than a queue drains
WARMING_RETRY_AFTER_S = 30.0
#: a service whose session over several ranks broke answers ``/healthz``
#: 503 "broken" this long, so a probe can read why, then drains and exits
BROKEN_EXIT_AFTER_S = 2.0


def _decode_array(payload: Dict[str, Any], key: str, dtype, shape: Tuple[int, ...]) -> np.ndarray:
    """Base64 raw little-endian bytes, or nested lists for small
    hand-written payloads; always validated against ``shape``."""
    raw = payload.get(key)
    if raw is None:
        raise _BadRequest(f"missing field {key!r}")
    if isinstance(raw, str):
        try:
            buf = base64.b64decode(raw.encode("ascii"), validate=True)
        except Exception:
            raise _BadRequest(f"field {key!r} is not valid base64") from None
        try:
            arr = np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder("<"))
        except ValueError:  # byte count not a multiple of the item size
            raise _BadRequest(
                f"field {key!r} decodes to {len(buf)} bytes, not a "
                f"whole number of {np.dtype(dtype).name} elements"
            ) from None
        arr = arr.astype(dtype, copy=False)
    else:
        try:
            arr = np.asarray(raw, dtype=dtype)
        except (TypeError, ValueError):
            raise _BadRequest(
                f"field {key!r} is not a well-formed {np.dtype(dtype).name} array"
            ) from None
    try:
        arr = arr.reshape(shape)
    except ValueError:
        raise _BadRequest(f"field {key!r} has {arr.size} elements, want shape {shape}") from None
    return arr


def _cascade_override(payload: Dict[str, Any], router):
    """The per-request cascade control (``roko_tpu/serve/server.py:
    190-228``): ``"cascade": false`` forces the plain path for this
    request; ``"cascade": {"threshold": t}`` routes through a
    same-identity router at another threshold (another threshold is
    another cache keyspace); absent = the server's default."""
    raw = payload.get("cascade", None)
    if raw is None:
        return router
    if raw is False:
        return None
    if not isinstance(raw, dict):
        raise _BadRequest(
            "field 'cascade' must be false or an object like "
            '{"threshold": 0.02}'
        )
    if router is None:
        raise _BadRequest(
            "cascade override given but the server has no cascade "
            "configured (start with --cascade)"
        )
    try:
        threshold = float(raw["threshold"])
    except (KeyError, TypeError, ValueError):
        raise _BadRequest("field 'cascade.threshold' must be a number in [0, 1]") from None
    if not 0.0 <= threshold <= 1.0:
        raise _BadRequest("field 'cascade.threshold' must be a number in [0, 1]")
    if threshold == router.threshold:
        return router
    return router.with_threshold(threshold)


def _batch_predict(batcher, x, trace=None, router=None, tenant=None) -> np.ndarray:
    """One predict through the batching plane, cascaded when a router is
    given: the chokepoint of every /polish form. ``tenant`` rides into
    ``submit``; the router's path closes over it, since its submit
    function takes ``(x, trace=)``."""
    if router is None:
        return batcher.submit(x, trace=trace, tenant=tenant).result(REQUEST_TIMEOUT_S)
    submit = (
        batcher.submit
        if tenant is None
        else lambda xs, trace=None: batcher.submit(xs, trace=trace, tenant=tenant)
    )
    return router.predict(x, submit, timeout=REQUEST_TIMEOUT_S, trace=trace)


def _polish_windows(
    batcher, payload: Dict[str, Any],
    trace: Optional[RequestTrace] = None,
    router=None,
    tenant: Optional[str] = None,
) -> Dict[str, Any]:
    cfg = batcher.session.cfg.model
    draft = payload.get("draft")
    if not isinstance(draft, str) or not draft:
        raise _BadRequest("missing field 'draft' (contig sequence)")
    contig = payload.get("contig", "seq")
    try:
        n = int(payload["n"])
    except (KeyError, TypeError, ValueError):
        raise _BadRequest("missing/invalid field 'n' (window count)") from None
    if n < 0:
        raise _BadRequest("'n' must be >= 0")
    positions = _decode_array(payload, "positions", np.int64, (n, cfg.window_cols, 2))
    examples = _decode_array(payload, "examples", np.uint8,
                             (n, cfg.window_rows, cfg.window_cols))
    if n:
        # out-of-range positions would crash the scatter (500), and
        # negative ones would WRAP through numpy indexing into a silently
        # wrong 200 reply
        pos, ins = positions[:, :, 0], positions[:, :, 1]
        if (int(pos.min()) < 0 or int(pos.max()) >= len(draft)
                or int(ins.min()) < 0 or int(ins.max()) > C.MAX_INS):
            raise _BadRequest(
                f"positions out of range: pos must lie in [0, {len(draft)})"
                f" (draft length) and ins in [0, {C.MAX_INS}]"
            )
    preds = _batch_predict(batcher, examples, trace=trace, router=router, tenant=tenant)
    t0 = time.perf_counter()
    board = VoteBoard({contig: draft})
    board.add([contig] * n, positions, preds)
    polished = board.stitch(contig)
    if trace is not None:
        trace.add("stitch", time.perf_counter() - t0)
    return {"contig": contig, "polished": polished, "windows": n}


def path_under_root(path: str, root: str) -> bool:
    """The data-root containment rule (realpath-resolved)."""
    real, rootr = os.path.realpath(path), os.path.realpath(root)
    return real == rootr or real.startswith(rootr + os.sep)


def _check_data_path(label: str, path: Any, data_root: Optional[str]) -> str:
    """Validate a client-named server-local path, with ONE error message
    for every failure (bad type, outside the root, missing), so the reply
    is no file-existence oracle. A store URL (``gs://``, ``s3://``,
    ``http(s)://``) passes through unless a data root is set: it is
    fetched through the store client and discloses no local file, but an
    operator who confined the paths has confined what this process may
    fetch too."""
    from roko_tpu_torch.datapipe.io import STORE_SCHEMES, path_scheme

    err = _BadRequest(
        f"field {label!r} must name a readable data file"
        + (" under the configured data root" if data_root else "")
    )
    if not isinstance(path, str) or not path:
        raise err
    if path_scheme(path) in STORE_SCHEMES:
        if data_root is not None:
            raise err
        return path
    if data_root is not None and not path_under_root(path, data_root):
        raise err
    real = os.path.realpath(path)
    if not os.path.isfile(real):
        raise err
    return real


def _polish_bam(
    batcher, payload: Dict[str, Any],
    data_root: Optional[str] = None,
    trace: Optional[RequestTrace] = None,
    router=None,
    tenant: Optional[str] = None,
) -> Dict[str, Any]:
    """The ref + bam form: extract every region of the server-local draft
    and BAM in memory (the streaming polish's region fan-out) and polish
    each contig through the same batcher as the wire form, in top-rung
    chunks."""
    from roko_tpu_torch.features.pipeline import open_region_stream

    ref = _check_data_path("ref", payload.get("ref"), data_root)
    bam = _check_data_path("bam", payload.get("bam"), data_root)
    try:
        workers = int(payload.get("workers", 1))
        seed = int(payload.get("seed", 0))
    except (TypeError, ValueError):
        raise _BadRequest("fields 'workers'/'seed' must be integers") from None
    # the client names the extraction parallelism it wants; the server
    # grants at most its cores
    workers = max(1, min(workers, os.cpu_count() or 1))
    session = batcher.session
    cfg = session.cfg
    top = session.ladder[-1]
    n = 0
    with open_region_stream(
        ref, bam, workers=workers, seed=seed,
        config=FeaturesConfig(cfg.window, cfg.read_filter, cfg.region),
        log=lambda *_a, **_k: None,
    ) as stream:
        board = VoteBoard(dict(stream.refs))
        for contig, positions, examples, _ in stream.results:
            for s in range(0, len(examples), top):
                x = examples[s : s + top]
                board.add([contig] * len(x), positions[s : s + top],
                          _batch_predict(batcher, x, trace=trace, router=router,
                                         tenant=tenant))
                n += len(x)
    t0 = time.perf_counter()
    contigs = board.stitch_all()
    if trace is not None:
        trace.add("stitch", time.perf_counter() - t0)
    return {"contigs": contigs, "windows": n}


def _polish_unit(
    batcher, payload: Dict[str, Any],
    data_root: Optional[str] = None,
    trace: Optional[RequestTrace] = None,
    router=None,
    tenant: Optional[str] = None,
) -> Dict[str, Any]:
    """One work unit of the distributed polish (``pipeline/
    distpolish.py``, ``roko_tpu/serve/server.py:397-482``): extract
    exactly the unit's region slice of the server-local ``ref`` + ``bam``,
    predict it through the warm session, and either stitch the contig
    (``emit: "contig"``, a whole-contig unit) or return the raw
    per-window predictions (``emit: "preds"``, a span unit the
    coordinator votes and stitches). The region table and the seeds are
    derived again as the single process derives them, so the windows are
    that run's, bit for bit."""
    from roko_tpu_torch.pipeline.distpolish import b64_array, extract_unit_windows

    ref = _check_data_path("ref", payload.get("ref"), data_root)
    bam = _check_data_path("bam", payload.get("bam"), data_root)
    unit = payload.get("unit")
    if not isinstance(unit, dict):
        raise _BadRequest("field 'unit' must be an object")
    try:
        contig = unit["contig"]
        first = int(unit["first_region"])
        count = int(unit["n_regions"])
    except (KeyError, TypeError, ValueError):
        raise _BadRequest("field 'unit' needs 'contig', 'first_region', 'n_regions'") from None
    if not isinstance(contig, str) or not contig:
        raise _BadRequest("'unit.contig' must be a contig name")
    emit = unit.get("emit", "contig")
    if emit not in ("contig", "preds"):
        raise _BadRequest("'unit.emit' must be 'contig' or 'preds'")
    try:
        seed = int(payload.get("seed", 0))
    except (TypeError, ValueError):
        raise _BadRequest("'seed' must be an integer") from None
    session = batcher.session
    t0 = time.perf_counter()
    try:
        draft, positions, x = extract_unit_windows(ref, bam, contig, first, count, seed,
                                                   session.cfg)
    except ValueError as e:
        raise _BadRequest(str(e)) from None
    if trace is not None:
        trace.add("extract", time.perf_counter() - t0)
    n = int(len(positions))
    # top-rung chunks, so a giant unit never exceeds the batching plane's
    # admission bounds (the ref + bam form's rule)
    top = session.ladder[-1]
    chunks = [
        _batch_predict(batcher, x[i : i + top], trace=trace, router=router, tenant=tenant)
        for i in range(0, n, top)
    ]
    preds = (np.concatenate(chunks) if chunks
             else np.empty((0, session.cfg.model.window_cols), np.int32))
    if emit == "preds":
        return {"contig": contig, "windows": n, "positions": b64_array(positions, np.int64),
                "preds": b64_array(preds, np.int32)}
    t0 = time.perf_counter()
    board = VoteBoard({contig: draft})
    if n:
        board.add([contig] * n, positions, preds)
    polished = board.stitch(contig)
    if trace is not None:
        trace.add("stitch", time.perf_counter() - t0)
    return {"contig": contig, "polished": polished, "windows": n}


class _Handler(JsonRequestHandler):
    # set by make_server on the class copy
    batcher: MicroBatcher
    metrics: ServeMetrics
    ring: Optional[TraceRing] = None
    data_root: Optional[str] = None
    worker_id: Optional[int] = None
    router = None
    on_polished: Optional[Callable[[], None]] = None

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] == "/tracez":
            self._handle_tracez()
        elif self.path == "/healthz":
            self._handle_healthz()
        elif self.path == "/metrics":
            self._reply(200, self.metrics.render().encode(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._reply_json(404, {"error": f"no route {self.path}"})

    def _handle_healthz(self) -> None:
        session = self.batcher.session
        breaker = getattr(self.server, "breaker", None)
        body: Dict[str, Any] = {
            "status": "ok",
            "ladder": list(session.ladder),
            "batching": getattr(self.batcher, "BATCHING_MODE", "deadline"),
            "compiled": session.cache_size(),
            "mesh_dp": getattr(session, "dp", 1),
            "devices": getattr(session, "n_devices", 1),
            "cpu_fallback": getattr(session, "failed_over", False),
        }
        if self.worker_id is not None:
            body["worker_id"] = self.worker_id
        hint = getattr(self.batcher, "retry_after_s", None)
        if isinstance(hint, (int, float)):
            body["retry_after_s"] = round(float(hint), 3)
        backlog_fn = getattr(self.batcher, "backlog_windows", None)
        if callable(backlog_fn):
            body["queue_windows"] = int(backlog_fn())
            occ = getattr(self.batcher, "occupancy", None)
            if callable(occ):
                body["occupancy"] = round(float(occ()), 4)
        tb_fn = getattr(self.batcher, "tenant_backlogs", None)
        tr_fn = getattr(self.batcher, "tenant_retry_after_s", None)
        if callable(tb_fn) and callable(tr_fn):
            body["tenants"] = {
                t: {"backlog_windows": n, "retry_after_s": round(float(tr_fn(t)), 3)}
                for t, n in sorted(tb_fn().items())
            }
        code = 200
        if breaker is not None:
            body["breaker"] = breaker.state
            body["breaker_trips"] = breaker.trip_count
            if breaker.state == "open":
                body["status"] = "unhealthy"
                code = 503
        if self.server._warming.is_set():
            body["status"] = "warming"
            code = 503
        if self.server._draining.is_set():
            body["status"] = "draining"
            code = 503
        broken = getattr(session, "broken", None)
        if broken is not None:
            body["status"] = "broken"
            body["broken"] = broken
            code = 503
        self._reply_json(code, body)

    def _handle_tracez(self) -> None:
        """The trace ring and a live scheduler snapshot; ``?last=N&
        slowest=M`` bound how many records return."""
        query = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)

        def _qint(name: str) -> Optional[int]:
            try:
                return max(1, int(query[name][0]))
            except (KeyError, IndexError, ValueError):
                return None

        body: Dict[str, Any] = {
            "worker_id": self.worker_id,
            "batching": getattr(self.batcher, "BATCHING_MODE", "deadline"),
        }
        if self.ring is not None:
            body.update(self.ring.snapshot(_qint("last"), _qint("slowest")))
        snap = getattr(self.batcher, "snapshot", None)
        if snap is not None:
            body["scheduler"] = snap()
        self._reply_json(200, body)

    def _handle_profilez(self) -> None:
        """``torch.profiler`` over the next N seconds into a fresh
        directory, on this handler thread (the reply lands once the trace
        is on disk); one capture at a time (409 while one runs)."""
        import tempfile

        from roko_tpu_torch.utils.profiling import capture_device_trace

        query = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        try:
            seconds = float(query.get("seconds", ["3"])[0])
        except ValueError:
            self._reply_json(400, {"error": "seconds must be a number"})
            return
        seconds = max(0.1, min(seconds, 120.0))
        lock: threading.Lock = self.server._profile_lock  # type: ignore[attr-defined]
        if not lock.acquire(blocking=False):
            self._reply_json(409, {"error": "a profile capture is already running"})
            return
        try:
            trace_dir = tempfile.mkdtemp(prefix="roko-profilez-")
            obs_events.emit("serve", "profile_start", trace_dir=trace_dir, seconds=seconds,
                            quiet=True)
            device = getattr(self.batcher.session, "device", None)
            trace_file = capture_device_trace(trace_dir, seconds, device=device)
        except Exception as e:
            self.metrics.inc("errors")
            traceback.print_exc(file=sys.stderr)
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        finally:
            lock.release()
        obs_events.emit("serve", "profile_done", trace_dir=trace_dir, seconds=seconds,
                        quiet=True)
        self._reply_json(200, {
            "trace_dir": trace_dir, "trace_file": trace_file, "seconds": seconds,
            "hint": "a Chrome trace: open it in chrome://tracing or Perfetto",
        })

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] == "/profilez":
            self._handle_profilez()
            return
        if self.path != "/polish":
            self._reply_json(404, {"error": f"no route {self.path}"})
            return
        with self._track_inflight():
            # checked AFTER the in-flight increment: drain() watches the
            # counter, so checking first could let it read 0 and shut
            # down while this request is between the check and the count
            if self.server._draining.is_set():
                self.close_connection = True
                retry = self.batcher.retry_after_s
                self._reply_json(
                    503, {"error": "server draining", "retry_after_s": retry},
                    extra={"Retry-After": f"{max(1, round(retry))}"},
                )
                return
            if self.server._warming.is_set():
                retry = max(self.batcher.retry_after_s, WARMING_RETRY_AFTER_S)
                self._reply_json(
                    503, {"error": "server warming up (ladder compiling)",
                          "retry_after_s": retry},
                    extra={"Retry-After": f"{max(1, round(retry))}"},
                )
                return
            self._handle_polish()

    def _handle_polish(self) -> None:
        rid = self.headers.get("X-Roko-Request-Id") or new_request_id()
        trace = RequestTrace(rid, worker_id=self.worker_id)
        try:
            raw = self._read_body()
            if raw is None:
                return  # error reply already sent
            payload = json.loads(raw.decode())
            if not isinstance(payload, dict):
                raise _BadRequest("payload must be a JSON object")
            tenant = request_tenant(self.headers, payload)
            check_model_pin(self.headers, payload, self.metrics.model_version)
            trace.tenant = tenant
            trace.model = self.metrics.model_version
            router = _cascade_override(payload, self.router)
            if "unit" in payload:
                result = _polish_unit(self.batcher, payload, self.data_root, trace=trace,
                                      router=router, tenant=tenant)
            elif "bam" in payload:
                result = _polish_bam(self.batcher, payload, self.data_root, trace=trace,
                                     router=router, tenant=tenant)
            else:
                result = _polish_windows(self.batcher, payload, trace=trace, router=router,
                                         tenant=tenant)
            trace.windows = int(result.get("windows", 0))
            result["request_id"] = rid
            result["timings"] = trace.timings()
            if self.ring is not None:
                self.ring.record(trace)
            if self.on_polished is not None:
                self.on_polished()
            self._reply_json(200, result)
        except QuotaExceeded as e:
            self._reply_json(
                429, {"error": str(e), "tenant": e.tenant, "retry_after_s": e.retry_after_s},
                extra={"Retry-After": f"{max(1, round(e.retry_after_s))}"},
            )
        except Backpressure as e:
            self._reply_json(
                503, {"error": str(e), "retry_after_s": e.retry_after_s},
                extra={"Retry-After": f"{max(1, round(e.retry_after_s))}"},
            )
        except TimeoutError:
            # the batcher did not answer within REQUEST_TIMEOUT_S, or the
            # peer stalled mid-body past the socket timeout: shed it and
            # close (a half-read body would desync the keep-alive stream)
            self.close_connection = True
            self.metrics.inc("errors")
            self._reply_json(503, {"error": "timed out reading the request or waiting for "
                                            "the predict result"})
        except (_BadRequest, json.JSONDecodeError, UnicodeDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
        except Exception as e:
            self.metrics.inc("errors")
            # the 500 body carries the type only; the traceback is logged
            traceback.print_exc(file=sys.stderr)
            self._reply_json(500, {"error": type(e).__name__})


def make_batcher(session: PolishSession, serve_cfg: ServeConfig, metrics: ServeMetrics,
                 breaker: Optional[CircuitBreaker]):
    """The batcher ``serve_cfg.batching`` names, with its knobs from
    ``serve_cfg``; the tenant table is the session's
    (``session.cfg.serve.tenants``), as in the reference."""
    if serve_cfg.batching in ("continuous", "ragged"):
        from roko_tpu_torch.serve.scheduler import ContinuousBatcher, RaggedBatcher

        cls = RaggedBatcher if serve_cfg.batching == "ragged" else ContinuousBatcher
        return cls(session, metrics=metrics, breaker=breaker, max_queue=serve_cfg.max_queue,
                   max_queue_age_ms=serve_cfg.max_queue_age_ms,
                   rung_upgrade_fill=serve_cfg.rung_upgrade_fill,
                   retry_after_s=serve_cfg.retry_after_s)
    return MicroBatcher(session, metrics=metrics, breaker=breaker,
                        max_queue=serve_cfg.max_queue, max_delay_ms=serve_cfg.max_delay_ms,
                        retry_after_s=serve_cfg.retry_after_s)


def make_server(
    session: PolishSession,
    serve_cfg: Optional[ServeConfig] = None,
    *,
    batcher=None,
    metrics: Optional[ServeMetrics] = None,
    breaker: Optional[CircuitBreaker] = None,
    host: Optional[str] = None,
    port: Optional[int] = None,
    warming: bool = False,
    worker_id: Optional[int] = None,
    on_polished: Optional[Callable[[], None]] = None,
) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) and return the server; the caller runs
    ``serve_forever``. The batcher, metrics, breaker and trace ring ride
    on the server object (``.batcher``, ``.metrics``, ...).

    ``warming=True`` starts in the not-ready state: ``/healthz`` says
    ``"warming"`` (503) and ``/polish`` sheds with 503 + Retry-After until
    the caller clears ``server._warming``. ``on_polished()`` is called
    after each answered ``/polish`` request, before its reply is sent."""
    serve_cfg = serve_cfg or session.cfg.serve
    rcfg = session.cfg.resilience
    metrics = metrics or ServeMetrics(latency_samples=serve_cfg.latency_samples)
    metrics.size_classes = tuple(session.ladder)
    if metrics.model_version is None:
        metrics.model_version = os.environ.get("ROKO_MODEL_VERSION") or None
    if batcher is None:
        if breaker is None and rcfg.breaker_failures > 0:
            breaker = CircuitBreaker(failure_threshold=rcfg.breaker_failures,
                                     reset_s=rcfg.breaker_reset_s)
        batcher = make_batcher(session, serve_cfg, metrics, breaker)
    else:
        breaker = breaker or batcher.breaker
    metrics.breaker = breaker
    metrics.cpu_fallback = lambda: getattr(session, "failed_over", False)
    # the cascade (cascade/, roko_tpu/serve/server.py:956-961): the router
    # is built against the session's quantized weights, so its cache keys
    # and calibration identity match what the card predicts with; a model
    # tier whose kernels the bundle lacks refuses here, at start
    router = None
    if session.cfg.cascade.enabled:
        from roko_tpu_torch.cascade import build_router

        router = build_router(session.cfg, params=session.model, metrics=metrics,
                              device=session.device)
    ring = TraceRing(serve_cfg.trace_ring, serve_cfg.trace_slowest)
    handler = type("RokoServeHandler", (_Handler,), {
        "batcher": batcher, "metrics": metrics, "ring": ring,
        "data_root": serve_cfg.data_root, "worker_id": worker_id, "router": router,
        "on_polished": staticmethod(on_polished) if on_polished else None,
    })
    server = ThreadingHTTPServer(
        (serve_cfg.host if host is None else host, serve_cfg.port if port is None else port),
        handler,
    )
    server.batcher = batcher  # type: ignore[attr-defined]
    server.metrics = metrics  # type: ignore[attr-defined]
    server.session = session  # type: ignore[attr-defined]
    server.breaker = breaker  # type: ignore[attr-defined]
    server.ring = ring  # type: ignore[attr-defined]
    server.router = router  # type: ignore[attr-defined]
    server._profile_lock = threading.Lock()  # type: ignore[attr-defined]
    init_lifecycle(server, rcfg.drain_deadline_s, warming=warming)
    return server
