"""Request types of the batching plane and the deadline batcher (the
port's copy of ``roko_tpu/serve/batcher.py``).

:class:`MicroBatcher` (``ServeConfig.batching == "deadline"``): requests
(each a batch of ``uint8[n, rows, cols]`` windows) land in a bounded
queue; one worker thread coalesces them into device batches under two
limits:

- **fill**: stop gathering once the coalesced batch reaches the
  session's top ladder rung;
- **deadline**: a partially filled batch dispatches at most
  ``max_delay_ms`` after its FIRST request arrived, so a lone request's
  latency is bounded by the deadline, not by traffic.

Backpressure is explicit: when the queue is full (or the circuit breaker
open), ``submit`` raises :class:`Backpressure` with a Retry-After hint
(the HTTP layer maps it to 503); a tenant past its own quota raises
:class:`QuotaExceeded` (429) in the continuous batchers.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from roko_tpu_torch.resilience import CircuitBreaker
from roko_tpu_torch.serve.metrics import ServeMetrics

if TYPE_CHECKING:  # the session imports torch; the batchers are host code
    from roko_tpu_torch.serve.session import PolishSession

#: exception classes that indict the REQUEST, not the device: they never
#: move the circuit breaker (a client's bad window geometry says nothing
#: about chip health)
_REQUEST_ERRORS = (ValueError, TypeError)


class Backpressure(Exception):
    """Request rejected without touching the device — queue full or
    circuit breaker open; retry after ``retry_after_s`` seconds."""

    def __init__(self, retry_after_s: float, reason: str = "request queue full"):
        super().__init__(f"{reason}; retry after {retry_after_s:.1f}s")
        self.retry_after_s = retry_after_s


class QuotaExceeded(Backpressure):
    """A TENANT'S quota rejected the request, not global overload: the
    HTTP layer maps this to 429 + ``Retry-After`` (retrying helps once
    this tenant's own backlog drains; other tenants are unaffected)."""

    def __init__(self, retry_after_s: float, tenant: str, reason: str):
        super().__init__(retry_after_s, reason=f"tenant {tenant!r} {reason}")
        self.tenant = tenant


class _Request:
    __slots__ = ("x", "done", "preds", "error", "t_submit", "trace", "tenant")

    def __init__(self, x: np.ndarray, trace=None, tenant: Optional[str] = None):
        self.x = x
        self.done = threading.Event()
        self.preds: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        #: optional per-request obs.trace.RequestTrace riding the
        #: request through the batching plane
        self.trace = trace
        #: tenant id for fair-share accounting + latency labels
        self.tenant = tenant


class PredictFuture:
    """Handle for one submitted request."""

    def __init__(self, req: _Request, metrics: Optional[ServeMetrics]):
        self._req = req
        self._metrics = metrics

    def done(self) -> bool:
        """True once the result (or its error) is ready — a non-blocking
        probe for callers draining many futures opportunistically (the
        streaming polish rides the batcher this way)."""
        return self._req.done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._req.done.wait(timeout):
            raise TimeoutError("predict result not ready")
        if self._req.error is not None:
            raise self._req.error
        if self._metrics is not None:
            # records the aggregate "request" span AND the request's
            # size-class span (ladder-rung buckets), so /metrics shows
            # small-request p99 beside large-request p99 — the
            # head-of-line-blocking signal continuous batching exists
            # to fix
            self._metrics.observe_request(
                len(self._req.x),
                time.perf_counter() - self._req.t_submit,
                tenant=getattr(self._req, "tenant", None),
            )
        return self._req.preds


class MicroBatcher:
    #: policy name reported in /healthz (``ServeConfig.batching`` value
    #: that selects this class in ``make_server``)
    BATCHING_MODE = "deadline"

    def __init__(
        self,
        session: PolishSession,
        *,
        max_queue: Optional[int] = None,
        max_delay_ms: Optional[float] = None,
        retry_after_s: Optional[float] = None,
        metrics: Optional[ServeMetrics] = None,
        breaker: Optional[CircuitBreaker] = None,
        start: bool = True,
    ):
        serve_cfg = session.cfg.serve
        self.session = session
        #: circuit breaker over DEVICE failures (None = disabled): trips
        #: after N consecutive failed dispatches; while open, submit()
        #: sheds load at once with Backpressure instead of feeding a
        #: sick device whole request timeouts
        self.breaker = breaker
        self.max_delay_s = (
            serve_cfg.max_delay_ms if max_delay_ms is None else max_delay_ms
        ) / 1e3
        self.retry_after_s = (
            serve_cfg.retry_after_s if retry_after_s is None else retry_after_s
        )
        self.metrics = metrics
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=serve_cfg.max_queue if max_queue is None else max_queue
        )
        self._running = False
        self._stopped = False  # set once by stop(); submissions then fail fast
        self._thread: Optional[threading.Thread] = None
        self._steps = 0  # device dispatches so far (trace step ids)
        if metrics is not None:
            metrics.queue_depth = self._q.qsize
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="roko-microbatcher", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stopped = True
        if self._running:
            self._running = False
            self._repost_sentinel()  # wake the worker (best-effort)
            if self._thread is not None:
                self._thread.join(timeout)
                self._thread = None
        # second drain AFTER the worker is gone: a submit() racing
        # stop() can land a request behind the worker's own final
        # drain, and nothing would ever complete it
        self._fail_queued()

    def _fail_queued(self) -> None:
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is not None and not req.done.is_set():
                req.error = RuntimeError("batcher stopped")
                req.done.set()

    # -- client side --------------------------------------------------------

    def submit(
        self, x: np.ndarray, trace=None, tenant: Optional[str] = None
    ) -> PredictFuture:
        """Enqueue one window batch; raises :class:`Backpressure` when
        the queue is full and ``RuntimeError`` once the batcher has been
        stopped (a dead worker must fail requests fast, not strand
        their futures). ``trace`` (a
        :class:`roko_tpu_torch.obs.trace.RequestTrace`) collects the
        queue-wait / device span breakdown for the reply's ``timings``
        field. ``tenant`` labels the request's latency row; the
        deadline coalescer has no tenant fair-share (whole requests
        dispatch FIFO — use continuous/ragged mode for DRR admission),
        so here it is accounting only."""
        if self._stopped:
            raise RuntimeError("batcher stopped")
        if self.breaker is not None and not self.breaker.allow():
            # open (or half-open with the probe slot taken): shed load
            # without touching the queue; tell the client when the
            # breaker could next admit it
            if self.metrics is not None:
                self.metrics.inc("rejected")
            raise Backpressure(
                max(self.breaker.retry_after_s(), self.retry_after_s),
                reason="circuit breaker open (device failing)",
            )
        req = _Request(np.ascontiguousarray(x, dtype=np.uint8), trace, tenant)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            if self.breaker is not None:
                # a half-open allow() claimed the probe slot for a
                # request that never made it in — release it
                self.breaker.cancel_probe()
            if self.metrics is not None:
                self.metrics.inc("rejected")
            raise Backpressure(self.retry_after_s) from None
        if self._stopped:
            # raced stop(): the worker may already be gone, so nothing
            # would drain this request — fail it here (done.set is
            # idempotent; if the worker did take it, its result stands)
            self._fail_queued()
        if self.metrics is not None:
            self.metrics.inc("requests")
            self.metrics.inc("windows", len(req.x))
        return PredictFuture(req, self.metrics)

    def predict(
        self, x: np.ndarray, timeout: Optional[float] = None, trace=None
    ) -> np.ndarray:
        """submit + result in one call (the HTTP handler's path)."""
        return self.submit(x, trace=trace).result(timeout)

    def snapshot(self) -> dict:
        """The ``GET /tracez`` scheduler block, deadline-mode edition:
        whole requests queue here, so the view is just depth + steps
        (the continuous scheduler reports the richer slot-pool state)."""
        return {
            "mode": self.BATCHING_MODE,
            "queue_depth": self._q.qsize(),
            "steps": self._steps,
            "ladder": list(self.session.ladder),
        }

    # -- worker side --------------------------------------------------------

    def _gather(self, first: _Request) -> List[_Request]:
        """Coalesce queued requests behind ``first`` until the top rung
        fills or the deadline expires. Factored from the loop so tests
        can drive it synchronously.

        Two phases, so batching survives backlog: already-queued
        requests coalesce unconditionally (their age is irrelevant —
        under load, when the previous dispatch outlived the deadline,
        the backlog must still form full batches or device throughput
        collapses to one padded request per dispatch); the deadline
        only bounds how long a PARTIAL batch waits for NEW arrivals,
        measured from ``first``'s submit so a lone request's latency
        stays <= max_delay_ms."""
        batch = [first]
        total = len(first.x)
        top = self.session.ladder[-1]
        deadline = first.t_submit + self.max_delay_s
        while total < top:
            try:  # phase 1: drain the existing backlog, no waiting
                req = self._q.get_nowait()
            except queue.Empty:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:  # phase 2: wait out the deadline for new arrivals
                    req = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
            if req is None:  # shutdown sentinel
                self._repost_sentinel()  # for the outer loop
                break
            batch.append(req)
            total += len(req.x)
        return batch

    def _repost_sentinel(self) -> None:
        # never a blocking put: on a full queue it would deadlock the
        # only consumer; the outer loop's _running check (0.1 s poll)
        # ends the worker even when the sentinel is lost
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass

    def _dispatch(self, batch: List[_Request]) -> None:
        """Predict one coalesced batch and scatter results back."""
        sizes = [len(r.x) for r in batch]
        total = sum(sizes)
        now = time.perf_counter()
        for r in batch:
            # queue-wait: submit until this dispatch formed (the
            # deadline coalescer packs a whole request at once)
            wait = now - r.t_submit
            if r.trace is not None:
                r.trace.add("queue_wait", wait)
            if self.metrics is not None:
                self.metrics.hist_queue_wait.observe(wait)
        try:
            t_pack = time.perf_counter()
            x = (
                batch[0].x
                if len(batch) == 1
                else np.concatenate([r.x for r in batch])
            )
            t_dev = time.perf_counter()
            preds = self.session.predict(x)
        except BaseException as e:  # propagate to every waiter
            if self.breaker is not None:
                if isinstance(e, _REQUEST_ERRORS):
                    # request-shaped failure proves nothing about the
                    # device; a half-open probe it rode must be released
                    self.breaker.cancel_probe()
                else:
                    # device-shaped failure (HangError, a CUDA error,
                    # ...): one step toward tripping the breaker
                    self.breaker.record_failure()
            for r in batch:
                r.error = e
                r.done.set()
            # errors_total is counted per failed REQUEST where the
            # exception resurfaces (PredictFuture.result -> the HTTP
            # 500 handler) — counting the shared batch failure here too
            # would inflate the series by 1 per coalesced batch
            return
        if self.breaker is not None:
            self.breaker.record_success()
        dt_dev = time.perf_counter() - t_dev
        self._steps += 1
        if self.metrics is not None:
            self.metrics.hist_device.observe(dt_dev)
        padded = max(1, self.session.padded_size(total))
        dp = getattr(self.session, "dp", 1)
        off = 0
        for r, n in zip(batch, sizes):
            if r.trace is not None:
                r.trace.add("pack", t_dev - t_pack)
                r.trace.add_step(
                    dt_dev, rung=padded, step=self._steps,
                    occupancy=total / padded, dp=dp, windows=n,
                )
            r.preds = preds[off : off + n]
            off += n
            r.done.set()
        if self.metrics is not None:
            self.metrics.inc("batches")
            self.metrics.observe_fill(total, padded)

    def _loop(self) -> None:
        while self._running:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            self._dispatch(self._gather(first))
        # drain: fail any stragglers loudly rather than hanging clients
        self._fail_queued()
