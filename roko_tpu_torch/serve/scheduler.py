"""Continuous batching: device batch shape decoupled from request
boundaries (the port's copy of ``roko_tpu/serve/scheduler.py``; its
single-tenant plans and packing are the reference's line for line, since
the streaming polish's byte identity with the staged one rests on them).

:class:`ContinuousBatcher` treats the session's ladder rungs as a
rolling pool of WINDOW SLOTS, packs windows from many requests densely
into each device step, and slots newly arrived requests into freed
capacity the moment earlier requests' windows complete.

Scheduling policy, applied each cycle over the queued-window backlog:

1. **full top rung** — backlog >= the top rung dispatches a completely
   full top-rung batch (the steady-state path; zero padding);
2. **exact/near fit** — otherwise the backlog pads to the smallest rung
   that fits, but ONLY when it fills at least ``rung_upgrade_fill`` of
   it (rung-upgrade hysteresis — padding efficiency over batch size);
3. **full smaller rung** — else, if a smaller rung can be filled
   COMPLETELY, dispatch that and leave the remainder queued (its age
   keeps counting);
4. **age flush** — else wait for arrivals until the oldest queued window
   is ``max_queue_age_ms`` old, then dispatch padded.

Slots inside a step are granted by deficit-weighted round-robin over
TENANTS (``ServeConfig.tenants``, weight 1 for unlisted ones) and fair
share over each tenant's requests in arrival order, so a small request
entering while a huge one is mid-flight packs into the very next step,
and a huge one still progresses every step. With one tenant this is the
plain fair share over requests. A tenant past its queue or in-flight
quota gets :class:`QuotaExceeded` (429).

:class:`RaggedBatcher` (``batching == "ragged"``) rides the same pool
and packing, but every step runs the session's one top-rung ragged step
(``PolishSession.predict_ragged``) with the packed row count, and its
plan is policy steps 1 and 4 only.

All padded dispatches go through ``PolishSession.predict``, so only
ladder shapes reach the device. A full request pool raises
:class:`Backpressure` with a Retry-After computed from the live backlog
and the observed windows/s; the circuit breaker sheds load while the
device fails.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np

from roko_tpu_torch.config import DEFAULT_TENANT, TenantConfig
from roko_tpu_torch.resilience import CircuitBreaker
from roko_tpu_torch.serve.batcher import (
    _REQUEST_ERRORS,
    Backpressure,
    PredictFuture,
    QuotaExceeded,
)
from roko_tpu_torch.serve.metrics import ServeMetrics

if TYPE_CHECKING:  # the session imports torch; the batchers are host code
    from roko_tpu_torch.serve.session import PolishSession

#: Retry-After clamp for the computed hint: never promise a sub-100 ms
#: poll loop, never more than the breaker-reset order of magnitude
_RETRY_AFTER_MIN_S = 0.1
_RETRY_AFTER_MAX_S = 30.0

#: EMA decay for the observed dispatch throughput (windows/sec) behind
#: the Retry-After estimate — a few dispatches of history, quick to
#: track load shifts
_THROUGHPUT_BETA = 0.7


class _Slot:
    """One submitted request riding the slot pool: its windows, the
    incrementally filled prediction buffer, and pack/fill cursors.
    ``next`` advances as windows are packed into device steps (may take
    many steps); ``filled`` as their predictions scatter back. The
    future resolves when every window is filled."""

    __slots__ = (
        "x", "preds", "next", "filled", "done", "error", "t_submit",
        "trace", "tenant",
    )

    def __init__(self, x: np.ndarray, trace=None, tenant: str = DEFAULT_TENANT):
        self.x = x
        self.preds = np.empty((x.shape[0], x.shape[2]), np.int32)
        self.next = 0       # windows handed to a device step so far
        self.filled = 0     # windows whose predictions are back
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        #: optional per-request obs.trace.RequestTrace (queue-wait /
        #: pack / device-step / scatter spans)
        self.trace = trace
        #: tenant id for deficit-round-robin slot granting + quotas
        self.tenant = tenant

    @property
    def n(self) -> int:
        return self.x.shape[0]


#: a planned device step: (slot, request-window offset, count, batch
#: offset) spans — the per-request segment/index vector of one packed
#: batch
Span = Tuple[_Slot, int, int, int]


class ContinuousBatcher:
    """Drop-in alternative to :class:`~roko_tpu_torch.serve.batcher.
    MicroBatcher` (same ``submit``/``predict``/``stop`` surface, same
    :class:`Backpressure`/:class:`PredictFuture` types) scheduling at
    WINDOW granularity instead of request granularity."""

    #: policy name reported in /healthz (``ServeConfig.batching`` value
    #: that selects this class in ``make_server``)
    BATCHING_MODE = "continuous"

    def __init__(
        self,
        session: PolishSession,
        *,
        max_queue: Optional[int] = None,
        max_queue_age_ms: Optional[float] = None,
        rung_upgrade_fill: Optional[float] = None,
        retry_after_s: Optional[float] = None,
        metrics: Optional[ServeMetrics] = None,
        breaker: Optional[CircuitBreaker] = None,
        tenants: Optional[Tuple[TenantConfig, ...]] = None,
        start: bool = True,
    ):
        serve_cfg = session.cfg.serve
        self.session = session
        self.breaker = breaker
        self.metrics = metrics
        self.max_queue = serve_cfg.max_queue if max_queue is None else max_queue
        self.max_queue_age_s = (
            serve_cfg.max_queue_age_ms
            if max_queue_age_ms is None
            else max_queue_age_ms
        ) / 1e3
        self.rung_upgrade_fill = (
            serve_cfg.rung_upgrade_fill
            if rung_upgrade_fill is None
            else rung_upgrade_fill
        )
        #: static floor for the Retry-After hint, used verbatim until the
        #: first dispatch teaches the scheduler its throughput
        self.base_retry_after_s = (
            serve_cfg.retry_after_s if retry_after_s is None else retry_after_s
        )
        #: requests with windows not yet packed into a device step,
        #: arrival order (the admission bound counts THESE — a fully
        #: packed request occupies device steps, not queue capacity)
        self._pool: List[_Slot] = []
        self._cv = threading.Condition()
        self._running = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        #: reusable top-rung slot slab: spans copy into it densely each
        #: step, so steady state allocates nothing per dispatch
        self._slab: Optional[np.ndarray] = None
        #: device steps dispatched so far (trace step ids) and the
        #: bounded rung history the /tracez scheduler snapshot serves
        self._steps = 0
        self._rung_history: deque = deque(maxlen=64)
        #: live requests (submitted, not yet complete) keyed by id() —
        #: the /tracez in-flight segment view; removal on completion,
        #: error, and stop keeps it bounded
        self._live: Dict[int, _Slot] = {}
        # derived from config, not the session's private attribute, so
        # session stand-ins (tests, tools) need only carry a cfg
        w = session.cfg.model
        self._window_shape = getattr(
            session, "_window_shape", (w.window_rows, w.window_cols)
        )
        self._ema_wps: Optional[float] = None
        #: tenant fair-share state: the config table (unlisted tenants default
        #: to weight 1, no caps), the DRR credit counters the slot-grant
        #: loop spends, and a per-tenant drain-rate EMA feeding the
        #: per-tenant Retry-After hint
        table = serve_cfg.tenants if tenants is None else tenants
        self._tenant_cfg: Dict[str, TenantConfig] = {
            t.name: t for t in table
        }
        self._deficit: Dict[str, float] = {}
        self._tenant_wps: Dict[str, float] = {}
        if metrics is not None:
            metrics.queue_depth = lambda: len(self._pool)
            metrics.queue_windows = self.backlog_windows
            metrics.occupancy = self.occupancy
            metrics.tenant_backlogs = self.tenant_backlogs
        if start:
            self.start()

    # -- observation ---------------------------------------------------------

    def backlog_windows(self) -> int:
        """Windows queued but not yet packed into a device step."""
        with self._cv:
            return sum(s.n - s.next for s in self._pool)

    def occupancy(self) -> float:
        """Queued-window backlog as a fraction of one top-rung step —
        instantaneous demand vs one step of device capacity (the
        ``roko_serve_scheduler_occupancy`` gauge; >1 means the next
        step is already oversubscribed)."""
        return self.backlog_windows() / self.session.ladder[-1]

    def tenant_backlogs(self) -> Dict[str, int]:
        """Queued-not-yet-packed windows per tenant — the healthz
        ``tenants`` block and the ``roko_serve_tenant_backlog`` gauge
        (the per-tenant Retry-After is derived from these)."""
        out: Dict[str, int] = {}
        with self._cv:
            for s in self._pool:
                out[s.tenant] = out.get(s.tenant, 0) + (s.n - s.next)
        return out

    def _tenant_weight(self, tenant: str) -> float:
        cfg = self._tenant_cfg.get(tenant)
        return cfg.weight if cfg is not None else 1.0

    def snapshot(self) -> Dict[str, Any]:
        """The live scheduler state ``GET /tracez`` serves beside the
        trace ring: queued-window backlog,
        in-flight request segments (windows packed vs filled per live
        request), the observed throughput EMA, and the bounded
        rung-dispatch history."""
        with self._cv:
            live = list(self._live.values())
            backlog = sum(s.n - s.next for s in self._pool)
            history = list(self._rung_history)
            ema = self._ema_wps
            steps = self._steps
            tenant_backlog: Dict[str, int] = {}
            tenant_inflight: Dict[str, int] = {}
            for s in self._pool:
                tenant_backlog[s.tenant] = (
                    tenant_backlog.get(s.tenant, 0) + (s.n - s.next)
                )
            for s in self._live.values():
                tenant_inflight[s.tenant] = (
                    tenant_inflight.get(s.tenant, 0) + 1
                )
            tenants = {
                t: {
                    "backlog_windows": tenant_backlog.get(t, 0),
                    "inflight": tenant_inflight.get(t, 0),
                    "deficit": round(self._deficit.get(t, 0.0), 4),
                    "weight": self._tenant_weight(t),
                    "ema_windows_per_s": (
                        round(self._tenant_wps[t], 2)
                        if t in self._tenant_wps else None
                    ),
                }
                for t in sorted(
                    set(tenant_backlog) | set(tenant_inflight)
                    | set(self._deficit)
                )
            }
        return {
            "mode": self.BATCHING_MODE,
            "backlog_windows": backlog,
            "occupancy": round(backlog / self.session.ladder[-1], 4),
            "steps": steps,
            "ema_windows_per_s": round(ema, 2) if ema else None,
            "ladder": list(self.session.ladder),
            "in_flight": [
                {
                    "request_id": (
                        s.trace.request_id if s.trace is not None else None
                    ),
                    "windows": s.n,
                    "packed": s.next,
                    "filled": s.filled,
                    "age_s": round(time.perf_counter() - s.t_submit, 4),
                }
                for s in live
            ],
            "tenants": tenants,
            "rung_history": history,
        }

    @property
    def retry_after_s(self) -> float:
        """Live Retry-After hint: the queued backlog divided by the
        observed dispatch throughput (EMA windows/sec), clamped — a
        rejected client is told when capacity will actually free up,
        not the deadline batcher's fixed 1 s queue-drain guess. Before
        any dispatch has calibrated the throughput, the configured
        static value is all there is."""
        with self._cv:
            backlog = sum(s.n - s.next for s in self._pool)
            wps = self._ema_wps
        if not wps or wps <= 0:
            return self.base_retry_after_s
        # +1 top rung: even an empty queue waits out the step in flight
        est = (backlog + self.session.ladder[-1]) / wps
        return min(_RETRY_AFTER_MAX_S, max(_RETRY_AFTER_MIN_S, est))

    def tenant_retry_after_s(self, tenant: Optional[str] = None) -> float:
        """Retry-After from ONE tenant's backlog and ITS observed drain
        rate: an interactive tenant rejected while a
        bulk tenant holds the global queue is told its own short wait,
        not the bulk tenant's. Falls back to the global hint when the
        tenant has no drain history yet."""
        if not tenant:
            return self.retry_after_s
        with self._cv:
            backlog = sum(
                s.n - s.next for s in self._pool if s.tenant == tenant
            )
            wps = self._tenant_wps.get(tenant)
            active = {s.tenant for s in self._pool} | {tenant}
        if not wps or wps <= 0:
            return self.retry_after_s
        # the tenant's fair slice of the step in flight stands in for
        # the global hint's +1 top rung
        wsum = sum(self._tenant_weight(t) for t in active)
        slice_ = self.session.ladder[-1] * self._tenant_weight(tenant) / wsum
        est = (backlog + slice_) / wps
        return min(_RETRY_AFTER_MAX_S, max(_RETRY_AFTER_MIN_S, est))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="roko-continuous-batcher", daemon=True
        )
        self._thread.start()

    def scheduler_alive(self) -> bool:
        """True while the scheduling thread can still complete futures —
        callers that block on a future without their own deadline (the
        streaming polish pipeline) poll this instead of guessing a
        wall-clock bound for work whose step count they cannot know."""
        thread = self._thread
        return bool(thread is not None and thread.is_alive())

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the scheduler: the worker finishes the device step in
        flight (its windows scatter back), then every request that is
        not yet complete — queued OR mid-flight across steps — fails
        loudly with "batcher stopped" instead of stranding its future.
        The server's graceful drain orders this AFTER the in-flight
        HTTP handlers finish, so a clean drain never hits the failure
        path."""
        with self._cv:
            self._stopped = True
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._fail_incomplete()

    def _fail_incomplete(self) -> None:
        with self._cv:
            pool, self._pool = self._pool, []
            live, self._live = list(self._live.values()), {}
        for slot in {id(s): s for s in pool + live}.values():
            if not slot.done.is_set():
                slot.error = RuntimeError("batcher stopped")
                slot.done.set()

    # -- client side ---------------------------------------------------------

    def submit(
        self, x: np.ndarray, trace=None, tenant: Optional[str] = None
    ) -> PredictFuture:
        """Admit one window batch into the slot pool; raises
        :class:`Backpressure` (with the computed Retry-After) when the
        pool is at capacity, :class:`QuotaExceeded` (mapped to 429)
        when the TENANT's own queue/inflight cap is hit, and
        ``ValueError`` on bad window geometry — validated HERE so a
        malformed request can never poison the shared device step it
        would have been packed into (the deadline batcher fails a whole
        coalesced batch on one bad member; dense packing must not)."""
        if self._stopped:
            raise RuntimeError("batcher stopped")
        x = np.ascontiguousarray(x, dtype=np.uint8)
        if x.ndim != 3 or x.shape[1:] != self._window_shape:
            raise ValueError(
                f"windows shaped {x.shape}, want (n,) + "
                f"{self._window_shape}"
            )
        tenant = tenant or DEFAULT_TENANT
        slot = _Slot(x, trace, tenant)
        if slot.n == 0:
            # nothing to schedule: complete immediately (the empty reply
            # is still well-formed). Decided BEFORE the breaker check —
            # a dispatch-free request must never claim (and then leak)
            # the breaker's single half-open probe slot.
            slot.done.set()
            if self.metrics is not None:
                self.metrics.inc("requests")
            return PredictFuture(slot, self.metrics)
        if self.breaker is not None and not self.breaker.allow():
            if self.metrics is not None:
                self.metrics.inc("rejected")
            raise Backpressure(
                max(self.breaker.retry_after_s(), self.base_retry_after_s),
                reason="circuit breaker open (device failing)",
            )
        with self._cv:
            if self._stopped:
                raise RuntimeError("batcher stopped")
            tcfg = self._tenant_cfg.get(tenant)
            if tcfg is not None and (tcfg.max_queue or tcfg.max_inflight):
                queued = sum(
                    s.n - s.next for s in self._pool if s.tenant == tenant
                )
                inflight = sum(
                    1 for s in self._live.values() if s.tenant == tenant
                )
                over = (
                    tcfg.max_queue and queued + slot.n > tcfg.max_queue
                ) or (tcfg.max_inflight and inflight >= tcfg.max_inflight)
                if over:
                    # the TENANT's quota said no, not global overload:
                    # 429 with the tenant's own drain estimate (other
                    # tenants' backlogs never inflate this hint)
                    if self.breaker is not None:
                        self.breaker.cancel_probe()
                    if self.metrics is not None:
                        self.metrics.inc("rejected")
                        self.metrics.inc_tenant_rejected(tenant)
                    raise QuotaExceeded(
                        self.tenant_retry_after_s(tenant),
                        tenant,
                        "queue quota exceeded"
                        if tcfg.max_queue
                        and queued + slot.n > tcfg.max_queue
                        else "inflight quota exceeded",
                    )
            if len(self._pool) >= self.max_queue:
                if self.breaker is not None:
                    # a half-open allow() claimed the probe slot for a
                    # request that never made it in — release it
                    self.breaker.cancel_probe()
                if self.metrics is not None:
                    self.metrics.inc("rejected")
                raise Backpressure(self.retry_after_s)
            self._pool.append(slot)
            self._live[id(slot)] = slot
            self._cv.notify()
        if self.metrics is not None:
            self.metrics.inc("requests")
            self.metrics.inc("windows", slot.n)
        return PredictFuture(slot, self.metrics)

    def predict(
        self, x: np.ndarray, timeout: Optional[float] = None, trace=None
    ) -> np.ndarray:
        """submit + result in one call (the HTTP handler's path)."""
        return self.submit(x, trace=trace).result(timeout)

    # -- scheduling ----------------------------------------------------------

    def _plan(self, now: float) -> Tuple[Optional[int], Optional[float]]:
        """Decide this cycle's dispatch size under the lock. Returns
        ``(k, wait)``: ``k`` windows to pack now (None = nothing yet),
        ``wait`` seconds to sleep for arrivals (None = until woken).
        Policy steps 1-4 of the module docstring."""
        pending = sum(s.n - s.next for s in self._pool)
        if pending == 0:
            return None, None
        ladder = self.session.ladder
        top = ladder[-1]
        if pending >= top:
            return top, None
        fit = self.session.rung_for(pending)
        if pending == fit or pending >= self.rung_upgrade_fill * fit:
            # exact fit, or close enough that upgrading to the larger
            # rung beats splitting (hysteresis knob)
            return pending, None
        full = max((r for r in ladder if r <= pending), default=None)
        if full is not None:
            # a completely full smaller rung: dispatch it, remainder
            # stays queued with its age intact
            return full, None
        oldest = min(s.t_submit for s in self._pool if s.next < s.n)
        age_left = self.max_queue_age_s - (now - oldest)
        if age_left <= 0:
            return pending, None  # age flush: pad rather than wait more
        return None, age_left

    def _take(self, k: int) -> List[Span]:
        """Pack ``k`` window slots from the pool under the lock —
        deficit-weighted round-robin over TENANTS (each round splits the
        remaining slots by tenant weight into credit; a tenant spends
        whole-window credit, fractions carry to the next round), and
        fair-share over each tenant's requests in arrival order inside
        its grant. Adjacent spans of one request merge. With a single
        tenant the credit split is the full remainder and the loop
        reduces exactly to the old per-request fair share. Exhausted
        requests leave the pool; they complete when their scattered
        predictions arrive. Tenants whose backlog drains forfeit
        residual credit — an idle tenant never hoards a burst."""
        spans: List[Span] = []
        off = 0
        now = time.perf_counter()

        def pack(slot: _Slot, take: int) -> None:
            nonlocal off
            if slot.next == 0:
                # first window of this request packs now: the
                # queue-wait span ends here (mergeable histogram +
                # the request's own trace)
                wait = now - slot.t_submit
                if slot.trace is not None:
                    slot.trace.add("queue_wait", wait)
                if self.metrics is not None:
                    self.metrics.hist_queue_wait.observe(wait)
            if spans and spans[-1][0] is slot and (
                spans[-1][1] + spans[-1][2] == slot.next
            ):
                prev = spans[-1]
                spans[-1] = (slot, prev[1], prev[2] + take, prev[3])
            else:
                spans.append((slot, slot.next, take, off))
            slot.next += take
            off += take

        while off < k:
            # group pending requests by tenant, both levels in arrival
            # order (first-seen tenant order is itself arrival order)
            order: List[str] = []
            by_tenant: Dict[str, List[_Slot]] = {}
            for s in self._pool:
                if s.next >= s.n:
                    continue
                if s.tenant not in by_tenant:
                    by_tenant[s.tenant] = []
                    order.append(s.tenant)
                by_tenant[s.tenant].append(s)
            if not order:
                break
            # split the remaining slots into per-tenant credit by
            # weight: total inflow == remaining capacity, so deficits
            # hover near zero under load instead of growing unboundedly
            remaining = k - off
            wsum = sum(self._tenant_weight(t) for t in order)
            for t in order:
                self._deficit[t] = (
                    self._deficit.get(t, 0.0)
                    + remaining * self._tenant_weight(t) / wsum
                )
            for t in order:
                budget = min(int(self._deficit[t]), k - off)
                granted = 0
                slots = by_tenant[t]
                # per-request fair share inside the tenant's grant
                while granted < budget:
                    t_live = [s for s in slots if s.next < s.n]
                    if not t_live:
                        break
                    share = max(1, (budget - granted) // len(t_live))
                    for slot in t_live:
                        take = min(
                            share, slot.n - slot.next, budget - granted
                        )
                        if take <= 0:
                            continue
                        pack(slot, take)
                        granted += take
                        if granted >= budget:
                            break
                self._deficit[t] -= granted
                if off >= k:
                    break
        self._pool = [s for s in self._pool if s.next < s.n]
        # drained tenants forfeit leftover credit (classic DRR reset)
        active = {s.tenant for s in self._pool}
        for t in list(self._deficit):
            if t not in active:
                self._deficit[t] = 0.0
        return spans

    def _predict_slab(self, total: int) -> np.ndarray:
        """Device step for ``total`` densely packed slab rows — the one
        seam :class:`RaggedBatcher` overrides (ladder-padded here,
        masked top-rung ragged there)."""
        return self.session.predict(self._slab[:total])

    def _device_slots(self, total: int) -> int:
        """Device slots the step actually paid for — denominates the
        batch-fill / padding-efficiency metrics (padded rung size here,
        dp-granular mask occupancy on the ragged path)."""
        return self.session.padded_size(total)

    def _dispatch(self, spans: List[Span]) -> None:
        """One packed device step: copy spans densely into the slot
        slab, predict (``PolishSession`` pads to the ladder — only
        ladder shapes reach the device), scatter predictions back
        per segment, and resolve every request whose last window just
        landed (freed capacity is re-packed next cycle)."""
        total = sum(c for _, _, c, _ in spans)
        if total == 0:
            return
        if self._slab is None:
            self._slab = np.empty(
                (self.session.ladder[-1],) + self._window_shape, np.uint8
            )
        t_pack = time.perf_counter()
        for slot, src, count, off in spans:
            self._slab[off : off + count] = slot.x[src : src + count]
        t0 = time.perf_counter()
        try:
            preds = self._predict_slab(total)
        except BaseException as e:
            if self.breaker is not None:
                if isinstance(e, _REQUEST_ERRORS):
                    # submit() validated geometry, so a request-shaped
                    # error here is session misuse, not device illness
                    self.breaker.cancel_probe()
                else:
                    self.breaker.record_failure()
            # fail every request with windows in this step (their other
            # windows may have completed in earlier steps; the error
            # wins) and drop their remainders from the pool
            failed = {id(s) for s, _, _, _ in spans}
            with self._cv:
                self._pool = [
                    s for s in self._pool if id(s) not in failed
                ]
                for sid in failed:
                    self._live.pop(sid, None)
            for slot, _, _, _ in spans:
                if not slot.done.is_set():
                    slot.error = e
                    slot.done.set()
            return
        dt = time.perf_counter() - t0
        if self.breaker is not None:
            self.breaker.record_success()
        rung = max(1, self._device_slots(total))
        dp = getattr(self.session, "dp", 1)
        self._steps += 1
        step_id = self._steps
        t_scatter = time.perf_counter()
        done_ids = []
        for slot, src, count, off in spans:
            slot.preds[src : src + count] = preds[off : off + count]
            slot.filled += count
            if slot.filled == slot.n:
                done_ids.append(id(slot))
        dt_scatter = time.perf_counter() - t_scatter
        # span accounting per UNIQUE slot: fair-share may pack one
        # request as several non-adjacent segments of this step, and
        # double-adding the step's duration would break the
        # span-sum~wall invariant the reply's timings promise
        per_slot: Dict[int, Tuple[_Slot, int]] = {}
        for slot, src, count, off in spans:
            if slot.trace is not None:
                prev = per_slot.get(id(slot))
                per_slot[id(slot)] = (
                    slot, count + (prev[1] if prev else 0)
                )
        for slot, count in per_slot.values():
            slot.trace.add("pack", t0 - t_pack)
            slot.trace.add_step(
                dt, rung=rung, step=step_id,
                occupancy=total / rung, dp=dp, windows=count,
            )
            slot.trace.add("scatter", dt_scatter)
        # done is set only AFTER the trace spans landed: a handler
        # reading timings() the instant result() wakes must see this
        # step, not race it
        for slot, _, _, _ in spans:
            if slot.filled == slot.n and not slot.done.is_set():
                slot.done.set()
        tenant_windows: Dict[str, int] = {}
        for slot, _, count, _ in spans:
            tenant_windows[slot.tenant] = (
                tenant_windows.get(slot.tenant, 0) + count
            )
        with self._cv:
            wps = total / max(dt, 1e-6)
            self._ema_wps = (
                wps
                if self._ema_wps is None
                else _THROUGHPUT_BETA * self._ema_wps
                + (1 - _THROUGHPUT_BETA) * wps
            )
            # per-tenant drain rate: the tenant's windows in THIS step
            # over the step time — what its Retry-After divides by
            for t, n in tenant_windows.items():
                t_wps = n / max(dt, 1e-6)
                prev = self._tenant_wps.get(t)
                self._tenant_wps[t] = (
                    t_wps
                    if prev is None
                    else _THROUGHPUT_BETA * prev
                    + (1 - _THROUGHPUT_BETA) * t_wps
                )
            for sid in done_ids:
                self._live.pop(sid, None)
            self._rung_history.append({
                "step": step_id,
                "rung": rung,
                "windows": total,
                "fill": round(total / rung, 4),
                "segments": len(spans),
                "device_s": round(dt, 6),
            })
        if self.metrics is not None:
            self.metrics.inc("batches")
            self.metrics.hist_device.observe(dt)
            self.metrics.observe_fill(total, rung)

    def _loop(self) -> None:
        while True:
            with self._cv:
                spans: Optional[List[Span]] = None
                while self._running:
                    k, wait = self._plan(time.perf_counter())
                    if k is not None:
                        spans = self._take(k)
                        break
                    self._cv.wait(wait)
                if spans is None:  # stopped
                    return
            self._dispatch(spans)


class RaggedBatcher(ContinuousBatcher):
    """Ragged packed dispatch (``ServeConfig.batching == "ragged"``,
    ``roko_tpu/serve/scheduler.py:747-791``): the same slot pool, fair-share
    packing, segment scatter, backpressure, and breaker plumbing as
    :class:`ContinuousBatcher`, but every device step runs the session's
    ONE top-rung ragged step with an explicit valid-row count
    instead of padding to a ladder rung.

    What that deletes from the scheduling policy: the padded path's
    steps 2-3 (rung-upgrade hysteresis and the full-smaller-rung
    split) exist only to trade padding waste against batch size — with
    a masked step there is no padded rung to waste, so
    ``rung_upgrade_fill`` is dead config on this path and ``_plan``
    reduces to *full top rung or age flush*. Occupancy accounting is
    dp-granular (``PolishSession.ragged_slots``): the shared
    ``padding_efficiency`` metric reads real windows / masked slots and
    sits at ~1.0 where the ladder path is rung-quantised to ~0.96."""

    BATCHING_MODE = "ragged"

    def _predict_slab(self, total: int) -> np.ndarray:
        # full slab, not a [:total] view: the shape is always the top
        # rung, and the device masks rows at/past `total` (stale slab
        # rows never reach the model)
        return self.session.predict_ragged(self._slab, total)

    def _device_slots(self, total: int) -> int:
        return self.session.ragged_slots(total)

    def _plan(self, now: float) -> Tuple[Optional[int], Optional[float]]:
        """Full top rung, else wait for arrivals until the oldest
        queued window hits ``max_queue_age_ms``, then dispatch exactly
        the pending count — the padded path's policy steps 1 and 4 with
        the padding-driven middle steps removed."""
        pending = sum(s.n - s.next for s in self._pool)
        if pending == 0:
            return None, None
        top = self.session.ladder[-1]
        if pending >= top:
            return top, None
        oldest = min(s.t_submit for s in self._pool if s.next < s.n)
        age_left = self.max_queue_age_s - (now - oldest)
        if age_left <= 0:
            return pending, None
        return None, age_left
