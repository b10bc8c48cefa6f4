"""Continuous batching: device batch shape decoupled from request
boundaries (the port's copy of the single-tenant planning and packing of
``roko_tpu/serve/scheduler.py::ContinuousBatcher``, line for line, since
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

Slots inside a step are granted by fair share over the requests in
arrival order, so a small request entering while a huge one is
mid-flight packs into the very next step, and a huge one still
progresses every step.

All dispatches go through ``PolishSession.predict``, so only ladder
shapes reach the device. A full request pool raises
:class:`Backpressure`. Left out of the port until a caller needs them
(the HTTP service, queue items A9.4 and A11): tenant weights and quotas,
the circuit breaker, Retry-After hints, the Prometheus gauges and the
ragged batcher (A9.2).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from roko_tpu_torch.serve.batcher import Backpressure, PredictFuture
from roko_tpu_torch.serve.metrics import ServeMetrics


class _Slot:
    """One submitted request riding the slot pool: its windows, the
    incrementally filled prediction buffer, and pack/fill cursors.
    ``next`` advances as windows are packed into device steps (may take
    many steps); ``filled`` as their predictions scatter back. The
    future resolves when every window is filled."""

    __slots__ = ("x", "preds", "next", "filled", "done", "error", "t_submit")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.preds = np.empty((x.shape[0], x.shape[2]), np.int32)
        self.next = 0       # windows handed to a device step so far
        self.filled = 0     # windows whose predictions are back
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()

    @property
    def n(self) -> int:
        return self.x.shape[0]


#: a planned device step: (slot, request-window offset, count, batch
#: offset) spans — the per-request segment/index vector of one packed
#: batch
Span = Tuple[_Slot, int, int, int]


class ContinuousBatcher:
    """Schedules a session's device steps at WINDOW granularity
    (``submit``/``stop``, :class:`Backpressure` and
    :class:`PredictFuture`). ``session`` is a :class:`PolishSession` or
    anything with its ``cfg``, ``ladder``, ``rung_for``, ``padded_size``
    and ``predict``. ``max_queue`` bounds the requests whose windows are
    not all packed yet; ``max_queue_age_ms`` is the age flush bound of
    policy step 4; ``rung_upgrade_fill`` comes from the session's
    ``cfg.serve``."""

    def __init__(
        self,
        session,
        *,
        max_queue: int,
        max_queue_age_ms: float,
        metrics: Optional[ServeMetrics] = None,
        start: bool = True,
    ):
        self.session = session
        self.metrics = metrics
        self.max_queue = max_queue
        self.max_queue_age_s = max_queue_age_ms / 1e3
        self.rung_upgrade_fill = session.cfg.serve.rung_upgrade_fill
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
        #: live requests (submitted, not yet complete) keyed by id();
        #: removal on completion, error, and stop keeps it bounded
        self._live: Dict[int, _Slot] = {}
        # derived from config, not the session's private attribute, so
        # session stand-ins (tests, tools) need only carry a cfg
        w = session.cfg.model
        self._window_shape = getattr(
            session, "_window_shape", (w.window_rows, w.window_cols)
        )
        if start:
            self.start()

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
        loudly with "batcher stopped" instead of stranding its future."""
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

    def submit(self, x: np.ndarray) -> PredictFuture:
        """Admit one window batch into the slot pool; raises
        :class:`Backpressure` when the pool is at capacity and
        ``ValueError`` on bad window geometry — validated HERE so a
        malformed request can never poison the shared device step it
        would have been packed into."""
        if self._stopped:
            raise RuntimeError("batcher stopped")
        x = np.ascontiguousarray(x, dtype=np.uint8)
        if x.ndim != 3 or x.shape[1:] != self._window_shape:
            raise ValueError(
                f"windows shaped {x.shape}, want (n,) + "
                f"{self._window_shape}"
            )
        slot = _Slot(x)
        if slot.n == 0:
            # nothing to schedule: complete immediately (the empty reply
            # is still well-formed)
            slot.done.set()
            if self.metrics is not None:
                self.metrics.inc("requests")
            return PredictFuture(slot)
        with self._cv:
            if self._stopped:
                raise RuntimeError("batcher stopped")
            if len(self._pool) >= self.max_queue:
                if self.metrics is not None:
                    self.metrics.inc("rejected")
                raise Backpressure("request queue full")
            self._pool.append(slot)
            self._live[id(slot)] = slot
            self._cv.notify()
        if self.metrics is not None:
            self.metrics.inc("requests")
            self.metrics.inc("windows", slot.n)
        return PredictFuture(slot)

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
        """Pack ``k`` window slots from the pool under the lock — fair
        share over the requests in arrival order, repeated until ``k``
        slots are packed or the pool is dry. Adjacent spans of one
        request merge. Exhausted requests leave the pool; they complete
        when their scattered predictions arrive."""
        spans: List[Span] = []
        off = 0
        while off < k:
            live = [s for s in self._pool if s.next < s.n]
            if not live:
                break
            share = max(1, (k - off) // len(live))
            for slot in live:
                take = min(share, slot.n - slot.next, k - off)
                if take <= 0:
                    continue
                if spans and spans[-1][0] is slot and (
                    spans[-1][1] + spans[-1][2] == slot.next
                ):
                    prev = spans[-1]
                    spans[-1] = (slot, prev[1], prev[2] + take, prev[3])
                else:
                    spans.append((slot, slot.next, take, off))
                slot.next += take
                off += take
                if off >= k:
                    break
        self._pool = [s for s in self._pool if s.next < s.n]
        return spans

    def _dispatch(self, spans: List[Span]) -> None:
        """One packed device step: copy spans densely into the slot
        slab, predict (``PolishSession`` pads to the ladder — only
        precompiled shapes reach the device), scatter predictions back
        per segment, and resolve every request whose last window just
        landed (freed capacity is re-packed next cycle)."""
        total = sum(c for _, _, c, _ in spans)
        if total == 0:
            return
        if self._slab is None:
            self._slab = np.empty(
                (self.session.ladder[-1],) + self._window_shape, np.uint8
            )
        for slot, src, count, off in spans:
            self._slab[off : off + count] = slot.x[src : src + count]
        try:
            preds = self.session.predict(self._slab[:total])
        except BaseException as e:
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
        rung = max(1, self.session.padded_size(total))
        done_ids = []
        for slot, src, count, off in spans:
            slot.preds[src : src + count] = preds[off : off + count]
            slot.filled += count
            if slot.filled == slot.n:
                done_ids.append(id(slot))
        for slot, _, _, _ in spans:
            if slot.filled == slot.n and not slot.done.is_set():
                slot.done.set()
        with self._cv:
            for sid in done_ids:
                self._live.pop(sid, None)
        if self.metrics is not None:
            self.metrics.inc("batches")
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
