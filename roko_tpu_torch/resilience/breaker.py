"""Circuit breaker of the serving plane (the port's copy of
``roko_tpu/resilience/breaker.py``).

A card that starts failing every dispatch (a wedged launch, an
out-of-memory loop) must not keep eating whole request timeouts per
client: after ``failure_threshold`` CONSECUTIVE device failures the
breaker trips open — ``/polish`` sheds load at once with 503 +
``Retry-After`` and ``/healthz`` goes unhealthy so a load balancer stops
routing here. After ``reset_s`` the breaker goes half-open and admits
exactly ONE probe request; a success re-closes it, a failure re-opens it
for another ``reset_s``.

Only *device* failures count: request-shaped errors (a client's bad
window geometry raises ``ValueError``) say nothing about the device and
never move the breaker — the batchers classify at the dispatch site
(``serve/batcher.py``, ``serve/scheduler.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        reset_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.trip_count = 0

    # -- observation --------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._observe_locked()

    def state_code(self) -> int:
        """0 closed / 1 half-open / 2 open (the /metrics gauge)."""
        return _STATE_CODES[self.state]

    def retry_after_s(self) -> float:
        """Seconds a rejected client should wait before the breaker
        could admit it (0 when not open)."""
        with self._lock:
            if self._observe_locked() != OPEN:
                return 0.0
            return max(0.0, self.reset_s - (self._clock() - self._opened_at))

    def _observe_locked(self) -> str:
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.reset_s
        ):
            self._state = HALF_OPEN
            self._probe_inflight = False
        return self._state

    # -- admission ----------------------------------------------------------

    def allow(self) -> bool:
        """May a request proceed right now? In half-open this CLAIMS the
        single probe slot — a caller that then fails to enqueue the
        request must call :meth:`cancel_probe` or the slot leaks."""
        with self._lock:
            state = self._observe_locked()
            if state == CLOSED:
                return True
            if state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def cancel_probe(self) -> None:
        """Release a probe slot claimed by :meth:`allow` when the probe
        request never reached the device (e.g. the queue was full)."""
        with self._lock:
            self._probe_inflight = False

    # -- outcomes -----------------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_inflight = False
            self._state = CLOSED

    def record_failure(self) -> None:
        with self._lock:
            state = self._observe_locked()
            self._consecutive += 1
            if state == HALF_OPEN or (
                state == CLOSED and self._consecutive >= self.failure_threshold
            ):
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_inflight = False
                self._consecutive = 0
                self.trip_count += 1
