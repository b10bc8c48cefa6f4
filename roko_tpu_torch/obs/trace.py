"""Request-scoped tracing: where did this request spend its time (the
port's copy of ``roko_tpu/obs/trace.py``).

Every ``POST /polish`` gets a ``request_id`` — minted by the server, or
honoured from an ``X-Roko-Request-Id`` header — and a
:class:`RequestTrace` that rides the request through the batching plane
collecting named spans:

- ``queue_wait`` — submit until the first window packs into a device
  step;
- ``pack``       — slab copies building each packed step;
- ``device``     — the predict dispatch itself, one span per device
  step the request's windows rode, annotated with the rung, a global
  step id, the packed occupancy and the session's dp width;
- ``scatter``    — predictions scattering back per segment;
- ``stitch``     — the vote-board stitch in the HTTP handler.

The reply carries the breakdown as a ``timings`` field (span sums +
per-step detail), and the completed trace lands in the process-wide
:class:`TraceRing` — a bounded last-N plus a slowest-N board — served
by ``GET /tracez`` next to a live scheduler snapshot. Tracing is always
on: a few ``perf_counter`` calls and dict appends per request, and the
ring is bounded by construction.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional


def new_request_id() -> str:
    """16 hex chars — unique enough for a trace ring and an event log,
    short enough to read in one."""
    return uuid.uuid4().hex[:16]


class RequestTrace:
    """Span accounting for ONE request. Thread-safe: the HTTP handler,
    the scheduler thread, and the device dispatch all add spans."""

    __slots__ = (
        "request_id", "windows", "worker_id", "t_wall", "_t0",
        "_spans", "_steps", "total_s", "_lock", "tenant", "model",
    )

    def __init__(
        self,
        request_id: Optional[str] = None,
        *,
        windows: int = 0,
        worker_id: Optional[int] = None,
        tenant: Optional[str] = None,
        model: Optional[str] = None,
    ):
        self.request_id = request_id or new_request_id()
        self.windows = windows
        self.worker_id = worker_id
        #: multi-tenant/model-lane identity (set by the HTTP handler;
        #: None renders nothing — single-tenant traces are unchanged)
        self.tenant = tenant
        self.model = model
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        #: span name -> [seconds, count]
        self._spans: Dict[str, List[float]] = {}
        #: per-device-step annotations (rung, step id, occupancy, dp)
        self._steps: List[Dict[str, Any]] = []
        self.total_s: Optional[float] = None
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            acc = self._spans.get(name)
            if acc is None:
                self._spans[name] = [seconds, 1]
            else:
                acc[0] += seconds
                acc[1] += 1

    def add_step(
        self, seconds: float, *, rung: int, step: int,
        occupancy: float, dp: int, windows: int,
    ) -> None:
        """One device step this request's windows rode (a request may
        span many steps under continuous batching)."""
        self.add("device", seconds)
        with self._lock:
            if len(self._steps) < 64:  # bounded even for huge requests
                self._steps.append({
                    "step": step,
                    "rung": rung,
                    "windows": windows,
                    "occupancy": round(occupancy, 4),
                    "dp": dp,
                    "seconds": round(seconds, 6),
                })

    def finish(self) -> float:
        """Close the trace (idempotent); returns total wall seconds."""
        if self.total_s is None:
            self.total_s = time.perf_counter() - self._t0
        return self.total_s

    def spans(self) -> Dict[str, float]:
        with self._lock:
            return {k: round(v[0], 6) for k, v in self._spans.items()}

    def timings(self) -> Dict[str, Any]:
        """The reply's ``timings`` field: total, per-span seconds, and
        the device-step detail. Span seconds sum to ~the total for an
        uncontended request."""
        total = self.finish()
        return {
            "request_id": self.request_id,
            "total_s": round(total, 6),
            "spans": self.spans(),
            "device_steps": list(self._steps),
        }

    def to_dict(self) -> Dict[str, Any]:
        """The /tracez record (timings plus identity)."""
        out = self.timings()
        out["windows"] = self.windows
        out["ts"] = round(self.t_wall, 3)
        if self.worker_id is not None:
            out["worker_id"] = self.worker_id
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.model is not None:
            out["model"] = self.model
        return out


class TraceRing:
    """Bounded retention of completed traces: the last N in arrival
    order plus a slowest-N leaderboard — O(last_n + slowest_n) memory
    forever, whatever the traffic (tests pin boundedness under
    sustained load)."""

    def __init__(self, last_n: int = 256, slowest_n: int = 32):
        self.last_n = max(1, int(last_n))
        self.slowest_n = max(1, int(slowest_n))
        self._lock = threading.Lock()
        self._last: List[Dict[str, Any]] = []
        self._slowest: List[Dict[str, Any]] = []
        self._seen = 0

    def record(self, trace: RequestTrace) -> None:
        rec = trace.to_dict()
        with self._lock:
            self._seen += 1
            self._last.append(rec)
            if len(self._last) > self.last_n:
                del self._last[: len(self._last) - self.last_n]
            total = rec.get("total_s") or 0.0
            if (
                len(self._slowest) >= self.slowest_n
                and total <= (self._slowest[-1].get("total_s") or 0.0)
            ):
                return  # can't place on the full board: skip the sort
            self._slowest.append(rec)
            self._slowest.sort(key=lambda r: -(r.get("total_s") or 0.0))
            del self._slowest[self.slowest_n:]

    def snapshot(
        self, last: Optional[int] = None, slowest: Optional[int] = None
    ) -> Dict[str, Any]:
        with self._lock:
            return {
                "seen": self._seen,
                "last": list(self._last[-(last or self.last_n):]),
                "slowest": list(self._slowest[: (slowest or self.slowest_n)]),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._last)
