"""Named wall-clock spans for host-side stage attribution (the port's
copy of ``roko_tpu/utils/profiling.py::StageTimer``). The JAX
package's ``device_trace`` wraps ``jax.profiler`` and is not ported:
the port traces the card with ``torch.profiler`` where it needs to."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterator, Optional


class StageTimer:
    """Accumulates wall-clock time per named stage.

    With ``max_samples > 0`` the last N span durations per stage are
    additionally retained (bounded deque, so a long-lived service can't
    grow without bound) and :meth:`percentile` answers latency-quantile
    queries — the serving layer's ``/metrics`` p50/p99 rows are built on
    this (docs/SERVING.md).

    >>> timer = StageTimer()
    >>> with timer("extract"):
    ...     do_work()
    >>> timer.report(print)
    """

    def __init__(self, max_samples: int = 0) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.max_samples = max_samples
        self.samples: Dict[str, deque] = {}
        # the serving path records from every HTTP handler thread
        # concurrently; the += read-modify-writes would lose updates
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0)

    def record(self, stage: str, seconds: float) -> None:
        """Account one span measured by the caller (threads that time a
        request across a queue hand-off can't hold a context manager
        open on both sides)."""
        with self._lock:
            self.totals[stage] += seconds
            self.counts[stage] += 1
            if self.max_samples:
                window = self.samples.get(stage)
                if window is None:
                    window = self.samples[stage] = deque(
                        maxlen=self.max_samples
                    )
                window.append(seconds)

    def percentile(self, stage: str, q: float) -> Optional[float]:
        """q-th percentile (0..100) over the retained window of ``stage``
        spans; None when no samples were retained."""
        with self._lock:
            window = self.samples.get(stage)
            if not window:
                return None
            ordered = sorted(window)
        # nearest-rank on the retained window: exact for the sizes a
        # metrics endpoint serves, no numpy dependency in the hot path
        rank = max(0, min(len(ordered) - 1, round(q / 100 * (len(ordered) - 1))))
        return ordered[int(rank)]

    def report(self, log: Callable[[str], None] = print) -> None:
        if not self.totals:
            return
        width = max(len(s) for s in self.totals)
        total = sum(self.totals.values())
        for stage, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            log(
                f"  {stage:<{width}}  {t:8.2f}s  {100 * t / max(total, 1e-9):5.1f}%"
                f"  ({self.counts[stage]} spans)"
            )
