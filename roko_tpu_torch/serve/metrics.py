"""Counters of the batching plane (the part of
``roko_tpu/serve/metrics.py::ServeMetrics`` that the streaming polish
reads).

The :class:`ContinuousBatcher` counts requests, windows, device steps
(``batches``) and rejections, and the real windows and padded rows it
dispatched, whose ratio is the run's ``padding_efficiency``. The
Prometheus rendering, the latency histograms, the queue and tenant
gauges and the XLA compile-cache counters wait for the HTTP service
(queue items A9.4 and A11).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

_COUNTERS = ("requests", "windows", "batches", "rejected")


class ServeMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {name: 0 for name in _COUNTERS}
        #: windows actually dispatched / padded rows dispatched
        self._fill_windows = 0
        self._fill_padded = 0

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] += by

    def observe_fill(self, windows: int, padded: int) -> None:
        with self._lock:
            self._fill_windows += windows
            self._fill_padded += padded

    def fill_ratio(self) -> Optional[float]:
        """Real windows over padded rows dispatched (None before the
        first step): the ``padding_efficiency`` the stream reports."""
        with self._lock:
            if not self._fill_padded:
                return None
            return self._fill_windows / self._fill_padded

    def fill_totals(self) -> Tuple[int, int]:
        """(real windows, padded rows) dispatched so far."""
        with self._lock:
            return self._fill_windows, self._fill_padded
