"""Named wall-clock spans for host-side stage attribution (the port's
copy of ``roko_tpu/utils/profiling.py::StageTimer``), and the device
trace behind ``--trace-dir``: :func:`device_trace` and :func:`annotate`,
the ``torch.profiler`` counterparts of the JAX package's
``jax.profiler`` ones (:98-136), and the server's on-demand trace behind
``POST /profilez`` (:func:`capture_device_trace`). ``torch`` is imported
inside them, so the host side imports this module without it."""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], device=None) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` into a Chrome trace JSON
    under ``trace_dir`` (made if missing); a no-op for None. Host activity
    always; on a CUDA ``device`` (None: the card when one is present) the
    card's activity too, and a trace that recorded no device event raises:
    a host-only trace would pass for one of the card."""
    if trace_dir is None:
        yield
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_type = (torch.device(device).type if device is not None
                else "cuda" if torch.cuda.is_available() else "cpu")
    activities = [ProfilerActivity.CPU]
    if dev_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if dev_type == "cuda":
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"roko_trace.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if dev_type == "cuda" and not any(e.device_type == DeviceType.CUDA for e in prof.events()):
        raise RuntimeError(f"the trace {path} holds no device events: torch.profiler "
                           "recorded no CUDA activity on the card")


def capture_device_trace(trace_dir: str, seconds: float, device=None) -> str:
    """Hold ``torch.profiler`` open for ``seconds`` of wall time and write
    its Chrome trace JSON into ``trace_dir``: the live-service half of
    :func:`device_trace` (``roko_tpu/utils/profiling.py:109``). It traces
    whatever the process runs in the window, the card's kernels included
    on a CUDA ``device`` (None: the card when one is present), whichever
    thread launched them. A window with no device work is no error: the
    service may have been idle. Returns the trace file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev_type = (torch.device(device).type if device is not None
                else "cuda" if torch.cuda.is_available() else "cpu")
    activities = [ProfilerActivity.CPU]
    if dev_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        time.sleep(max(0.0, seconds))
        if dev_type == "cuda":
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"roko_profilez.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def annotate(name: str):
    """A named range in the device trace (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    return record_function(name)
