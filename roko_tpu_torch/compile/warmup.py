"""Ladder warmup: make every rung hot, at once or one by one (the port's
copy of ``roko_tpu/compile/warmup.py``).

Callers hand :func:`warmup_ladder` a ``compile_rung(rung)`` callable — in
the port a rung's first forward through the ``PolishSession`` — and get a
:class:`WarmupReport` with the wall and per-rung seconds and the kernel
build cache's hit/miss delta, which ``/metrics`` renders. The kernels a
session needs are built before the rungs run (``kernels.build`` starts
one nvcc per source, all together), so a rung's warmup is its forward.

A rung failure (a :class:`~roko_tpu_torch.resilience.HangError` from the
guarded dispatch included) cancels the rest and re-raises: a half-warm
service must fail its start loudly."""

from __future__ import annotations

import os
import time
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

from roko_tpu_torch.compile.cache import cache_counters

Log = Callable[[str], None]


@dataclass
class WarmupReport:
    """What a ladder warmup cost and where the kernels came from."""

    seconds: float = 0.0
    mode: str = "serial"  # "serial" | "parallel" | "aot"
    per_rung_s: Dict[int, float] = field(default_factory=dict)
    #: kernel build cache deltas across the warmup window
    cache_hits: int = 0
    cache_misses: int = 0

    def as_dict(self) -> Dict[str, object]:
        return {
            "seconds": round(self.seconds, 3),
            "mode": self.mode,
            "per_rung_s": {str(r): round(s, 3) for r, s in sorted(self.per_rung_s.items())},
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
        }


def warmup_ladder(
    rungs: Sequence[int],
    compile_rung: Callable[[int], object],
    *,
    parallel: bool = True,
    max_workers: int = 0,
    mode: Optional[str] = None,
    log: Optional[Log] = None,
    counters: Callable[[], tuple] = cache_counters,
) -> WarmupReport:
    """Call ``compile_rung`` for every rung — on threads at once when
    ``parallel`` (and more than one rung), in order otherwise.
    ``max_workers`` 0 = one per rung, capped at the host's cores (at
    least 2). ``counters`` gives the (hits, misses) to report deltas of."""
    rungs = list(rungs)
    hits0, misses0 = counters()
    t0 = time.perf_counter()
    report = WarmupReport(mode=mode or ("parallel" if parallel else "serial"))

    def one(rung: int) -> None:
        t_r = time.perf_counter()
        compile_rung(rung)
        report.per_rung_s[rung] = time.perf_counter() - t_r

    if parallel and len(rungs) > 1:
        workers = max_workers or min(len(rungs), max(os.cpu_count() or 1, 2))
        workers = max(1, min(workers, len(rungs)))
        with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="roko-warmup") as pool:
            futs = {pool.submit(one, r): r for r in rungs}
            done, not_done = wait(futs, return_when=FIRST_EXCEPTION)
            failed = [f for f in done if f.exception() is not None]
            if failed:
                for f in not_done:
                    f.cancel()
                raise failed[0].exception()
    else:
        if mode is None and len(rungs) <= 1:
            report.mode = "serial"
        for r in rungs:
            one(r)

    hits1, misses1 = counters()
    report.seconds = time.perf_counter() - t0
    report.cache_hits = hits1 - hits0
    report.cache_misses = misses1 - misses0
    if log is not None:
        log(f"warmup: {len(rungs)} rung(s) ready in {report.seconds:.1f}s "
            f"({report.mode}; cache hits={report.cache_hits} misses={report.cache_misses})")
    return report
