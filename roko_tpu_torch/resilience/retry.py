"""One bounded-retry policy (copy of ``roko_tpu/resilience/retry.py``):
an attempt budget, exponential backoff with jitter, a retryable-exception
allowlist, and an optional per-failure delay floor for protocols that name
their own minimum wait. The region fan-out re-runs failed jobs through it.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

OnRetry = Callable[[int, BaseException, float], None]


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` TOTAL attempts (1 = no retries). Delay before
    retry k (1-based) is ``base_delay_s * multiplier**(k-1)`` capped at
    ``max_delay_s``, floored by the failure's own demanded wait when a
    ``retry_after`` extractor is given, plus up to ``jitter`` fraction
    of uniform noise. Exceptions outside ``retryable`` propagate
    immediately."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1
    retryable: Tuple[Type[BaseException], ...] = (Exception,)

    def delay_for(
        self,
        attempt: int,
        floor_s: float = 0.0,
        rng: Optional[random.Random] = None,
    ) -> float:
        """Backoff delay after failure number ``attempt`` (1-based)."""
        d = min(
            self.max_delay_s,
            self.base_delay_s * self.multiplier ** max(0, attempt - 1),
        )
        d = max(d, floor_s)  # a server-demanded wait is a floor, not a cap
        if self.jitter > 0:
            d += d * self.jitter * (rng or random).random()
        return d

    def call(
        self,
        fn: Callable[[], object],
        *,
        on_retry: Optional[OnRetry] = None,
        retry_after: Optional[Callable[[BaseException], Optional[float]]] = None,
        sleep: Callable[[float], None] = time.sleep,
        giveup: Optional[Callable[[BaseException], bool]] = None,
    ) -> object:
        """Run ``fn`` with this policy. ``on_retry(failures, exc,
        delay)`` fires before each retry; ``retry_after(exc)`` may
        return a protocol-demanded minimum delay for that failure.
        ``giveup(exc)`` returning True propagates that failure
        immediately even when its type is retryable — for protocol
        states where retrying is actively wrong (a draining fleet asks
        callers to PARK work, not hammer the budget against it)."""
        failures = 0
        while True:
            try:
                return fn()
            except self.retryable as e:
                if giveup is not None and giveup(e):
                    raise
                failures += 1
                if failures >= self.max_attempts:
                    raise
                floor = (retry_after(e) if retry_after else None) or 0.0
                delay = self.delay_for(failures, floor_s=floor)
                if on_retry is not None:
                    on_retry(failures, e, delay)
                if delay > 0:
                    sleep(delay)
