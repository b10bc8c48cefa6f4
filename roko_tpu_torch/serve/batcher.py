"""Request types of the batching plane (the port's copy of the part of
``roko_tpu/serve/batcher.py`` that the continuous batcher uses):
:class:`Backpressure` and :class:`PredictFuture`. The deadline batcher
(``MicroBatcher``), the tenant quota error and the Retry-After hint wait
for the HTTP service (queue item A9.4)."""

from __future__ import annotations

from typing import Optional

import numpy as np


class Backpressure(Exception):
    """Request rejected without touching the device: the request pool is
    full."""


class PredictFuture:
    """Handle for one submitted request."""

    def __init__(self, req):
        self._req = req

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
        return self._req.preds
