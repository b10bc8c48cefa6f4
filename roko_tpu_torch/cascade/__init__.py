"""Adaptive compute: confidence cascade + content-addressed window cache
(the port's copy of ``roko_tpu/cascade/``).

Most pileup windows in a high-coverage genome are easy — the draft
already matches consensus — yet the plain session pays the full
reference-GRU price for every one. This package routes each window
through a cheap tier first (the pileup majority vote, or a named
registry model), keeps the windows whose *calibrated* confidence clears
a threshold, and escalates only the uncertain rest to the reference
model as a second batcher submit. A content-addressed cache (key =
window bytes + params digest + quantize mode) sits in front of tier 1
so a whole-genome distpolish job pays for each distinct window once
across the fleet.

Identity discipline mirrors the bundle/registry/journal refusals: a
cache or calibration artifact fitted against different params digests,
quantize modes, or registry versions refuses loudly
(:class:`CascadeMismatch`) instead of silently serving drift.

The calibration and the cache are numpy only; the router imports torch
only when it builds a ``model`` tier.
"""

from roko_tpu_torch.cascade.cache import (
    CascadeMismatch,
    DiskWindowCache,
    WindowCache,
    cache_identity,
    params_digest,
    window_key,
)
from roko_tpu_torch.cascade.calibration import (
    Calibration,
    calibration_path_for,
    confidence_scores,
    escalate_mask,
    fit_calibration,
    fit_temperature,
)
from roko_tpu_torch.cascade.router import (
    MAJORITY_TEMPERATURE,
    CascadeFuture,
    CascadeRouter,
    build_router,
)

__all__ = [
    "Calibration",
    "MAJORITY_TEMPERATURE",
    "CascadeFuture",
    "CascadeMismatch",
    "CascadeRouter",
    "DiskWindowCache",
    "WindowCache",
    "build_router",
    "cache_identity",
    "calibration_path_for",
    "confidence_scores",
    "escalate_mask",
    "fit_calibration",
    "fit_temperature",
    "params_digest",
    "window_key",
]
