"""Confidence calibration for the cascade's cheap tier (the port's copy
of ``roko_tpu/cascade/calibration.py``, numpy only; its numbers are the
reference's bit for bit).

Raw softmax confidences are systematically over- or under-confident;
routing on them makes the escalation threshold meaningless across model
kinds and coverage levels. The standard fix is temperature scaling
(Guo et al.): divide the logits by one scalar ``T`` fitted to minimize
NLL on held-out data, which preserves the argmax (tier-1 predictions
never change) while making "0.95 confident" mean roughly 95% accurate.

Two confidence functions are supported:

- ``max_softmax`` — max of the temperature-scaled softmax;
- ``margin`` — the two-class softmax of the top-2 logits, i.e.
  ``sigmoid((top1 - top2) / T)``; less sensitive to the tail classes.

A *window's* confidence is the MIN over its columns: one uncertain
base escalates the whole window, because the escalated tier re-predicts
whole windows (the batcher's unit of work) and a window is only as
correct as its weakest column.

The threshold rule is pinned at both ends (the byte-identity gate
depends on it): escalate iff ``confidence <= 1 - threshold``.
``threshold=0`` escalates EVERYTHING — even a saturated confidence of
exactly 1.0 (hence the non-strict comparison) — so the cascade output
is byte-identical to the plain session path; ``threshold=1`` escalates
nothing (softmax confidence is strictly positive).

The fitted artifact persists as JSON beside the checkpoint manifest
and records the params digest it was fitted against; loading it next
to different params refuses (:class:`~roko_tpu_torch.cascade.cache.CascadeMismatch`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

#: supported confidence functions (CascadeConfig.method values)
METHODS = ("max_softmax", "margin")

#: artifact filename, placed beside the checkpoint/bundle manifest
CALIBRATION_FILE = "cascade_calibration.json"


def calibration_path_for(checkpoint_path: str) -> str:
    """The calibration artifact's canonical home: beside the checkpoint
    (or bundle manifest) it was fitted for. A file path gets its
    directory taken; a directory is used as-is."""
    base = checkpoint_path
    if os.path.splitext(base)[1] or os.path.isfile(base):
        base = os.path.dirname(base) or "."
    return os.path.join(base, CALIBRATION_FILE)


def _scaled_log_softmax(logits: np.ndarray, temperature: float) -> np.ndarray:
    z = np.asarray(logits, dtype=np.float64) / float(temperature)
    z = z - z.max(axis=-1, keepdims=True)
    return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))


def nll(logits: np.ndarray, labels: np.ndarray, temperature: float) -> float:
    """Mean negative log-likelihood of ``labels`` under temperature-scaled
    softmax — the objective temperature fitting minimizes."""
    logits = np.asarray(logits, dtype=np.float64).reshape(-1, np.shape(logits)[-1])
    labels = np.asarray(labels).reshape(-1)
    if logits.shape[0] == 0:
        raise ValueError("cannot evaluate NLL on zero examples")
    logp = _scaled_log_softmax(logits, temperature)
    return float(-logp[np.arange(len(labels)), labels].mean())


def fit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    *,
    lo: float = 0.05,
    hi: float = 20.0,
    iters: int = 80,
) -> float:
    """Fit the temperature minimizing held-out NLL by golden-section
    search over ``log T`` (the NLL is unimodal in T for fixed logits).
    Deterministic, numpy-only; ~80 iterations pins T to ~1e-9 relative."""
    a, b = np.log(lo), np.log(hi)
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc = nll(logits, labels, float(np.exp(c)))
    fd = nll(logits, labels, float(np.exp(d)))
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = nll(logits, labels, float(np.exp(c)))
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = nll(logits, labels, float(np.exp(d)))
    return float(np.exp((a + b) / 2.0))


def confidence_scores(
    logits: np.ndarray, method: str = "max_softmax", temperature: float = 1.0
) -> np.ndarray:
    """Per-position confidence in (0, 1] from raw logits (any leading
    shape; the last axis is classes). ``method`` is one of
    :data:`METHODS`."""
    if method not in METHODS:
        raise ValueError(f"unknown confidence method {method!r}; want one of {METHODS}")
    if float(temperature) <= 0:
        raise ValueError(f"temperature must be positive, got {temperature}")
    logits = np.asarray(logits, dtype=np.float64)
    if method == "max_softmax":
        logp = _scaled_log_softmax(logits, temperature)
        return np.exp(logp.max(axis=-1))
    # margin: two-class softmax of the top-2 logits = sigmoid(gap / T)
    part = np.partition(logits, -2, axis=-1)
    gap = (part[..., -1] - part[..., -2]) / float(temperature)
    return 1.0 / (1.0 + np.exp(-gap))


def window_confidence(
    logits: np.ndarray, method: str = "max_softmax", temperature: float = 1.0
) -> np.ndarray:
    """Reduce ``logits[n, cols, classes]`` to one confidence per window:
    the MIN over columns (the weakest base gates the window)."""
    conf = confidence_scores(logits, method, temperature)
    if conf.ndim == 1:  # already per-window
        return conf
    return conf.min(axis=tuple(range(1, conf.ndim)))


def escalate_mask(confidence: np.ndarray, threshold: float) -> np.ndarray:
    """True where the window must escalate to the reference tier.

    Pinned endpoints: ``threshold=0`` -> all True (non-strict compare,
    so even confidence exactly 1.0 escalates — the byte-identity gate);
    ``threshold=1`` -> all False (softmax confidence is > 0)."""
    t = float(threshold)
    if not 0.0 <= t <= 1.0:
        raise ValueError(f"threshold must lie in [0, 1], got {threshold}")
    return np.asarray(confidence, dtype=np.float64) <= (1.0 - t)


@dataclass(frozen=True)
class Calibration:
    """The persisted calibration artifact: one temperature, the method
    it was fitted for, and the identity of the params it calibrates."""

    temperature: float = 1.0
    method: str = "max_softmax"
    #: digest of the params the calibration was fitted against; loading
    #: beside different params refuses (identity discipline)
    params_digest: Optional[str] = None
    #: held-out examples the fit saw (documentation, not identity)
    fitted_on: int = 0
    #: NLL before/after — the artifact carries its own receipts
    nll_before: Optional[float] = None
    nll_after: Optional[float] = None

    def confidence(self, logits: np.ndarray) -> np.ndarray:
        return window_confidence(logits, self.method, self.temperature)

    def to_json(self) -> dict:
        return {
            "temperature": self.temperature,
            "method": self.method,
            "params_digest": self.params_digest,
            "fitted_on": self.fitted_on,
            "nll_before": self.nll_before,
            "nll_after": self.nll_after,
        }

    def save(self, path: str) -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)  # atomic: readers never see a torn file
        return path

    @classmethod
    def load(
        cls, path: str, *, expect_params_digest: Optional[str] = None
    ) -> "Calibration":
        with open(path) as f:
            raw = json.load(f)
        cal = cls(
            temperature=float(raw.get("temperature", 1.0)),
            method=str(raw.get("method", "max_softmax")),
            params_digest=raw.get("params_digest"),
            fitted_on=int(raw.get("fitted_on", 0)),
            nll_before=raw.get("nll_before"),
            nll_after=raw.get("nll_after"),
        )
        if cal.method not in METHODS:
            raise ValueError(
                f"calibration {path}: unknown method {cal.method!r}"
            )
        if cal.temperature <= 0:
            raise ValueError(
                f"calibration {path}: non-positive temperature {cal.temperature}"
            )
        if (
            expect_params_digest is not None
            and cal.params_digest is not None
            and cal.params_digest != expect_params_digest
        ):
            from roko_tpu_torch.cascade.cache import CascadeMismatch

            raise CascadeMismatch(
                "calibration/params drift", path,
                {"params_digest": (cal.params_digest, expect_params_digest)},
            )
        return cal


def fit_calibration(
    logits: np.ndarray,
    labels: np.ndarray,
    *,
    method: str = "max_softmax",
    params_digest: Optional[str] = None,
) -> Calibration:
    """Fit a :class:`Calibration` on held-out (logits, labels)."""
    if method not in METHODS:
        raise ValueError(f"unknown confidence method {method!r}; want one of {METHODS}")
    t = fit_temperature(logits, labels)
    flat = np.asarray(labels).reshape(-1)
    return Calibration(
        temperature=t,
        method=method,
        params_digest=params_digest,
        fitted_on=int(flat.size),
        nll_before=nll(logits, labels, 1.0),
        nll_after=nll(logits, labels, t),
    )
