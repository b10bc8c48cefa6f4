"""The cascade's tier router (the port's copy of
``roko_tpu/cascade/router.py``).

Tier 1 is CHEAP; tier 2 is the model behind whatever predict machinery
the caller already runs (``ContinuousBatcher.submit`` in the service and
the streaming polish, the predict step in ``run_inference``). The router:

1. looks every window up in the content-addressed cache;
2. runs the remaining windows through tier 1 (``majority``: the pileup
   majority vote as count-logits, numpy on the host; ``model``: a named
   registry version, the port's ``RokoModel`` on the session's device,
   so its kernels run), reduces the calibrated confidence per window,
   and keeps the confident ones;
3. escalates the rest as ONE second submit to tier 2 and scatters the
   results back by index.

The router is built against one params digest and quantize mode: its
cache keys embed them, its calibration must match them, and a
``model``-tier registry entry is re-verified on resolve; any drift
refuses with :class:`~roko_tpu_torch.cascade.cache.CascadeMismatch`
before a window is served. Imports no torch until the model tier is
built.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from roko_tpu_torch import constants as C
from roko_tpu_torch.cascade.cache import (
    CascadeMismatch,
    DiskWindowCache,
    WindowCache,
    cache_identity,
    window_key,
)
from roko_tpu_torch.cascade.calibration import Calibration, escalate_mask

#: tier-1 kinds CascadeConfig.tier may name
TIERS = ("majority", "model")

#: default temperature for the majority tier when no fitted calibration
#: artifact is supplied. Raw vote COUNTS are wildly overconfident at
#: T=1 — softmax of a 12-vs-8 split is e^4/(e^4+1) ~ 0.98 even though
#: a 60/40 vote is nowhere near 98% right — so an unscaled majority
#: tier keeps systematically-wrong homopolymer columns and fails the
#: Q-parity gate. Dividing by ~the per-class count scale spreads the
#: scores back over (0, 1); 8.0 holds held-out Q AT the reference on
#: the sim gate at the default threshold (escalating ~16%). A fitted
#: ``cascade_calibration.json`` overrides this.
MAJORITY_TEMPERATURE = 8.0


def majority_logits(x: np.ndarray) -> np.ndarray:
    """Count-logits of the pileup majority vote: fold the strand offset
    (feature code % STRAND_OFFSET), count votes per base class down the
    read axis, and return ``float32[n, cols, NUM_CLASSES]`` counts.
    ``ENCODED_UNKNOWN`` rows contribute nothing. Softmaxing counts
    (temperature-scaled) gives a natural confidence: a 30/0 column is
    near-certain, a 16/14 split is not."""
    x = np.asarray(x)
    folded = (x % C.STRAND_OFFSET).astype(np.int64)
    # one bincount per class beats a (n*rows*cols) scatter for the small
    # fixed class count
    counts = np.empty(x.shape[:1] + x.shape[2:] + (C.NUM_CLASSES,), np.float32)
    for cls in range(C.NUM_CLASSES):
        counts[..., cls] = (folded == cls).sum(axis=1)
    return counts


class CascadeFuture:
    """Future over one routed batch, interface-compatible with
    :class:`roko_tpu_torch.serve.batcher.PredictFuture` (``done()`` /
    ``result(timeout)``), so the streaming polish drain loop treats a
    cascaded submit exactly like a plain one."""

    def __init__(
        self,
        preds: np.ndarray,
        esc_idx: np.ndarray,
        inner,
        on_escalated: Optional[Callable[[np.ndarray], None]] = None,
    ):
        self._preds = preds
        self._esc_idx = esc_idx
        self._inner = inner
        self._on_escalated = on_escalated
        self._resolved = inner is None

    def done(self) -> bool:
        return self._resolved or self._inner.done()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._resolved:
            sub = self._inner.result(timeout)  # raises TimeoutError as-is
            self._preds[self._esc_idx] = np.asarray(sub, dtype=np.int32)
            if self._on_escalated is not None:
                self._on_escalated(self._preds)
            self._resolved = True
        return self._preds


class CascadeRouter:
    """Routes window batches through cache -> tier 1 -> escalation."""

    def __init__(
        self,
        *,
        tier: str = "majority",
        threshold: float = 0.05,
        calibration: Optional[Calibration] = None,
        params_digest: str,
        quantize: Optional[str] = None,
        tier_version: Optional[str] = None,
        tier_logits_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        cache_bytes: int = 0,
        cache_dir: Optional[str] = None,
        metrics=None,
    ):
        if tier not in TIERS:
            raise ValueError(f"unknown cascade tier {tier!r}; want one of {TIERS}")
        if not 0.0 <= float(threshold) <= 1.0:
            raise ValueError(f"cascade threshold must lie in [0, 1], got {threshold}")
        self.tier = tier
        self.threshold = float(threshold)
        self.calibration = calibration or Calibration()
        self.params_digest = str(params_digest)
        self.quantize = quantize
        self.tier_version = tier_version
        self._tier_logits = (
            tier_logits_fn if tier_logits_fn is not None else majority_logits
        )
        self.metrics = metrics
        self._lock = threading.Lock()
        self.identity = cache_identity(
            params_digest=self.params_digest,
            quantize=self.quantize,
            tier=self.tier,
            threshold=self.threshold,
            method=self.calibration.method,
            temperature=self.calibration.temperature,
            tier_version=self.tier_version,
        )
        self.cache = WindowCache(cache_bytes) if cache_bytes > 0 else None
        self.disk = (
            DiskWindowCache(cache_dir, self.identity) if cache_dir else None
        )
        # counters (stats() and /metrics read these)
        self.windows = 0
        self.escalated = 0
        self.cache_hits = 0
        self.tier1_seconds = 0.0
        self.tier2_seconds = 0.0

    # -- identity ------------------------------------------------------------

    def check_identity(
        self, *, params_digest: Optional[str] = None, quantize: Optional[str] = None
    ) -> None:
        """Refuse escalation across drifted identity: the tier-2 params
        this router scatters into must be the ones it was built for."""
        diff: Dict[str, Any] = {}
        if params_digest is not None and params_digest != self.params_digest:
            diff["params_digest"] = (self.params_digest, params_digest)
        if quantize is not None and (quantize or "none") != (self.quantize or "none"):
            diff["quantize"] = (self.quantize or "none", quantize or "none")
        if diff:
            raise CascadeMismatch("tier router", "<escalation>", diff)

    def with_threshold(self, threshold: float) -> "CascadeRouter":
        """A same-identity router at a different threshold (the /polish
        per-request override). Tier fn, calibration, and metrics are
        shared; the cache is NOT — a different threshold is a different
        decision identity, so its keyspace is disjoint by construction —
        and the disk sidecar stays with the server default (an override
        must not open an identity-pinned sidecar it mismatches). Clones
        are memoized per threshold so repeated overrides stay cheap."""
        t = float(threshold)
        with self._lock:
            clones = self.__dict__.setdefault("_clones", {})
            got = clones.get(t)
            if got is None:
                got = CascadeRouter(
                    tier=self.tier,
                    threshold=t,
                    calibration=self.calibration,
                    params_digest=self.params_digest,
                    quantize=self.quantize,
                    tier_version=self.tier_version,
                    tier_logits_fn=self._tier_logits,
                    cache_bytes=self.cache.max_bytes if self.cache else 0,
                    cache_dir=None,
                    metrics=self.metrics,
                )
                clones[t] = got
        return got

    # -- the decision --------------------------------------------------------

    def _decide(self, x: np.ndarray):
        """Cache + tier-1 pass over one batch. Returns
        ``(preds[n, cols] int32, esc_idx int64[], keys_to_store)`` —
        ``preds`` rows at ``esc_idx`` are tier-1 placeholders awaiting
        the escalated results."""
        x = np.ascontiguousarray(x, dtype=np.uint8)
        n = len(x)
        cols = x.shape[2] if x.ndim == 3 else 0
        preds = np.empty((n, cols), np.int32)
        need = []  # indices not answered by the cache
        keys = [None] * n
        cache_hits = 0
        if self.cache is not None or self.disk is not None:
            for i in range(n):
                key = window_key(x[i].tobytes(), self.identity)
                keys[i] = key
                got = self.cache.get(key) if self.cache is not None else None
                if got is None and self.disk is not None:
                    got = self.disk.get(key)
                    if got is not None and got.shape == (cols,) and self.cache is not None:
                        self.cache.put(key, got)
                if got is not None and got.shape == (cols,):
                    preds[i] = got
                    cache_hits += 1
                else:
                    need.append(i)
        else:
            need = list(range(n))

        esc_local = np.empty(0, np.int64)
        t0 = time.perf_counter()
        if need:
            idx = np.asarray(need, dtype=np.int64)
            logits = self._tier_logits(x[idx])
            preds[idx] = np.argmax(logits, axis=-1).astype(np.int32)
            conf = self.calibration.confidence(logits)
            esc_local = idx[escalate_mask(conf, self.threshold)]
        dt = time.perf_counter() - t0

        with self._lock:
            self.windows += n
            self.escalated += int(len(esc_local))
            self.cache_hits += cache_hits
            self.tier1_seconds += dt
        if self.metrics is not None:
            self.metrics.observe_cascade(
                windows=n, escalated=int(len(esc_local)),
                cache_hits=cache_hits, tier1_seconds=dt,
            )
        # kept tier-1 windows are cacheable now; escalated ones after
        # their reference preds land (the future's callback)
        esc_set = set(esc_local.tolist())
        store_now = [
            (keys[i], preds[i]) for i in need
            if keys[i] is not None and i not in esc_set
        ]
        esc_keys = [keys[i] for i in esc_local.tolist()]
        self._store(store_now)
        return preds, esc_local, esc_keys

    def _store(self, pairs) -> None:
        for key, row in pairs:
            if key is None:
                continue
            if self.cache is not None:
                self.cache.put(key, row)
            if self.disk is not None:
                self.disk.put(key, row)

    def _escalated_callback(self, esc_idx, esc_keys, t_submit):
        def _cb(preds: np.ndarray) -> None:
            dt = time.perf_counter() - t_submit
            with self._lock:
                self.tier2_seconds += dt
            if self.metrics is not None:
                self.metrics.observe_cascade(tier2_seconds=dt)
            self._store(
                [(k, preds[i]) for k, i in zip(esc_keys, esc_idx.tolist())]
            )
        return _cb

    # -- entry points --------------------------------------------------------

    def submit(self, x: np.ndarray, submit_fn, trace=None) -> CascadeFuture:
        """Route one batch; ``submit_fn(x_subset, trace=...) -> future``
        is the reference tier (e.g. ``batcher.submit``). Returns a
        future resolving to the full batch's preds."""
        t0 = time.perf_counter()
        preds, esc_idx, esc_keys = self._decide(x)
        if trace is not None:
            trace.add("tier1", time.perf_counter() - t0)
        if len(esc_idx) == 0:
            return CascadeFuture(preds, esc_idx, None)
        inner = submit_fn(np.ascontiguousarray(x)[esc_idx], trace=trace)
        return CascadeFuture(
            preds, esc_idx, inner,
            self._escalated_callback(esc_idx, esc_keys, time.perf_counter()),
        )

    def predict(
        self, x: np.ndarray, submit_fn, timeout: Optional[float] = None, trace=None
    ) -> np.ndarray:
        """submit + result in one call (the HTTP handler's path)."""
        return self.submit(x, submit_fn, trace=trace).result(timeout)

    def route(
        self, x: np.ndarray, predict_fn: Callable[[np.ndarray], np.ndarray],
    ) -> np.ndarray:
        """Synchronous routing for the batch path (``run_inference``):
        ``predict_fn(x_subset) -> preds`` is the reference tier."""
        preds, esc_idx, esc_keys = self._decide(x)
        if len(esc_idx):
            t0 = time.perf_counter()
            sub = np.asarray(
                predict_fn(np.ascontiguousarray(x)[esc_idx]), dtype=np.int32
            )
            preds[esc_idx] = sub
            self._escalated_callback(esc_idx, esc_keys, t0)(preds)
        return preds

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "tier": self.tier,
                "threshold": self.threshold,
                "windows": self.windows,
                "escalated": self.escalated,
                "escalation_fraction": (
                    self.escalated / self.windows if self.windows else 0.0
                ),
                "cache_hits": self.cache_hits,
                "cache_hit_rate": (
                    self.cache_hits / self.windows if self.windows else 0.0
                ),
                "tier1_seconds": self.tier1_seconds,
                "tier2_seconds": self.tier2_seconds,
            }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        if self.disk is not None:
            out["disk"] = self.disk.stats()
        return out


def _tier_model_config(entry: Dict[str, Any]):
    """The tier model's ``ModelConfig``: the one its registry entry pins
    (a port bundle's identity holds the whole resolved config, so a tier
    model may differ from tier 2 in kind, widths and dtype)."""
    import dataclasses

    from roko_tpu_torch.config import ModelConfig

    known = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if k == "read_mlp" else v
                          for k, v in (entry.get("model") or {}).items() if k in known})


def check_tier_kernels(tier_cfg, bundle_dir: Optional[str], device) -> None:
    """Refuse, at start, a tier model whose kernels the loaded (or
    configured) kernel bundle lacks, naming the library: a process that
    loads a bundle never builds a kernel with nvcc, and the tier model
    shares the process's one bundle or build directory with tier 2."""
    if getattr(device, "type", str(device)) != "cuda":
        return
    from roko_tpu_torch import kernels

    want = kernels.inference_kernels(tier_cfg)
    have = None
    where = bundle_dir or kernels._bundle_dir
    if bundle_dir:
        from roko_tpu_torch.compile.bundle import read_manifest

        have = set(read_manifest(bundle_dir).get("libraries", {}))
    elif kernels._bundle_dir is not None:
        have = set(kernels._bundle_paths)
    if have is None:
        kernels.build(want)  # the tier-2 model's build directory
        return
    missing = [k for k in want if k not in have]
    if missing:
        raise RuntimeError(
            f"kernel bundle {where!r} carries no library for {missing}, which the "
            f"cascade's tier model ({tier_cfg.kind}, {tier_cfg.compute_dtype}) launches; a "
            "process that loaded a bundle never builds a kernel with nvcc (export one "
            "bundle whose libraries cover both models)")


def _model_tier_logits(cascade_cfg, cfg, registry_dir, device):
    """Build the ``model`` tier: resolve the named registry version
    (digest-verified), load its params, quantize them as its config asks,
    and return a logits fn that runs the port's ``RokoModel`` in eval
    mode on ``device`` (the session's), so its kernels run there."""
    import torch

    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.models.convert import load_model_params
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.models.quant import maybe_quantize
    from roko_tpu_torch.serve.registry import resolve_model, resolve_registry_dir

    name = cascade_cfg.tier_version
    if not name:
        raise ValueError("cascade tier 'model' needs tier_version (a registry name)")
    entry = resolve_model(resolve_registry_dir(registry_dir), name, verify=True)
    if not entry.get("params_path"):
        raise CascadeMismatch(
            "tier model", name, {"params_path": ("<absent>", "<required>")}
        )
    dev = resolve_device(device)
    tier_cfg = _tier_model_config(entry)
    check_tier_kernels(tier_cfg, cfg.compile.bundle_dir, dev)
    model = RokoModel(tier_cfg)
    model.load_state_dict(load_model_params(entry["params_path"]), strict=True)
    model = maybe_quantize(model).to(dev).eval()

    def fn(x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        with torch.inference_mode():
            return model(xt).float().cpu().numpy()

    return fn


def build_router(
    cfg,
    *,
    params,
    metrics=None,
    registry_dir: Optional[str] = None,
    device,
) -> "CascadeRouter":
    """Construct the router from ``cfg.cascade`` against tier 2's
    ``params`` (its state_dict after quantization, or the model itself:
    exactly what tier 2 predicts with). ``device`` is where a ``model``
    tier runs (the session's)."""
    from roko_tpu_torch.cascade.cache import params_digest as _digest

    ccfg = cfg.cascade
    digest = _digest(params)
    calibration = None
    if ccfg.calibration_path:
        calibration = Calibration.load(
            ccfg.calibration_path, expect_params_digest=digest
        )
    if calibration is None:
        calibration = Calibration(
            method=ccfg.method,
            temperature=MAJORITY_TEMPERATURE if ccfg.tier == "majority" else 1.0,
        )
    elif calibration.method != ccfg.method and ccfg.method:
        # the config's method wins over the artifact's
        calibration = Calibration(
            temperature=calibration.temperature,
            method=ccfg.method,
            params_digest=calibration.params_digest,
            fitted_on=calibration.fitted_on,
        )
    tier_fn = None
    if ccfg.tier == "model":
        tier_fn = _model_tier_logits(
            ccfg, cfg, registry_dir or cfg.fleet.registry_dir, device)
    return CascadeRouter(
        tier=ccfg.tier,
        threshold=ccfg.threshold,
        calibration=calibration,
        params_digest=digest,
        quantize=cfg.model.quantize,
        tier_version=ccfg.tier_version,
        tier_logits_fn=tier_fn,
        cache_bytes=ccfg.cache_bytes,
        cache_dir=ccfg.cache_dir,
        metrics=metrics,
    )
