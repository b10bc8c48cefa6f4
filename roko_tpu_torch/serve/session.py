"""Warm model session with a padded batch ladder (the port's counterpart
of ``roko_tpu/serve/session.py::PolishSession``).

A :class:`PolishSession` holds a :class:`RokoModel` on one device, in
``eval()``, and dispatches every request by padding it to the smallest
rung of a small ladder of batch sizes that fits (chunking oversized
requests at the top rung), so the kernels run at a few known shapes
whatever window counts requests arrive with. ``dispatched_shapes``
records every padded batch size that reached the device.

Each dispatch runs under the resilience watchdog (``call_with_deadline``)
with split budgets: the first dispatch of a rung gets
``compile_deadline_s`` (on the card that first call also builds the
recurrent kinds' kernels with nvcc), every later one ``predict_deadline_s``. A blown
deadline raises :class:`HangError`. The class ids come back to the host
synchronously.

The ragged step (``predict_ragged``, ``ServeConfig.batching ==
"ragged"``): one top-rung slab and a valid-row count; the rows at or past
the count are zeroed on the device before the same forward and argmax,
so its class ids are those of ``pad_windows`` of the first rows
(``roko_tpu/serve/session.py:334-415``). A ragged session warms the top
rung only.

Cold start (``cfg.compile``, ``compile/``): ``warmup`` first fixes the
process's kernel build cache and, when ``cfg.compile.bundle_dir`` names a
kernel bundle, loads it (:meth:`load_compiled`: a mismatch refuses with
``BundleMismatch``, and the bundle's libraries then load with no nvcc
run); otherwise it builds the kernels the model launches, one nvcc per
source, all at once. Then every rung runs once through the model, on
threads at once (``cfg.compile.parallel_warmup``) or one by one
(``compile.warmup_ladder``; ``warmup_report``: per-rung seconds, the
mode ``"aot"``, ``"parallel"`` or ``"serial"``, and the build cache's
hits and misses).

What the JAX package's session does and this one does not: shard over a
device mesh (one card here; a session over several ranks is queue item
A9.1), or fail over to the host CPU after a hang (not ported: carrying
on on the CPU after the card failed would hide the card's failure;
``failed_over`` is always False). The model runs in its resolved
``cfg.compute_dtype``; a config that asks for int8 quantizes it once,
when the session is built.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Hashable, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from roko_tpu_torch.compile.cache import cache_counters, enable_persistent_cache
from roko_tpu_torch.compile.warmup import WarmupReport, warmup_ladder
from roko_tpu_torch.config import RokoConfig, resolve_ladder, validate_ladder
from roko_tpu_torch.infer import (
    mask_rows,
    pad_windows,
    resolve_device,
    rung_for,
    use_float32_matmuls,
)
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.models.quant import maybe_quantize
from roko_tpu_torch.resilience import DeadlinePolicy, call_with_deadline


class PolishSession:
    """A model on its device + the padded batch ladder; thread-safe
    dispatch (``predict`` serialises device work with a lock)."""

    #: the dp extent: the port's session drives one device
    dp = 1

    def __init__(
        self,
        model: RokoModel,
        cfg: Optional[RokoConfig] = None,
        *,
        device: str | torch.device = "cuda",
        ladder: Optional[Sequence[int]] = None,
    ):
        self.cfg = cfg or RokoConfig(model=model.cfg)
        self.device = resolve_device(device)
        rungs = (
            resolve_ladder(self.cfg.serve, self.dp)
            if ladder is None
            else tuple(sorted(set(ladder)))
        )
        if not rungs:
            raise ValueError("ladder must name at least one batch size")
        validate_ladder(rungs, self.dp)
        self.ladder: Tuple[int, ...] = rungs
        # process-wide, so the batcher's thread sees it too
        use_float32_matmuls()
        # conversion-time int8 (models/quant.py): once, at session build;
        # every rung then runs in the model's resolved compute dtype
        self.model = maybe_quantize(model).to(self.device).eval()
        self._lock = threading.Lock()
        #: padded batch sizes that have reached the device — always a
        #: subset of ``ladder``
        self.dispatched_shapes: Set[int] = set()
        res = self.cfg.resilience
        self._deadlines = DeadlinePolicy(res.predict_deadline_s, res.compile_deadline_s)
        #: dispatch keys (padded rungs, ``("ragged", top)``) that have run
        self._ready: Set[Hashable] = set()
        #: a ragged session serves every step at the top rung
        self.ragged: bool = self.cfg.serve.batching == "ragged"
        #: filled by ``warmup``
        self.warmup_report: Optional[WarmupReport] = None
        w = model.cfg
        self._window_shape = (w.window_rows, w.window_cols)

    # -- readiness ------------------------------------------------------------

    def cache_size(self) -> int:
        """The dispatch shapes that have run at least once (the ``compiled``
        of ``/healthz``): the port builds its kernels once per process, so
        a rung is ready once its first dispatch returned."""
        with self._lock:
            return len(self._ready)

    def ready_executables(self) -> int:
        """The rungs warmed: every ladder rung, or the top one for a ragged
        session."""
        return self.cache_size()

    @property
    def failed_over(self) -> bool:
        """Always False: the port has no CPU fail-over after a hang (the
        ``cpu_fallback`` of ``/healthz`` and ``/metrics`` say so)."""
        return False

    def load_compiled(self, *, require_all: bool = True, log=None) -> Optional[Dict[str, Any]]:
        """Fix the kernel build cache (``cfg.compile``) and, when
        ``cfg.compile.bundle_dir`` is set, load that kernel bundle
        (``compile.load_bundle``: ``BundleMismatch`` when it does not match
        this model and card, or lacks a rung of the ladder and
        ``require_all``). Returns the bundle's check, None without one."""
        from roko_tpu_torch.compile.bundle import load_bundle

        enable_persistent_cache(self.cfg.compile, log=log)
        bundle = self.cfg.compile.bundle_dir
        if not bundle:
            return None
        return load_bundle(bundle, self.cfg, rungs=self.ladder, require_all=require_all,
                           log=log or (lambda m: None))

    def warmup(self, log=None, *, parallel: Optional[bool] = None,
               require_all: bool = True) -> int:
        """Load the bundle or build the kernels (:meth:`load_compiled`),
        then run one zero batch of every rung through the model (a ragged
        session runs its one top-rung step instead), on threads at once or
        one by one. Returns :meth:`ready_executables` and fills
        ``warmup_report``."""
        from roko_tpu_torch import kernels

        hits0, misses0 = cache_counters()
        t0 = time.perf_counter()
        bundle = self.load_compiled(require_all=require_all, log=log)
        if self.device.type == "cuda":
            # every kernel the model launches, one nvcc per source at once
            # (none with a bundle: its libraries are already installed)
            kernels.build(kernels.inference_kernels(self.model.cfg))
        rungs = self.ladder[-1:] if self.ragged else self.ladder

        def one(rung: int) -> None:
            zeros = np.zeros((rung,) + self._window_shape, np.uint8)
            with self._lock:
                if self.ragged:
                    self._dispatch(zeros, 0)
                else:
                    self._dispatch(zeros)

        cc = self.cfg.compile
        report = warmup_ladder(
            rungs, one, parallel=cc.parallel_warmup if parallel is None else parallel,
            max_workers=cc.warmup_workers, mode="aot" if bundle is not None else None)
        hits1, misses1 = cache_counters()
        report.seconds = time.perf_counter() - t0
        report.cache_hits, report.cache_misses = hits1 - hits0, misses1 - misses0
        self.warmup_report = report
        if log is not None:
            log(f"warmup: {len(rungs)} rung(s) ready in {report.seconds:.1f}s ({report.mode}; "
                f"kernel cache hits={report.cache_hits} misses={report.cache_misses})")
        return self.ready_executables()

    # -- dispatch -----------------------------------------------------------

    def rung_for(self, n: int) -> int:
        """Smallest ladder rung >= n (top rung when none fits)."""
        return rung_for(self.ladder, n)

    def padded_size(self, n: int) -> int:
        """Total padded rows ``predict`` dispatches for an n-window batch
        (top-rung chunks + one padded tail rung)."""
        top = self.ladder[-1]
        full, rest = divmod(n, top)
        return full * top + (self.rung_for(rest) if rest else 0)

    def _forward(self, x: np.ndarray, n: Optional[int] = None) -> np.ndarray:
        """uint8[rung, rows, cols] -> int32[rung, cols] class ids, copied
        back to the host; with ``n``, rows at or past ``n`` are zeroed on
        the device first (the ragged step). Runs on the watchdog's thread:
        the inference mode and the current device are per thread, so both
        are set here."""
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            with torch.inference_mode():
                xt = torch.from_numpy(x).to(self.device)
                if n is not None:
                    xt = mask_rows(xt, n)
                preds = self.model(xt).argmax(dim=-1).to(torch.int32)
                return preds.cpu().numpy()

    def _dispatch(self, x: np.ndarray, n: Optional[int] = None) -> np.ndarray:
        """One padded batch (or, with ``n``, one ragged top-rung slab)
        through the device, under the watchdog; the ragged step has a
        first-call budget of its own (key ``("ragged", top)``)."""
        rung = x.shape[0]
        self.dispatched_shapes.add(rung)
        key: Any = rung if n is None else ("ragged", rung)
        deadline_s, first = self._deadlines.deadline_for(key)
        try:
            out = call_with_deadline(
                lambda: self._forward(x) if n is None else self._forward(x, n),
                deadline_s,
                stage="serve-compile" if first else "serve-predict",
            )
        except BaseException:
            # a failed first dispatch re-arms the first-call budget, so a
            # retry is not judged by the tight predict deadline
            if first:
                self._deadlines.forget(key)
            raise
        self._ready.add(key)
        return out

    def ragged_slots(self, n: int) -> int:
        """Device slots an n-window ragged step spends compute on, the
        ragged twin of ``padded_size`` behind ``padding_efficiency``: the
        reference's formula, n rounded up to the dp granularity (dp is 1
        here, so n)."""
        return -(-n // self.dp) * self.dp

    def predict_ragged(self, x: np.ndarray, n: int) -> np.ndarray:
        """uint8[top, rows, cols] slab + valid-row count -> int32[n, cols]
        class ids. The slab must be top-rung shaped (the ragged batcher
        packs it); rows at or past ``n`` are zeroed on the device, so
        stale slab rows never reach the model."""
        x = np.ascontiguousarray(x, dtype=np.uint8)
        top = self.ladder[-1]
        if x.ndim != 3 or x.shape != (top,) + self._window_shape:
            raise ValueError(
                f"ragged slab shaped {x.shape}, want {(top,) + self._window_shape}"
            )
        if not 0 <= n <= top:
            raise ValueError(f"valid-row count {n} outside [0, {top}]")
        if not x.flags.writeable:  # torch.from_numpy wants a writeable array
            x = x.copy()
        with self._lock:
            preds = self._dispatch(x, n)
        return preds[:n]

    def predict(self, x: np.ndarray) -> np.ndarray:
        """uint8[n, rows, cols] -> int32[n, cols] class ids, padding to
        the ladder (chunked at the top rung)."""
        x = np.ascontiguousarray(x, dtype=np.uint8)
        if x.ndim != 3 or x.shape[1:] != self._window_shape:
            raise ValueError(
                f"windows shaped {x.shape}, want (n,) + {self._window_shape}"
            )
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, self._window_shape[1]), np.int32)
        if not x.flags.writeable:  # torch.from_numpy wants a writeable array
            x = x.copy()
        top = self.ladder[-1]
        outs = []
        with self._lock:
            for s in range(0, n, top):
                chunk = x[s : s + top]
                rung = self.rung_for(chunk.shape[0])
                preds = self._dispatch(pad_windows(chunk, rung))
                outs.append(preds[: chunk.shape[0]])
        return outs[0] if len(outs) == 1 else np.concatenate(outs)
