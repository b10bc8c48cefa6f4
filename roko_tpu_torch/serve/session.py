"""Warm model session with a padded batch ladder (the port's counterpart
of ``roko_tpu/serve/session.py::PolishSession``).

A :class:`PolishSession` holds a :class:`RokoModel` on its device, in
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

One session over several ranks (``mesh``, ``roko_tpu/serve/session.py:
64-123``): the port's mesh is its processes, one per card, so the
reference's one session over every local device becomes one session over
the ranks of a run, in a leader and follower design. Rank 0 is the
leader: it alone admits work (HTTP, the batcher, the stream). Every
other rank is a follower: it holds the same model (a transformer's tp
and sp ranks their shards) and runs :meth:`follow`. Each ladder rung is
a global batch: the leader sends a header ``(op, rung, valid count)`` to
every rank, scatters ``rung/dp`` rows to each dp group, every rank runs
its rows through the model on its own card, and the leader gathers the
int32 class ids of each dp group's (t=0, s=0) rank in dp order
(``parallel/mesh.py``: CPU tensors on gloo, one code path for the CPU,
for ranks sharing a card and for an NCCL run). In a ragged step each
shard masks its own rows, with valid count ``clamp(n - d*rung/dp, 0,
rung/dp)``. The auto ladder is ``ladder_base x dp``, and :meth:`stop`
ends the followers' loop. Only the leader's dispatch thread issues the
collectives, one dispatch at a time under the session lock, so every
rank sees them in one order.

A failed or timed-out dispatch of a session over several ranks leaves
its group out of step (a collective may still be in flight on the
watchdog's thread), so the session marks itself broken instead of
retrying: ``broken`` holds the reason, every later dispatch raises
:class:`SessionBroken` at once, and the callbacks of
:meth:`on_broken` run (the service drains and exits non-zero). The
first-call budget is re-armed after a failure on one rank only.

What the JAX package's session does and this one does not: fail over to
the host CPU after a hang (not ported: carrying on on the CPU after the
card failed would hide the card's failure; ``failed_over`` is always
False). The model runs in its resolved ``cfg.compute_dtype``; a config
that asks for int8 quantizes it once, when the session is built.
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
from roko_tpu_torch.obs import events as obs_events
from roko_tpu_torch.parallel.mesh import (
    OP_PADDED,
    OP_RAGGED,
    OP_STOP,
    Mesh,
    dispatch_header,
    gather_rows,
    scatter_rows,
)
from roko_tpu_torch.parallel.ring import gather_columns
from roko_tpu_torch.resilience import DeadlinePolicy, call_with_deadline


class SessionBroken(RuntimeError):
    """A session over several ranks whose group fell out of step: a
    dispatch failed or outlived its deadline with its collectives
    possibly in flight. Nothing may run on that group again."""


class PolishSession:
    """A model on its device + the padded batch ladder; thread-safe
    dispatch (``predict`` serialises device work with a lock). On a
    ``mesh`` of several ranks, rank 0 dispatches and the others
    :meth:`follow`."""

    def __init__(
        self,
        model: RokoModel,
        cfg: Optional[RokoConfig] = None,
        *,
        device: str | torch.device = "cuda",
        mesh: Optional[Mesh] = None,
        ladder: Optional[Sequence[int]] = None,
    ):
        self.cfg = cfg or RokoConfig(model=model.cfg)
        self.device = resolve_device(device)
        #: the grid this ONE session drives (one rank without a mesh)
        self.mesh: Mesh = mesh if mesh is not None else Mesh(dp=1)
        #: the dp extent: every global rung sends rung/dp rows to each dp group
        self.dp: int = self.mesh.dp
        #: the ranks this session drives (one card each, or sharing one)
        self.n_devices: int = self.mesh.dp * self.mesh.tp * self.mesh.sp
        #: rank 0 admits work and dispatches; every other rank follows
        self.leader: bool = self.mesh.rank == 0
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
        #: why a session over several ranks stopped dispatching; None while
        #: it works
        self.broken: Optional[str] = None
        self._on_broken: list = []
        #: the leader's seconds in the host collectives (header and
        #: scatter; the gather, which waits for the slowest rank)
        self.collective_s: Dict[str, float] = {"send": 0.0, "gather": 0.0}
        #: the global batches this rank ran its rows of (the warmup's too),
        #: over the group when the session has several ranks: its
        #: recurrent kind's kernel launches are its layers times this
        self.dispatches = 0

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

    def on_broken(self, fn) -> None:
        """Call ``fn(reason)`` once, when the session breaks."""
        self._on_broken.append(fn)

    def _break(self, reason: str) -> None:
        if self.broken is not None:
            return
        self.broken = reason
        obs_events.emit("serve", "session_broken", text=f"serve: session over "
                        f"{self.n_devices} ranks broken, no further dispatch: {reason}",
                        stage="serve", ranks=self.n_devices)
        for fn in self._on_broken:
            fn(reason)

    def load_compiled(self, *, require_all: bool = True, log=None) -> Optional[Dict[str, Any]]:
        """Fix the kernel build cache (``cfg.compile``) and, when
        ``cfg.compile.bundle_dir`` is set, load that kernel bundle
        (``compile.load_bundle``: ``BundleMismatch`` when it does not match
        this model, card and grid, or lacks a rung of the ladder and
        ``require_all``). Returns the bundle's check, None without one."""
        from roko_tpu_torch.compile.bundle import load_bundle

        enable_persistent_cache(self.cfg.compile, log=log)
        bundle = self.cfg.compile.bundle_dir
        if not bundle:
            return None
        return load_bundle(bundle, self.cfg, mesh=self.mesh, rungs=self.ladder,
                           require_all=require_all, log=log or (lambda m: None))

    def warmup(self, log=None, *, parallel: Optional[bool] = None,
               require_all: bool = True) -> int:
        """Load the bundle or build the kernels (:meth:`load_compiled`),
        then run one zero batch of every rung through the model (a ragged
        session runs its one top-rung step instead), on threads at once or
        one by one. Returns :meth:`ready_executables` and fills
        ``warmup_report``. A follower only loads or builds its kernels:
        its rungs run when the leader sends them, in :meth:`follow`."""
        from roko_tpu_torch import kernels

        hits0, misses0 = cache_counters()
        t0 = time.perf_counter()
        bundle = self.load_compiled(require_all=require_all, log=log)
        if self.device.type == "cuda":
            # every kernel the model launches, one nvcc per source at once
            # (none with a bundle: its libraries are already installed)
            kernels.build(kernels.inference_kernels(self.model.cfg))
        rungs = () if not self.leader else self.ladder[-1:] if self.ragged else self.ladder

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
        """uint8[b, rows, cols] -> int32[b, cols] class ids of this rank's
        rows, copied back to the host; with ``n``, rows at or past
        ``n`` are zeroed on the device first (the ragged step). A model
        that computes a block of the columns (sp above 1) gathers its sp
        group's logits first. Runs on the watchdog's thread: the inference
        mode and the current device are per thread, so both are set here."""
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            with torch.inference_mode():
                xt = torch.from_numpy(x).to(self.device)
                if n is not None:
                    xt = mask_rows(xt, n)
                logits = self.model(xt)
                if self.model.column_split:
                    logits = gather_columns(logits, self.mesh)
                preds = logits.argmax(dim=-1).to(torch.int32)
                return preds.cpu().numpy()

    def _shard_count(self, rung: int, n: Optional[int]) -> Optional[int]:
        """The valid rows of this rank's shard of a ragged step of ``n``
        rows (None for a padded rung): ``clamp(n - d*rung/dp, 0, rung/dp)``."""
        if n is None:
            return None
        per = rung // self.dp
        return min(max(n - self.mesh.d * per, 0), per)

    def _rows(self, x: np.ndarray, n: Optional[int]) -> np.ndarray:
        """This rank's rows through the model, a padded rung (``n`` None)
        or a ragged shard."""
        return self._forward(x) if n is None else self._forward(x, n)

    def _step(self, x: np.ndarray, n: Optional[int]) -> np.ndarray:
        """The leader's dispatch of one global batch: on one rank the
        forward; over several, the header, the scatter, this rank's rows
        and the gather."""
        mesh = self.mesh
        if not mesh.collective:
            return self._rows(x, n)
        rung = x.shape[0]
        t0 = time.perf_counter()
        dispatch_header(mesh, (OP_PADDED if n is None else OP_RAGGED, rung,
                               -1 if n is None else n))
        mine = scatter_rows(mesh, x, rung, self._window_shape)
        t1 = time.perf_counter()
        preds = self._rows(mine, self._shard_count(rung, n))
        t2 = time.perf_counter()
        out = gather_rows(mesh, preds)
        self.collective_s["send"] += t1 - t0
        self.collective_s["gather"] += time.perf_counter() - t2
        return out

    def _dispatch(self, x: np.ndarray, n: Optional[int] = None) -> np.ndarray:
        """One padded batch (or, with ``n``, one ragged top-rung slab)
        through every rank, under the watchdog; the ragged step has a
        first-call budget of its own (key ``("ragged", top)``). A failure
        breaks a session over several ranks."""
        if self.broken is not None:
            raise SessionBroken(self.broken)
        if not self.leader:
            raise RuntimeError(f"rank {self.mesh.rank} follows rank 0's dispatches "
                               "(PolishSession.follow); only the leader predicts")
        rung = x.shape[0]
        self.dispatched_shapes.add(rung)
        key: Any = rung if n is None else ("ragged", rung)
        deadline_s, first = self._deadlines.deadline_for(key)
        try:
            out = call_with_deadline(
                lambda: self._step(x, n),
                deadline_s,
                stage="serve-compile" if first else "serve-predict",
            )
        except BaseException as e:
            if self.mesh.collective:
                # the group may be mid-collective: never dispatch on it again
                self._break(f"dispatch of rung {rung} failed: {type(e).__name__}: {e}")
            elif first:
                # a failed first dispatch re-arms the first-call budget, so
                # a retry is not judged by the tight predict deadline
                self._deadlines.forget(key)
            raise
        self._ready.add(key)
        self.dispatches += 1
        return out

    def follow(self) -> int:
        """A follower's loop: receive each header of the leader, run this
        rank's rows of the rung and send the class ids back, until the
        stop op; returns the dispatches served. It may be entered again
        after a stop. A failure raises (the caller exits non-zero, and the
        leader's next dispatch fails)."""
        if self.leader:
            raise RuntimeError("rank 0 leads the session; the other ranks follow")
        served = 0
        while True:
            op, rung, n = dispatch_header(self.mesh)
            if op == OP_STOP:
                return served
            mine = scatter_rows(self.mesh, None, rung, self._window_shape)
            self.dispatched_shapes.add(rung)
            preds = self._rows(mine, self._shard_count(rung, n if op == OP_RAGGED else None))
            gather_rows(self.mesh, preds)
            self.dispatches += 1
            served += 1

    def stop(self) -> None:
        """The leader ends the followers' :meth:`follow` (the stop op,
        after every dispatch it sent); a no-op on one rank, on a follower
        and on a broken session."""
        if not (self.leader and self.mesh.collective) or self.broken is not None:
            return
        with self._lock:
            try:
                call_with_deadline(lambda: dispatch_header(self.mesh, (OP_STOP, 0, 0)),
                                   self.cfg.resilience.predict_deadline_s, stage="serve-stop")
            except BaseException as e:
                self._break(f"stop failed: {type(e).__name__}: {e}")
                raise

    def ragged_slots(self, n: int) -> int:
        """Device slots an n-window ragged step spends compute on, the
        ragged twin of ``padded_size`` behind ``padding_efficiency``: the
        reference's formula, n rounded up to the dp granularity (each of
        the dp shards masks its own rows)."""
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
