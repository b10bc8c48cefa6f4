"""The process mesh of the port: a dp x tp x sp grid of processes.

Counterpart of ``roko_tpu/parallel/mesh.py`` (:30-90, :291). Axis
convention (``MeshConfig``, ``roko_tpu_torch/config.py``):

- ``dp``: data parallel. Each dp group holds a replica of the model and
  the rows ``[d * B / dp, (d + 1) * B / dp)`` of a global batch of B; the
  gradients are summed across the replicas.
- ``tp``: tensor parallel, for the transformer: each tp rank holds
  ``1/tp`` of the heads and of the MLP's hidden units (``tp.py``).
- ``sp``: sequence parallel, for the transformer: each sp rank holds
  ``1/sp`` of the pileup columns and the attention runs as a ring
  (``ring.py``).

Ranks lie on the grid row-major, as the reference reshapes
``jax.devices()`` (:68-73): rank ``(d * tp + t) * sp + s``, so a tp or
sp group is neighbouring ranks. The reference lays a
``jax.sharding.Mesh`` over devices and lets XLA insert the collectives;
the port runs one process per card, so its mesh is the processes of the
run, and the collectives are explicit calls on the ``torch.distributed``
subgroups of :func:`distributed.grid_groups`.

A polishing session over the grid (``serve/session.py``) moves its host
arrays with three collectives of CPU tensors on the whole run, all from
rank 0: :func:`dispatch_header`, :func:`scatter_rows` (each dp group its
rows of a global rung) and :func:`gather_rows` (the class ids back, one
rank a dp group). On the CPU they run on gloo, and so they do on cards,
through the ``cpu:gloo`` half of the NCCL group.

Beside the grid, the serving fleet's card slices (:92-290 of the
reference's module): :func:`fleet_worker_slice`, :func:`fleet_worker_env`
(a ``CUDA_VISIBLE_DEVICES`` overlay), :func:`visible_device_count` and
:func:`resolve_fleet_topology`, which the supervisor calls without
initialising CUDA. A reference worker's ``dp=-1`` mesh absorbs every
device of its slice (:122-175); a port worker does the same with one
process a card: :func:`fleet_worker_ranks` is its k, and
:func:`fleet_worker_rank_envs` the k environment overlays the supervisor
starts its ranks with, one session over them (``serve/session.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from roko_tpu_torch.config import MeshConfig
from roko_tpu_torch.parallel import distributed

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"


def mesh_shape(cfg: MeshConfig, n_devices: Optional[int] = None) -> Tuple[int, int, int]:
    """Resolve (dp, tp, sp) sizes; a -1 axis absorbs the remaining
    processes (``n_devices``, default the run's world size)."""
    n = n_devices if n_devices is not None else distributed.world_size()
    sizes = [cfg.dp, cfg.tp, cfg.sp]
    n_free = sizes.count(-1)
    if n_free > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_free:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes product {fixed}")
        sizes = [n // fixed if s == -1 else s for s in sizes]
    elif fixed != n:
        raise ValueError(f"mesh {sizes} wants {fixed} devices, have {n}")
    return tuple(sizes)  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid of a run: its sizes, this process's rank, and the process
    groups its collectives run on. ``group`` is the whole run; ``dp_group``
    the ranks that share this rank's (t, s), ``tp_group`` its (d, s),
    ``sp_group`` its (d, t) and ``dp_sp_group`` its t. A run of one
    process without a group has every group None, and every collective is
    a no-op; so is one over a group of one rank."""

    dp: int
    rank: int = 0
    group: Any = None
    tp: int = 1
    sp: int = 1
    dp_group: Any = None
    tp_group: Any = None
    sp_group: Any = None
    dp_sp_group: Any = None

    @property
    def collective(self) -> bool:
        """True when the steps reduce across the group: several ranks, or
        one rank that joined a group (its collectives still run)."""
        return self.group is not None

    @property
    def d(self) -> int:
        """This rank's place on the dp axis."""
        return self.rank // (self.tp * self.sp)

    @property
    def t(self) -> int:
        """This rank's place on the tp axis."""
        return self.rank // self.sp % self.tp

    @property
    def s(self) -> int:
        """This rank's place on the sp axis."""
        return self.rank % self.sp

    def rank_of(self, d: int, t: int, s: int) -> int:
        """The rank at grid point (d, t, s)."""
        return (d * self.tp + t) * self.sp + s


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The grid of ``cfg`` over the run's processes: its sizes must cover
    every process (``--dp 2`` or ``--tp 2`` in one process is refused with
    :func:`mesh_shape`'s message), and every rank makes every subgroup."""
    cfg = cfg or MeshConfig()
    dp, tp, sp = mesh_shape(cfg)
    groups = distributed.grid_groups(dp, tp, sp)
    group = None
    if distributed.is_initialized():
        import torch.distributed as dist

        group = dist.group.WORLD
    return Mesh(dp=dp, rank=distributed.rank(), group=group, tp=tp, sp=sp,
                dp_group=groups["dp"], tp_group=groups["tp"], sp_group=groups["sp"],
                dp_sp_group=groups["dp_sp"])


def shard_batch(mesh: Mesh, batch: Sequence[Any]) -> Tuple[Any, ...]:
    """This rank's rows of every array of a global batch (leading axis =
    batch): rows ``[d * n / dp, (d + 1) * n / dp)``. The ranks of one
    tp x sp block hold the same rows."""
    n = len(batch[0])
    if n % mesh.dp:
        raise ValueError(f"global batch {n} not divisible by dp={mesh.dp}")
    per = n // mesh.dp
    return tuple(a[mesh.d * per : (mesh.d + 1) * per] for a in batch)


def group_reduce_(t: torch.Tensor, group: Any, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place across ``group`` ("sum" or "min"); None (one
    rank) is a no-op."""
    if group is not None:
        import torch.distributed as dist

        op_ = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MIN
        dist.all_reduce(t, op=op_, group=group)
    return t


def all_reduce_(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place across the whole run ("sum" or "min")."""
    return group_reduce_(t, mesh.group, op)


def group_broadcast_(t: torch.Tensor, group: Any, src: int) -> torch.Tensor:
    """Make ``t`` rank ``src``'s (a global rank of ``group``) in place on
    every rank of ``group``; None is a no-op."""
    if group is not None:
        import torch.distributed as dist

        dist.broadcast(t, src=src, group=group)
    return t


#: the ops of a session's dispatch header (``serve/session.py``): the
#: followers' loop ends, or one padded rung, or one ragged top-rung slab
OP_STOP, OP_PADDED, OP_RAGGED = 0, 1, 2


def dispatch_header(mesh: Mesh, header: Optional[Tuple[int, int, int]] = None
                    ) -> Tuple[int, int, int]:
    """``(op, rung, valid count)`` from rank 0 to every rank of the run:
    rank 0 passes it, the others receive it. A CPU tensor, so it rides
    gloo (the ``cpu:gloo`` half of an NCCL group); without a group the
    header comes back as given."""
    if mesh.group is None:
        return header  # type: ignore[return-value]
    import torch.distributed as dist

    t = torch.tensor(header if mesh.rank == 0 else (0, 0, 0), dtype=torch.int64)
    dist.broadcast(t, src=0, group=mesh.group)
    op, rung, n = (int(v) for v in t.tolist())
    return op, rung, n


def scatter_rows(mesh: Mesh, x: Optional[np.ndarray], rung: int,
                 shape: Sequence[int]) -> np.ndarray:
    """This rank's rows of rank 0's global batch ``x`` (``[rung, *shape]``
    uint8; None on the other ranks): rows ``[d * rung / dp, (d + 1) * rung
    / dp)`` of dp group d, the same rows for every tp and sp rank of the
    group. One gloo scatter of CPU tensors; without a group, ``x``."""
    if mesh.group is None:
        return x  # type: ignore[return-value]
    import torch.distributed as dist

    per = rung // mesh.dp
    out = torch.empty((per, *shape), dtype=torch.uint8)
    parts = None
    if mesh.rank == 0:
        xt = torch.from_numpy(x)
        block = mesh.tp * mesh.sp  # the ranks of one dp group
        parts = [xt[r // block * per : (r // block + 1) * per] for r in range(mesh.dp * block)]
    dist.scatter(out, parts, src=0, group=mesh.group)
    return out.numpy()


def gather_rows(mesh: Mesh, rows: np.ndarray) -> Optional[np.ndarray]:
    """Every rank's class ids to rank 0, which joins those of each dp
    group's (t=0, s=0) rank in dp order; None on the other ranks. One gloo
    gather of CPU tensors; without a group, ``rows``."""
    if mesh.group is None:
        return rows
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(rows))
    parts = None
    if mesh.rank == 0:
        parts = [torch.empty_like(t) for _ in range(mesh.dp * mesh.tp * mesh.sp)]
    dist.gather(t, parts, dst=0, group=mesh.group)
    if parts is None:
        return None
    return torch.cat([parts[mesh.rank_of(d, 0, 0)] for d in range(mesh.dp)]).numpy()


def fleet_worker_slice(worker_index: int, num_workers: int, devices_per_worker: int) -> "list[int]":
    """The contiguous card ids fleet worker ``i`` of ``n`` owns:
    ``[i*k, (i+1)*k)`` for ``k = devices_per_worker``."""
    if worker_index < 0 or worker_index >= num_workers:
        raise ValueError(f"worker_index {worker_index} outside fleet of {num_workers}")
    if devices_per_worker < 1:
        raise ValueError("devices_per_worker must be >= 1 to pin a slice")
    first = worker_index * devices_per_worker
    return list(range(first, first + devices_per_worker))


def fleet_worker_env(worker_index: int, num_workers: int, devices_per_worker: int = 0,
                     backend: str = "cuda") -> "dict[str, str]":
    """The environment overlay that pins one fleet worker to its cards:
    ``CUDA_VISIBLE_DEVICES`` of its slice. Pure computation, touching no
    CUDA API (the supervisor calls it). ``devices_per_worker == 0`` (the
    workers share the cards) and the CPU give an empty overlay."""
    if devices_per_worker <= 0 or backend == "cpu":
        return {}
    ids = fleet_worker_slice(worker_index, num_workers, devices_per_worker)
    return {"CUDA_VISIBLE_DEVICES": ",".join(str(i) for i in ids)}


def fleet_worker_ranks(devices_per_worker: int, mesh: MeshConfig, backend: str = "cuda",
                       n_visible: Optional[int] = None) -> int:
    """k, the ranks (processes) of one fleet worker's session: its slice's
    cards when ``devices_per_worker`` is above 0; with shared cards (0),
    the config's grid ``dp x tp x sp`` when it names every axis, else the
    visible cards (``n_visible``, default :func:`visible_device_count`),
    which is 1 on the CPU. The grid must fill k (:func:`mesh_shape`'s
    message otherwise). No CUDA API and no device file in this process."""
    if devices_per_worker > 0:
        k = devices_per_worker
    elif min(mesh.dp, mesh.tp, mesh.sp) >= 1:
        k = mesh.dp * mesh.tp * mesh.sp
    else:
        k = max(1, n_visible if n_visible is not None else visible_device_count(backend))
    mesh_shape(mesh, k)
    return k


def fleet_worker_rank_envs(worker_index: int, num_workers: int, devices_per_worker: int,
                           mesh: MeshConfig, coordinator: str, backend: str = "cuda",
                           n_visible: Optional[int] = None) -> "list[dict[str, str]]":
    """The environment overlays of the k ranks of fleet worker ``i`` of
    ``n`` (k from :func:`fleet_worker_ranks`): each is
    :func:`fleet_worker_env`'s slice, and, when k is above 1,
    ``ROKO_COORDINATOR`` (``coordinator``, rank 0's ``host:port``),
    ``ROKO_NUM_PROCESSES=k`` and ``ROKO_PROCESS_ID=r``. The ranks choose
    their backend themselves (``distributed.initialize``: gloo when they
    share a card). One rank gets the slice alone, a plain process as
    before. No CUDA API in this process."""
    k = fleet_worker_ranks(devices_per_worker, mesh, backend, n_visible)
    base = fleet_worker_env(worker_index, num_workers, devices_per_worker, backend=backend)
    if k == 1:
        return [base]
    common = {**base, distributed.ENV_COORDINATOR: coordinator,
              distributed.ENV_NUM_PROCESSES: str(k)}
    return [{**common, distributed.ENV_PROCESS_ID: str(r)} for r in range(k)]


def visible_device_count(backend: str = "cuda") -> int:
    """The cards this process (or a child with its environment) sees:
    ``CUDA_VISIBLE_DEVICES`` when set, else ``torch.cuda.device_count()``
    as a child process gives it (:func:`_child_device_count`), the count
    the ranks themselves use, while this process opens no device file of
    the card; 1 on the CPU (the host)."""
    import os

    if backend == "cpu":
        return 1
    ids = os.environ.get("CUDA_VISIBLE_DEVICES")
    if ids is not None:
        return len([t for t in ids.split(",") if t.strip()])
    return _child_device_count()


@functools.lru_cache(maxsize=None)
def _child_device_count() -> int:
    """``torch.cuda.device_count()`` in a child process with this
    environment; 0 when the child cannot tell. Counted once a process."""
    import subprocess
    import sys

    try:
        child = subprocess.run([sys.executable, "-c",
                                "import torch; print(torch.cuda.device_count())"],
                               capture_output=True, text=True, timeout=300)
        return int(child.stdout.strip() or 0)
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return 0


def resolve_fleet_topology(fleet_cfg, backend: str = "cuda"):
    """Resolve ``--workers auto`` and refuse oversubscription, before
    anything spawns; returns a (possibly updated) ``FleetConfig``.

    - ``workers == -1`` (auto): the visible cards over
      ``devices_per_worker`` (1 when unset, which turns pinning on);
    - explicit ``workers`` with ``devices_per_worker > 0`` on the card:
      a worker count x slice above the visible cards is refused. With
      ``devices_per_worker == 0`` the workers share the cards, and on the
      CPU there is nothing to oversubscribe: then nothing is counted.
      Counting opens no device file of the card in this process
      (:func:`visible_device_count`)."""
    fc = fleet_cfg
    if fc.workers != -1 and (backend == "cpu" or fc.devices_per_worker <= 0):
        return fc
    n = visible_device_count(backend)
    if fc.workers == -1:
        per = fc.devices_per_worker if fc.devices_per_worker > 0 else 1
        workers = n // per
        if workers < 1:
            raise ValueError(
                f"--workers auto: {n} visible card(s) cannot host even one worker of {per} "
                "card(s) (--devices-per-worker); pass --workers explicitly")
        fc = dataclasses.replace(fc, workers=workers, devices_per_worker=per)
    if backend != "cpu" and fc.workers > 0 and fc.devices_per_worker > 0:
        need = fc.workers * fc.devices_per_worker
        if need > n:
            raise ValueError(
                f"fleet topology oversubscribes the host: {fc.workers} worker(s) x "
                f"{fc.devices_per_worker} card(s) each = {need} > {n} visible card(s). Use "
                f"--workers auto, --devices-per-worker 0 to share the cards, or at most "
                f"{n // fc.devices_per_worker} worker(s) at this slice size.")
    return fc
