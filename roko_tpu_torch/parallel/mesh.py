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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

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
