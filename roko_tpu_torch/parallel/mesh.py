"""The process mesh and the data-parallel collectives of the port.

Counterpart of ``roko_tpu/parallel/mesh.py`` (:30-90, :291). Axis
convention (``MeshConfig``, ``roko_tpu_torch/config.py``):

- ``dp``: data parallel. Each process holds a replica of the model and
  the rows ``[rank * B / dp, (rank + 1) * B / dp)`` of a global batch of
  B; the gradients are summed across the replicas by an all-reduce.
- ``tp`` and ``sp``: tensor and sequence parallel, for the transformer
  (ROADMAP queue item A8b). Not ported: a size above 1 is refused.

The reference lays a ``jax.sharding.Mesh`` over devices and lets XLA
insert the collectives; the port runs one process per card, so its mesh
is the processes of the run, and the collectives are explicit calls on
the ``torch.distributed`` group of :mod:`.distributed`.
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

_A8B = ("{axis}={size}: tensor and sequence parallelism are not ported yet (queue item "
        "A8b of ROADMAP.md); the port runs data parallelism only, --tp 1 --sp 1")


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


def check_ported(cfg: MeshConfig) -> None:
    """Raise ``ValueError`` naming A8b for a tp or sp axis above 1."""
    for axis in (AXIS_TP, AXIS_SP):
        size = getattr(cfg, axis)
        if size != 1:
            raise ValueError(_A8B.format(axis=axis, size=size))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The dp axis of a run (tp and sp are 1 until A8b): its size, this
    process's place on it, and the process group its collectives run on
    (None for a run of one process without a group, where every
    collective is a no-op)."""

    dp: int
    rank: int = 0
    group: Any = None

    @property
    def collective(self) -> bool:
        """True when the steps reduce across the group: several ranks, or
        one rank that joined a group (its collectives still run)."""
        return self.group is not None


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of ``cfg`` over the run's processes: dp must cover every
    process (``--dp 2`` in one process is refused), and tp and sp must be 1
    until A8b."""
    cfg = cfg or MeshConfig()
    check_ported(cfg)
    dp, _, _ = mesh_shape(cfg)
    group = None
    if distributed.is_initialized():
        import torch.distributed as dist

        group = dist.group.WORLD
    return Mesh(dp=dp, rank=distributed.rank(), group=group)


def shard_batch(mesh: Mesh, batch: Sequence[Any]) -> Tuple[Any, ...]:
    """This rank's rows of every array of a global batch (leading axis =
    batch): rows ``[rank * n / dp, (rank + 1) * n / dp)``."""
    n = len(batch[0])
    if n % mesh.dp:
        raise ValueError(f"global batch {n} not divisible by dp={mesh.dp}")
    per = n // mesh.dp
    return tuple(a[mesh.rank * per : (mesh.rank + 1) * per] for a in batch)


def all_reduce_(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place across the dp group ("sum" or "min")."""
    if mesh.collective:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MIN,
                        group=mesh.group)
    return t


def put_replicated(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Make every rank's ``tensors`` rank 0's, in place (a broadcast from
    rank 0): the replicas start equal whatever each rank drew or read."""
    if not mesh.collective:
        return
    import torch.distributed as dist

    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=mesh.group)
