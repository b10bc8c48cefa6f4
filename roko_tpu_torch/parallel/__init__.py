"""Parallelism across processes: the process group and the dp mesh.

Counterpart of ``roko_tpu/parallel/`` for data parallelism (ROADMAP
queue item A8a): one process per card, the batch split over them, the
gradients all-reduced (``training/loop.py``), the contigs of an
inference split over them (``infer.py``). The reference's
``data_sharding`` and ``replicated_sharding`` are XLA placements with no
counterpart here. Tensor and sequence parallelism (``tp.py``,
``ring.py``) are queue item A8b.
"""

from roko_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    make_mesh,
    mesh_shape,
    put_replicated,
    shard_batch,
)

__all__ = [
    "AXIS_DP",
    "AXIS_TP",
    "AXIS_SP",
    "Mesh",
    "make_mesh",
    "mesh_shape",
    "put_replicated",
    "shard_batch",
]
