"""Parallelism across processes: the process group and the dp x tp x sp grid.

Counterpart of ``roko_tpu/parallel/``: one process per card on a grid of
``dp`` data-parallel groups, each ``tp`` x ``sp`` ranks
(``mesh.py``). dp splits the batch, the gradients summed across the
replicas (``training/loop.py``), and the contigs of an inference
(``infer.py``); tp splits the transformer's heads and MLP units
(``tp.py``, the Megatron split); sp splits its pileup columns, the
attention running as a ring (``ring.py``). The reference's
``data_sharding``, ``replicated_sharding`` and ``param_sharding`` are XLA
placements with no counterpart here: the port's collectives are explicit.
"""

from roko_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    make_mesh,
    mesh_shape,
    shard_batch,
)
from roko_tpu_torch.parallel.ring import ring_attention
from roko_tpu_torch.parallel.tp import gather_state_dict, param_specs, shard_state_dict

__all__ = [
    "AXIS_DP",
    "AXIS_TP",
    "AXIS_SP",
    "Mesh",
    "make_mesh",
    "mesh_shape",
    "shard_batch",
    "ring_attention",
    "param_specs",
    "shard_state_dict",
    "gather_state_dict",
]
