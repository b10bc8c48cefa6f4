"""Tensor parallelism of the transformer: the Megatron split.

Counterpart of ``roko_tpu/parallel/tp.py`` (:26-61). In each encoder
layer ``q``, ``k``, ``v`` and ``mlp_in`` are column-parallel: tp rank t
holds ``num_heads / tp`` heads (``d_model / tp`` output columns) and
``mlp_dim / tp`` hidden units, with their biases. ``proj`` and
``mlp_out`` are row-parallel: rank t holds the input rows that match its
columns, and their biases stay whole, added after the reduction.
Everything else is replicated: the embedding, ``fc1``, ``fc2``, ``fc4``,
``in_proj``, ``pos_embed``, the layer norms, and every parameter of the
gru and lingru kinds (a recurrence is not split).

The reference expresses the split as ``PartitionSpec``s and XLA inserts
the all-reduces; here two autograd ``Function``s carry it:
:func:`copy_to_tp` (identity forward, all-reduce of the gradient
backward) before each column-parallel product, and :func:`reduce_from_tp`
(all-reduce forward, identity backward) after each row-parallel one. A
layer runs two all-reduces forward and two backward.

Names follow the port's ``state_dict``; a split axis is the axis of the
port's tensor (``[out, in]`` weights), 0 for a column-parallel weight or
bias and 1 for a row-parallel weight. :func:`shard_state_dict` cuts a
full state dict into this rank's part and :func:`gather_state_dict` joins
the parts again, so a checkpoint holds full tensors.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import torch

from roko_tpu_torch.parallel import distributed
from roko_tpu_torch.parallel.mesh import Mesh, group_reduce_

_COLUMN = re.compile(r"encoder\.layers\.\d+\.(q|k|v|mlp_in)\.(weight|bias)$")
_ROW = re.compile(r"encoder\.layers\.\d+\.(proj|mlp_out)\.weight$")


def split_axis(name: str) -> Optional[int]:
    """The axis tensor ``name`` of a transformer's state_dict is split on
    over tp, or None for a replicated one."""
    if _COLUMN.match(name):
        return 0
    if _ROW.match(name):
        return 1
    return None


def param_specs(cfg, state_dict: Mapping[str, Any]) -> Dict[str, Optional[int]]:
    """For every tensor of ``state_dict``, the axis it is split on over tp,
    or None (``param_specs``, :42-61): the gru and lingru kinds replicate
    everything."""
    if cfg.kind != "transformer":
        return {name: None for name in state_dict}
    return {name: split_axis(name) for name in state_dict}


def check_divisible(cfg, tp: int, sp: int) -> None:
    """Raise ``ValueError`` unless the transformer of ``cfg`` splits over
    ``tp`` (its heads; then its ``mlp_ratio * d_model`` MLP units split
    too, since the heads divide ``d_model``) and ``sp`` (its pileup
    columns); the other kinds replicate over both."""
    if cfg.kind != "transformer":
        return
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by tp={tp}")
    if cfg.window_cols % sp:
        raise ValueError(f"window_cols {cfg.window_cols} not divisible by sp={sp}: each sp "
                         "rank holds an equal block of the pileup columns")


def shard(t: torch.Tensor, axis: Optional[int], mesh: Mesh) -> torch.Tensor:
    """Rank t's part of a full tensor split on ``axis`` (itself for None)."""
    if axis is None or mesh.tp == 1:
        return t
    return t.chunk(mesh.tp, dim=axis)[mesh.t].clone()


def gather(t: torch.Tensor, axis: Optional[int], mesh: Mesh) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's part, joined over the
    tp group through CPU tensors (gloo gathers only those), on the host."""
    if axis is None or mesh.tp == 1:
        return t
    parts = distributed.all_gather_cpu(t.detach(), mesh.tp_group)
    return torch.cat(list(parts.unbind(0)), dim=axis)


def shard_state_dict(cfg, full: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of a full state dict."""
    specs = param_specs(cfg, full)
    return {name: shard(t, specs[name], mesh) for name, t in full.items()}


def gather_state_dict(cfg, part: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full state dict whose tp parts the ranks hold; a collective over
    the tp group, so every rank of it calls this."""
    specs = param_specs(cfg, part)
    return {name: gather(t, specs[name], mesh) for name, t in part.items()}


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced (summed) over tp."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return group_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) over tp forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        return group_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel product: in backward, the ranks'
    partial gradients of ``x`` summed."""
    return _CopyToTP.apply(x, mesh.tp_group) if mesh.tp > 1 else x


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The output of a row-parallel product: the ranks' partial sums added."""
    return _ReduceFromTP.apply(x, mesh.tp_group) if mesh.tp > 1 else x
