"""Primitive layers shared by the port's models: the dense product, the
``torch.nn.Linear``-style init, inverted dropout, the layer norm
(``roko_tpu/models/layers.py:15-24,53-70``), the GELU of ``jax.nn.gelu``,
and the one idiom every matrix product fetches its weight through
(:26-85): a float tensor cast to the compute dtype, or an int8
weight-only matrix dequantized in place.

Matrices reach the products in the JAX package's layout, ``[in, out]``:
transposed views of the port's ``[out, in]`` parameters, or, once
``models/quant.py`` has quantized a model, ``{"q": int8 [in, out],
"scale": float32 [out]}`` built from the module's ``<name>_q`` [out, in]
and ``<name>_scale`` [out] buffers (:func:`jax_weight`), so the scale
sits on the last axis, where the JAX package keeps it."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

Weight = Union[torch.Tensor, Dict[str, torch.Tensor]]


def is_quantized_weight(w: Any) -> bool:
    """True for the int8 weight-only form ``{"q": int8 [..., out],
    "scale": float32 [out]}``."""
    return isinstance(w, dict) and "q" in w and "scale" in w


def dequant_weight(w: Dict[str, torch.Tensor], dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An int8 weight as a dense matrix in ``dtype`` (default float32):
    the multiply in float32, then one cast, as the JAX package does it."""
    kernel = w["q"].to(torch.float32) * w["scale"]
    return kernel if dtype is None else kernel.to(dtype)


def weight(w: Weight, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``w`` as a dense matrix in ``dtype``: a tensor cast (itself when it
    already has the dtype), an int8 weight dequantized."""
    if is_quantized_weight(w):
        return dequant_weight(w, dtype)
    return w if dtype is None else w.to(dtype)


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of a nest of dicts, tuples and lists cast to
    ``dtype``; int8 weights pass whole (their scales stay float32 and
    :func:`weight` casts at the use site)."""
    if is_quantized_weight(tree):
        return tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def jax_weight(module: nn.Module, name: str) -> Weight:
    """Matrix ``name`` of ``module`` in the JAX layout [in, out]: its
    parameter transposed, or, once quantized, the int8 form of its
    ``<name>_q`` and ``<name>_scale`` buffers."""
    q = getattr(module, f"{name}_q", None)
    if q is None:
        return getattr(module, name).t()
    return {"q": q.t(), "scale": getattr(module, f"{name}_scale")}


def dense(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """``x @ W + b`` of a reference-layout ``nn.Linear`` in ``x``'s dtype:
    the product first, then the bias, in the order
    ``roko_tpu.models.layers.dense`` sums them."""
    return torch.matmul(x, weight(jax_weight(linear, "weight"), x.dtype)) + linear.bias.to(x.dtype)


@torch.no_grad()
def init_dense(weight: torch.Tensor, bias: torch.Tensor, generator: torch.Generator) -> None:
    """U(-1/sqrt(in), 1/sqrt(in)) for the weight [out, in] and the bias,
    as ``dense_params`` draws them."""
    bound = 1.0 / math.sqrt(weight.shape[1])
    weight.uniform_(-bound, bound, generator=generator)
    bias.uniform_(-bound, bound, generator=generator)


@dataclasses.dataclass(frozen=True)
class GlobalSlice:
    """A dropout generator for the rank that holds rows block ``rank`` of
    ``world`` (its dp place) and columns block ``col`` of ``cols`` (its sp
    place, 1 block when the columns are not split) of the global batch:
    every mask is drawn for the whole global tensor from ``generator`` and
    the rank keeps its own block, so the ranks together drop what one
    process at the global batch drops, and every rank's generator stays in
    step. The port's counterpart of the reference's partitionable threefry
    (``roko_tpu/parallel/mesh.py:34-41``): masks that do not depend on the
    sharding. It costs ``world * cols`` times the draws of the rank's own
    block."""

    generator: torch.Generator
    rank: int
    world: int
    col: int = 0
    cols: int = 1
    #: the axis of the columns in the tensors this generator's masks cover
    col_axis: int = 1


def on_column_axis(generator, axis: int):
    """``generator`` for a dropout site whose columns lie on ``axis``: a
    :class:`GlobalSlice` with that ``col_axis``; a plain generator as it is."""
    if isinstance(generator, GlobalSlice):
        return dataclasses.replace(generator, col_axis=axis)
    return generator


def dropout(
    x: torch.Tensor, rate: float,
    generator: Union[torch.Generator, GlobalSlice, None],
) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, else zero. The mask is drawn from
    ``generator``, which lies on ``x``'s device, or, for a
    :class:`GlobalSlice`, drawn for the global tensor (rows along ``x``'s
    first axis, columns along its ``col_axis``) and cut to this rank's
    block. ``rate`` 0 returns ``x``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, GlobalSlice):
        g, axis = generator, generator.col_axis
        b, c = x.shape[0], x.shape[axis]
        shape = list(x.shape)
        shape[0] *= g.world
        shape[axis] *= g.cols
        full = torch.rand(shape, generator=g.generator, device=x.device)
        mask = full[g.rank * b : (g.rank + 1) * b].narrow(axis, g.col * c, c) < keep
    else:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """``(x - mu) * rsqrt(var + eps) * scale + bias`` over the last axis,
    op for op as ``roko_tpu.models.layers.layernorm`` writes it, in x's
    dtype: the mean and the biased variance summed in float32 and each
    rounded to x's dtype once (what ``jnp.mean`` and ``jnp.var`` do with
    bfloat16), then every elementwise op rounded, ``eps`` a constant of
    x's dtype, and the reciprocal square root taken in float32 and rounded
    once, as XLA takes it (torch's bfloat16 ``rsqrt`` on the CPU differs
    from it in the last bit). In float32 the roundings are no-ops; in
    bfloat16 a fused ``F.layer_norm`` would round once, where the
    reference rounds each op. ``scale`` and ``bias`` are in x's dtype."""
    dtype = x.dtype
    wide = x.float()
    mu = wide.mean(dim=-1, keepdim=True).to(dtype)
    var = wide.var(dim=-1, keepdim=True, correction=0).to(dtype)
    inv = torch.rsqrt((var + torch.tensor(eps, dtype=dtype)).float()).to(dtype)
    return (x - mu) * inv * scale + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation
    ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))`` (torch's
    ``F.gelu`` defaults to the exact erf form). In float32 the fused
    ``F.gelu(approximate="tanh")``; in a narrower dtype op for op in it,
    each op rounded with constants of that dtype, as the reference rounds
    them (the fused form rounds once, and misses many of its bf16
    outputs)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")

    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=x.dtype)

    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))
