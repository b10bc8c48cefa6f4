"""Primitive layers shared by the port's models: the dense product, the
``torch.nn.Linear``-style init, inverted dropout
(``roko_tpu/models/layers.py:15-24,53-60``), and the one idiom every
matrix product fetches its weight through (:26-85): a float tensor cast
to the compute dtype, or an int8 weight-only matrix dequantized in place.

Matrices reach the products in the JAX package's layout, ``[in, out]``:
transposed views of the port's ``[out, in]`` parameters, or, once
``models/quant.py`` has quantized a model, ``{"q": int8 [in, out],
"scale": float32 [out]}`` built from the module's ``<name>_q`` [out, in]
and ``<name>_scale`` [out] buffers (:func:`jax_weight`), so the scale
sits on the last axis, where the JAX package keeps it."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
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


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, else zero. The mask is drawn from
    ``generator``, which lies on ``x``'s device. ``rate`` 0 returns ``x``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
