"""Primitive layers shared by the port's models: the dense product, the
``torch.nn.Linear``-style init and inverted dropout
(``roko_tpu/models/layers.py:15-24,53-60``)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` for a reference-layout ``nn.Linear`` weight
    [out, in]: the product first, then the bias, in the order
    ``roko_tpu.models.layers.dense`` sums them."""
    return torch.matmul(x, weight.t()) + bias


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
