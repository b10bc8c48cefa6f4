"""Primitive layers shared by the port's models."""

from __future__ import annotations

import torch


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` for a reference-layout ``nn.Linear`` weight
    [out, in]: the product first, then the bias, in the order
    ``roko_tpu.models.layers.dense`` sums them."""
    return torch.matmul(x, weight.t()) + bias
