"""Stacked bidirectional GRU with the reference ``torch.nn.GRU`` parameters.

Counterpart of ``roko_tpu/models/gru.py``. The parameters carry the names
and layouts of ``torch.nn.GRU(bidirectional=True)``:
``weight_ih_l{k}[_reverse]`` [3H, in], ``weight_hh_l{k}[_reverse]``
[3H, H], ``bias_ih_l{k}[_reverse]`` and ``bias_hh_l{k}[_reverse]`` [3H],
gate order (r, z, n), so a reference roko ``.pth`` loads with
``load_state_dict(strict=True)``. The forward runs each layer through
:func:`roko_tpu_torch.models.fused_gru.fused_bidir_layer`, which launches
the CUDA recurrence kernels on a CUDA tensor. A fresh layer is drawn as
``gru_layer_params`` draws it (``roko_tpu/models/gru.py:40-53``):
orthogonal matrices, N(0, 1) biases.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from roko_tpu_torch.models.fused_gru import (
    Layer,
    Recurrence,
    bidir_gru_stack,
    gru_recurrence,
)

_DIRECTIONS = (("fwd", ""), ("bwd", "_reverse"))


class RokoGRU(nn.Module):
    def __init__(
        self, in_size: int, hidden: int, num_layers: int, dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_size = in_size
        self.hidden = hidden
        self.num_layers = num_layers
        self.dropout = dropout
        for k in range(num_layers):
            layer_in = in_size if k == 0 else 2 * hidden
            for _, suffix in _DIRECTIONS:
                for name, shape in (
                    ("weight_ih", (3 * hidden, layer_in)),
                    ("weight_hh", (3 * hidden, hidden)),
                    ("bias_ih", (3 * hidden,)),
                    ("bias_hh", (3 * hidden,)),
                ):
                    self.register_parameter(
                        f"{name}_l{k}{suffix}", nn.Parameter(torch.empty(shape))
                    )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Per layer and direction, in the reference's draw order: the
        input and hidden matrices orthogonal (semi-orthogonal; in the JAX
        layout [in, 3H] and [H, 3H] the Gram matrix of the shorter side
        is the identity), both biases N(0, 1)."""
        for k in range(self.num_layers):
            for _, suffix in _DIRECTIONS:
                nn.init.orthogonal_(getattr(self, f"weight_ih_l{k}{suffix}"), generator=generator)
                nn.init.orthogonal_(getattr(self, f"weight_hh_l{k}{suffix}"), generator=generator)
                getattr(self, f"bias_ih_l{k}{suffix}").normal_(generator=generator)
                getattr(self, f"bias_hh_l{k}{suffix}").normal_(generator=generator)

    def layers(self) -> Tuple[Layer, ...]:
        """The parameters in the JAX package's layout (transposed views)."""
        out = []
        for k in range(self.num_layers):
            layer = {}
            for direction, suffix in _DIRECTIONS:
                layer[direction] = {
                    "w_ih": getattr(self, f"weight_ih_l{k}{suffix}").t(),
                    "w_hh": getattr(self, f"weight_hh_l{k}{suffix}").t(),
                    "b_ih": getattr(self, f"bias_ih_l{k}{suffix}"),
                    "b_hh": getattr(self, f"bias_hh_l{k}{suffix}"),
                }
            out.append(layer)
        return tuple(out)

    def forward(
        self, x: torch.Tensor, recurrence: Recurrence = gru_recurrence,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """[B, T, in] -> [B, T, 2H]. In training, dropout between layers
        draws its masks from ``generator``."""
        return bidir_gru_stack(
            self.layers(), x, recurrence=recurrence,
            dropout=self.dropout if self.training else 0.0, generator=generator,
        )
