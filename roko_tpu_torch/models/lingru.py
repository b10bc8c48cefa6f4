"""Stacked bidirectional lingru, the recurrence of ``kind="lingru"``.

Counterpart of ``roko_tpu/models/lingru.py::RokoLinGRU``. The parameters
carry ``torch.nn.GRU``-style names in the torch ``[out, in]`` habit, per
layer k and direction: ``weight_zx_l{k}[_reverse]`` and
``weight_cx_l{k}[_reverse]`` [H, in], ``bias_z_l{k}[_reverse]`` and
``bias_c_l{k}[_reverse]`` [H]. The forward runs each layer through
:func:`roko_tpu_torch.models.fused_lingru.bidir_lingru_layer`, which
launches the CUDA scan kernels on a CUDA tensor. A fresh layer is drawn as
``lingru_layer_params`` draws it (``roko_tpu/models/lingru.py:45-59``):
orthogonal gate matrices, N(0, 1) biases.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from roko_tpu_torch.models.fused_lingru import Layer, Scan, bidir_lingru_stack, lingru_scan

_DIRECTIONS = (("fwd", ""), ("bwd", "_reverse"))
#: per layer direction: (JAX name, port name, matrix?) in the reference's
#: draw order; a matrix is [H, in] here and [in, H] in the JAX tree
PARAMS = (("w_zx", "weight_zx", True), ("w_cx", "weight_cx", True),
          ("b_z", "bias_z", False), ("b_c", "bias_c", False))


class RokoLinGRU(nn.Module):
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
                for _, name, matrix in PARAMS:
                    shape = (hidden, layer_in) if matrix else (hidden,)
                    self.register_parameter(
                        f"{name}_l{k}{suffix}", nn.Parameter(torch.empty(shape))
                    )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Per layer and direction, in the reference's draw order: both
        gate matrices orthogonal (semi-orthogonal: in the JAX layout
        [in, H] the Gram matrix of the shorter side is the identity), then
        both biases N(0, 1)."""
        for k in range(self.num_layers):
            for _, suffix in _DIRECTIONS:
                for _, name, matrix in PARAMS:
                    t = getattr(self, f"{name}_l{k}{suffix}")
                    if matrix:
                        nn.init.orthogonal_(t, generator=generator)
                    else:
                        t.normal_(generator=generator)

    def layers(self) -> Tuple[Layer, ...]:
        """The parameters in the JAX package's layout (transposed views)."""
        out = []
        for k in range(self.num_layers):
            layer = {}
            for direction, suffix in _DIRECTIONS:
                layer[direction] = {}
                for jax_name, name, matrix in PARAMS:
                    t = getattr(self, f"{name}_l{k}{suffix}")
                    layer[direction][jax_name] = t.t() if matrix else t
            out.append(layer)
        return tuple(out)

    def forward(
        self, x: torch.Tensor, scan: Optional[Scan] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """[B, T, in] -> [B, T, 2H] through ``scan`` (default
        :func:`lingru_scan`). In training, dropout between layers draws its
        masks from ``generator``."""
        return bidir_lingru_stack(
            self.layers(), x, scan=scan or lingru_scan,
            dropout=self.dropout if self.training else 0.0, generator=generator,
        )
