"""Pre-LN transformer encoder, the sequence block of ``kind="transformer"``.

Counterpart of ``roko_tpu/models/transformer.py``. It takes the place of
the recurrence between the shared front end and the shared head, with the
same contract, ``[B, T, gru_in_size] -> [B, T, 2 * hidden_size]``::

    in_proj gru_in_size -> d_model, + pos_embed[:T]
    x num_layers:  x + proj(attention(LN1(x)))          dropout before the add
                   x + mlp_out(gelu(mlp_in(LN2(x))))    dropout before the add
    ln_out

The attention is dense and bidirectional over the T pileup columns:
``num_heads`` heads of ``d_model / num_heads``, the scores divided by
``sqrt(head dim)`` after the product, a softmax over the keys. Every
product is a plain ``torch.matmul`` or ``torch.einsum``, as the reference
computes them outside any Pallas kernel: no TPU kernel stands behind this
module, and it launches none of the port's CUDA kernels.

Everything runs in the input's dtype: each parameter is cast to it at its
use (the layer norms' and ``pos_embed`` too, as ``cast_tree`` casts the
reference's encoder tree), so in bfloat16 the gradients come back to the
float32 parameters rounded to bf16 once. The softmax and the layer norm
are written op for op as the reference's, so that in bfloat16 they round
where it rounds: ``softmax`` here, and ``layernorm`` and ``gelu`` in
``models/layers.py``.

Parameter names: ``in_proj``, ``pos_embed`` [window_cols, d_model],
``layers.{i}.{ln1, q, k, v, proj, ln2, mlp_in, mlp_out}`` and ``ln_out``;
each dense layer an ``nn.Linear`` ([out, in]), each layer norm a
``weight`` (the reference's ``scale``) and a ``bias``. A fresh encoder is
drawn as ``transformer_init`` draws it (:102-128), from one
``torch.Generator``: dense layers U(+-1/sqrt(in)), ``pos_embed``
0.02 * N(0, 1), layer norms scale 1 and bias 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from roko_tpu_torch.models.layers import dense, dropout, gelu, init_dense, layernorm


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, op for op as ``jax.nn.softmax`` writes
    it: ``exp(x - max)`` over its sum, each op rounded to x's dtype (the
    sum accumulated in float32 and rounded once, as ``jnp.sum`` does), and
    no gradient through the max (the reference's ``stop_gradient``)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Dense bidirectional multi-head attention (:37-52); q, k, v [B, T, D]
    -> [B, T, D]. The scale divides the scores after the product, by
    ``sqrt(head dim)`` as a constant of the scores' dtype."""
    B, T, D = q.shape
    hd = D // num_heads

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(B, T, num_heads, hd).transpose(1, 2)  # [B, H, T, hd]

    scores = torch.einsum("bhqd,bhkd->bhqk", heads(q), heads(k))
    scores = scores / torch.tensor(math.sqrt(hd), dtype=scores.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", softmax(scores), heads(v))
    return out.transpose(1, 2).reshape(B, T, D)


def _linear(in_dim: int, out_dim: int, generator: torch.Generator) -> nn.Linear:
    layer = skip_init(nn.Linear, in_dim, out_dim)
    init_dense(layer.weight, layer.bias, generator)
    return layer


class LayerNorm(nn.Module):
    """A layer norm's parameters, scale 1 and bias 0, applied by
    :func:`layers.layernorm` in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class EncoderLayer(nn.Module):
    """One pre-LN block (:55-99). q, k and v stay separate projections, as
    the reference keeps them."""

    def __init__(self, d_model: int, mlp_dim: int, num_heads: int, dropout: float,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.ln1 = LayerNorm(d_model)
        # the reference's draw order: q, k, v, proj, mlp_in, mlp_out
        self.q = _linear(d_model, d_model, generator)
        self.k = _linear(d_model, d_model, generator)
        self.v = _linear(d_model, d_model, generator)
        self.proj = _linear(d_model, d_model, generator)
        self.ln2 = LayerNorm(d_model)
        self.mlp_in = _linear(d_model, mlp_dim, generator)
        self.mlp_out = _linear(mlp_dim, d_model, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x + drop(proj(attention(LN1(x)))), then x + drop(mlp(LN2(x))); the
        dropouts in training only, their masks from ``generator``."""
        rate = self.dropout if self.training else 0.0
        h = self.ln1(x)
        a = attention(dense(h, self.q), dense(h, self.k), dense(h, self.v), self.num_heads)
        x = x + dropout(dense(a, self.proj), rate, generator)
        h = dense(gelu(dense(self.ln2(x), self.mlp_in)), self.mlp_out)
        return x + dropout(h, rate, generator)


class RokoTransformer(nn.Module):
    """The encoder of ``cfg`` (:102-151); ``cfg`` is the port's
    ``ModelConfig``. Raises the reference's two ``ValueError``s at
    construction."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.d_model
        if d != 2 * cfg.hidden_size:
            raise ValueError(
                f"d_model ({d}) must equal 2*hidden_size ({2 * cfg.hidden_size}) "
                "so the classification head is shared with the GRU family"
            )
        if d % cfg.num_heads:
            raise ValueError(f"d_model {d} not divisible by {cfg.num_heads} heads")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_proj = _linear(cfg.gru_in_size, d, generator)
        self.pos_embed = nn.Parameter(torch.empty(cfg.window_cols, d))
        with torch.no_grad():
            self.pos_embed.normal_(generator=generator).mul_(0.02)
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.mlp_ratio * d, cfg.num_heads, cfg.dropout, generator)
            for _ in range(cfg.num_layers)
        )
        self.ln_out = LayerNorm(d)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, gru_in_size] -> [B, T, d_model] in x's dtype; in training,
        dropout draws from ``generator``."""
        h = dense(x, self.in_proj)
        h = h + self.pos_embed[: h.shape[1]].to(h.dtype)
        for layer in self.layers:
            h = layer(h, generator)
        return self.ln_out(h)
