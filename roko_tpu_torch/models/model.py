"""The roko consensus network, ``kind="gru"`` and ``kind="lingru"``.

Counterpart of ``roko_tpu/models/model.py``. Inference (``eval()``)
follows its inference branch (:179-231)::

    x: uint8[B,200,90] (0-11)
    one-hot(12) contracted with fc1 over the read axis  -> [B,90,12,100]
    embedding einsum, + fc1 bias, relu                  -> [B,90,50,100]
    fc2 100->10, relu, reshape                          -> [B,90,500]
    bidirectional GRU or lingru x3, h=128               -> [B,90,256]
    fc4 256->5                                          -> logits [B,90,5]

``ModelConfig.kind`` picks the recurrence (:204-217); only that kind's
module is built (``gru`` or ``lingru``), so a state_dict holds one kind's
keys and a checkpoint of the other kind refuses to load.

The front end keeps the reference's reassociation: with a 12-word vocab,
``relu(E[x]^T @ W1 + b1)`` equals ``relu(E^T @ (onehot(x)^T @ W1) + b1)``,
two plain matrix products instead of a gather and a relayout.

Training (``train()``) follows the train branch (:144-178): the gather
``E[x]`` -> [B,200,90,50], dropout, fc1 over the read axis + bias, relu,
dropout, fc2, relu, dropout; then the recurrence with dropout between
layers.
The per-element dropout after the embedding is what rules the
reassociation out there. Dropout masks come from the ``generator`` the
caller passes, on the input's device. Training runs in the compute dtype
too: in bfloat16 the embedding rows, fc1 and fc2 (weights and biases),
the dropouts and the recurrence run in bf16 and the head in float32, as
the reference's train branch casts its params (:162-166). The embedding
rows are gathered from the float32 table and then rounded, bit for bit
the reference's one-hot contraction of its bf16 table; the table's
gradient sums in float32 and is rounded to bf16 once, as the transpose
of that contraction rounds it.

Inference runs in ``cfg.compute_dtype`` (resolved at construction;
"auto" is float32 off a TPU): in bfloat16 the one-hot, fc1, the
embedding, fc1's bias and fc2 and the recurrence run in bf16 (:133,
:179-217), and the head in float32 on the recurrence's output widened
(:230). Every matrix is fetched through ``layers.weight``, so a model
that ``models/quant.py`` quantized dequantizes each int8 matrix where it
feeds its product. The parameters stay float32 in every mode: each use
casts them, so their gradients come back in float32 (rounded to bf16 once
in a bf16 step, as the reference's are). Training refuses int8 weights.

A fresh model is drawn as ``RokoModel.init`` draws it (:91-106), from one
``torch.Generator``: embedding N(0, 1), dense layers U(+-1/sqrt(in)),
recurrent orthogonal matrices and N(0, 1) biases. Module names
(``embedding``, ``fc1``, ``fc2``, ``gru``, ``fc4``) are those of the
reference ``.pth``; ``kind="lingru"`` has ``lingru`` in place of ``gru``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models.gru import RokoGRU
from roko_tpu_torch.models.layers import dense, dropout, init_dense, jax_weight, weight
from roko_tpu_torch.models.lingru import RokoLinGRU


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to ``dtype`` once
    and widens it back: what the backward of a cast of a float32 parameter
    to ``dtype`` does, for a parameter used before its cast."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx.dtype = dtype
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype).to(g.dtype), None


class RokoModel(nn.Module):
    def __init__(
        self, cfg: Optional[ModelConfig] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``generator`` draws the initial parameters (default: a CPU
        generator seeded with 0). The model starts in eval mode, as
        ``apply`` defaults to ``deterministic=True``; ``train()`` turns
        dropout on."""
        super().__init__()
        self.cfg = cfg = (cfg or ModelConfig()).resolve()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # skip_init: no draw from torch's global generator
        self.embedding = skip_init(nn.Embedding, cfg.embed_vocab, cfg.embed_dim)
        self.fc1 = skip_init(nn.Linear, cfg.window_rows, cfg.read_mlp[0])
        self.fc2 = skip_init(nn.Linear, cfg.read_mlp[0], cfg.read_mlp[1])
        self.fc4 = skip_init(nn.Linear, 2 * cfg.hidden_size, cfg.num_classes)
        with torch.no_grad():
            self.embedding.weight.normal_(generator=generator)
            for layer in (self.fc1, self.fc2, self.fc4):
                init_dense(layer.weight, layer.bias, generator)
        args = (cfg.gru_in_size, cfg.hidden_size, cfg.num_layers, cfg.dropout, generator)
        if cfg.kind == "gru":
            self.gru = RokoGRU(*args)
        else:
            self.lingru = RokoLinGRU(*args)
        self.eval()

    def forward(
        self, x: torch.Tensor,
        recurrence: Optional[Callable[..., torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """int[B, rows, cols] feature windows -> float32 logits
        [B, cols, num_classes]. ``recurrence`` replaces the kind's
        kernel-backed one (``fused_gru.gru_recurrence_plain`` for gru,
        ``fused_lingru.lingru_scan_plain`` for lingru); None keeps it. In
        training, dropout draws from ``generator``."""
        if self.training:
            if self.cfg.quantize is not None:
                raise ValueError(
                    f"training runs on float weights; this model has quantize="
                    f"{self.cfg.quantize!r}, an inference-only conversion")
            h = self._front_train(x, generator)
        else:
            h = self._front_eval(x)
        h = h.reshape(x.shape[0], self.cfg.window_cols, self.cfg.gru_in_size)
        rnn = self.gru if self.cfg.kind == "gru" else self.lingru
        h = rnn(h, recurrence, generator)
        return dense(h.float(), self.fc4)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The resolved ``cfg.compute_dtype`` as a torch dtype."""
        return getattr(torch, self.cfg.compute_dtype)

    def _front_train(self, x: torch.Tensor, generator) -> torch.Tensor:
        """[B, rows, cols] -> [B, cols, D, read_mlp[-1]] with dropout, in
        the compute dtype."""
        rate = self.cfg.dropout
        dtype = self.compute_dtype
        # the rows of the f32 table, then the cast: an embedding of a bf16
        # table would sum the 2.3M rows of a batch into 12 with bf16 atomics
        table = self.embedding.weight
        if dtype != table.dtype:
            table = _RoundGrad.apply(table, dtype)
        e = dropout(F.embedding(x.long(), table).to(dtype), rate, generator)  # [B, R, T, D]
        w1 = weight(jax_weight(self.fc1, "weight"), dtype)  # [R, J]
        h = torch.einsum("brtd,rj->btdj", e, w1)
        h = dropout(torch.relu(h + self.fc1.bias.to(dtype)), rate, generator)
        h = torch.relu(dense(h, self.fc2))
        return dropout(h, rate, generator)

    def _front_eval(self, x: torch.Tensor) -> torch.Tensor:
        """The reassociated inference front end (no dropout), in the
        compute dtype."""
        cfg = self.cfg
        dtype = self.compute_dtype
        vocab = torch.arange(cfg.embed_vocab, device=x.device, dtype=x.dtype)
        onehot = (x.unsqueeze(-1) == vocab).to(dtype)  # [B, R, T, V]
        w1 = weight(jax_weight(self.fc1, "weight"), dtype)  # [R, J]
        m = torch.einsum("brtv,rj->btvj", onehot, w1)
        h = torch.einsum("vd,btvj->btdj", self.embedding.weight.to(dtype), m)
        h = torch.relu(h + self.fc1.bias.to(dtype))  # [B, T, D, J]
        return torch.relu(dense(h, self.fc2))
