"""The roko consensus network, ``kind="gru"``, ``"lingru"`` and ``"transformer"``.

Counterpart of ``roko_tpu/models/model.py``. Inference (``eval()``)
follows its inference branch (:179-231)::

    x: uint8[B,200,90] (0-11)
    one-hot(12) contracted with fc1 over the read axis  -> [B,90,12,100]
    embedding einsum, + fc1 bias, relu                  -> [B,90,50,100]
    fc2 100->10, relu, reshape                          -> [B,90,500]
    bidirectional GRU or lingru x3, h=128,
    or the transformer encoder (3 layers, d_model 256)  -> [B,90,256]
    fc4 256->5                                          -> logits [B,90,5]

``ModelConfig.kind`` picks the sequence block (:204-228); only that
kind's module is built (``gru``, ``lingru`` or ``encoder``,
``models/transformer.py``), so a state_dict holds one kind's keys and a
checkpoint of another kind refuses to load. The gru and lingru blocks
run the port's CUDA kernels on a card; the transformer's products are
plain matrix products and it launches none.

The front end keeps the reference's reassociation: with a 12-word vocab,
``relu(E[x]^T @ W1 + b1)`` equals ``relu(E^T @ (onehot(x)^T @ W1) + b1)``,
two plain matrix products instead of a gather and a relayout.

Training (``train()``) follows the train branch (:144-178): the gather
``E[x]`` -> [B,200,90,50], dropout, fc1 over the read axis + bias, relu,
dropout, fc2, relu, dropout; then the recurrence with dropout between
layers, or the encoder with dropout after each attention and MLP block.
The per-element dropout after the embedding is what rules the
reassociation out there. Dropout masks come from the ``generator`` the
caller passes, on the input's device. Training runs in the compute dtype
too: in bfloat16 the embedding rows, fc1 and fc2 (weights and biases),
the dropouts and the recurrence or encoder run in bf16 and the head in
float32, as the reference's train branch casts its params (:162-166). The embedding
rows are gathered from the float32 table and then rounded, bit for bit
the reference's one-hot contraction of its bf16 table; the table's
gradient sums in float32 and is rounded to bf16 once, as the transpose
of that contraction rounds it.

Inference runs in ``cfg.compute_dtype`` (resolved at construction;
"auto" is float32 off a TPU): in bfloat16 the one-hot, fc1, the
embedding, fc1's bias and fc2 and the recurrence run in bf16 (:133,
:179-217); the encoder runs in bf16 with every one of its parameters
cast, its layer norms' and ``pos_embed`` included, as
``cast_tree(params["encoder"], dtype)`` casts them (:218-228); the head
runs in float32 on the sequence block's output widened (:230). Every
matrix is fetched through ``layers.weight``, so a model that
``models/quant.py`` quantized dequantizes each int8 matrix where it
feeds its product. The parameters stay float32 in every mode: each use
casts them, so their gradients come back in float32 (rounded to bf16 once
in a bf16 step, as the reference's are). Training refuses int8 weights.

A fresh model is drawn as ``RokoModel.init`` draws it (:91-106), from one
``torch.Generator``: embedding N(0, 1), dense layers U(+-1/sqrt(in)),
recurrent orthogonal matrices and N(0, 1) biases (the encoder's draws:
``models/transformer.py``). Module names (``embedding``, ``fc1``,
``fc2``, ``gru``, ``fc4``) are those of the reference ``.pth``;
``kind="lingru"`` has ``lingru`` in place of ``gru``, and
``kind="transformer"`` ``encoder``.

On a ``mesh`` (``parallel/``) the transformer is split: with tp above 1
the encoder holds this rank's part of the Megatron split, and with sp
above 1 the whole forward runs on this rank's block of the pileup
columns (:attr:`RokoModel.columns`): every op but the attention acts on
one column, so rank s takes columns ``[s * T / sp, (s + 1) * T / sp)`` of
the windows, runs the ring attention, and returns logits for its
columns, as the reference's ``shard_map`` specs ``P(dp, sp, None)`` ask.
In training, a :class:`~roko_tpu_torch.models.layers.GlobalSlice`
generator cuts each mask from the global batch's, the column axis by
site: 2 for the embedding's ``[B, R, T, D]``, 1 for ``[B, T, D, J]``
and the encoder's ``[B, T, d]``. The gru and lingru kinds replicate over
tp and sp. ``attn`` injects an attention into the transformer, as the
reference's ``attn_fn`` (:57-66, :227).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models.gru import RokoGRU
from roko_tpu_torch.models.layers import (
    dense,
    dropout,
    init_dense,
    jax_weight,
    on_column_axis,
    weight,
)
from roko_tpu_torch.models.lingru import RokoLinGRU
from roko_tpu_torch.models.transformer import Attention, RokoTransformer
from roko_tpu_torch.parallel.mesh import Mesh
from roko_tpu_torch.parallel.ring import column_block


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
        *, mesh: Optional[Mesh] = None, attn: Optional[Attention] = None,
    ):
        """``generator`` draws the initial parameters (default: a CPU
        generator seeded with 0). The model starts in eval mode, as
        ``apply`` defaults to ``deterministic=True``; ``train()`` turns
        dropout on. ``mesh`` splits a transformer over its tp and sp axes;
        ``attn`` replaces the transformer's attention."""
        super().__init__()
        self.cfg = cfg = (cfg or ModelConfig()).resolve()
        self.mesh = mesh
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
        elif cfg.kind == "lingru":
            self.lingru = RokoLinGRU(*args)
        else:
            self.encoder = RokoTransformer(cfg, generator, mesh, attn)
        #: the block of pileup columns this rank computes
        self.columns = (column_block(mesh, cfg.window_cols)
                        if cfg.kind == "transformer" and mesh is not None and mesh.sp > 1
                        else slice(0, cfg.window_cols))
        self.eval()

    def forward(
        self, x: torch.Tensor,
        recurrence: Optional[Callable[..., torch.Tensor]] = None,
        generator=None,
    ) -> torch.Tensor:
        """int[B, rows, cols] feature windows -> float32 logits
        [B, cols, num_classes] (the columns of :attr:`columns`).
        ``recurrence`` replaces the kind's
        kernel-backed one (``fused_gru.gru_recurrence_plain`` for gru,
        ``fused_lingru.lingru_scan_plain`` for lingru); None keeps it. The
        transformer has no recurrence to replace, and refuses one. In
        training, dropout draws from ``generator``: a ``torch.Generator``
        or a :class:`~roko_tpu_torch.models.layers.GlobalSlice`."""
        if self.cfg.kind == "transformer" and recurrence is not None:
            raise ValueError("kind='transformer' has no recurrence to replace; "
                             "recurrence= applies to gru and lingru")
        x = x[:, :, self.columns]
        if self.training:
            if self.cfg.quantize is not None:
                raise ValueError(
                    f"training runs on float weights; this model has quantize="
                    f"{self.cfg.quantize!r}, an inference-only conversion")
            h = self._front_train(x, generator)
        else:
            h = self._front_eval(x)
        h = h.reshape(x.shape[0], x.shape[2], self.cfg.gru_in_size)
        if self.cfg.kind == "transformer":
            h = self.encoder(h, generator, self.columns.start)
        else:
            rnn = self.gru if self.cfg.kind == "gru" else self.lingru
            h = rnn(h, recurrence, generator)
        return dense(h.float(), self.fc4)

    @property
    def column_split(self) -> bool:
        """True when the forward computes a block of the columns (a
        transformer on a mesh whose sp axis is above 1)."""
        return self.columns.stop - self.columns.start != self.cfg.window_cols

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
        e = F.embedding(x.long(), table).to(dtype)  # [B, R, T, D]: its columns on axis 2
        e = dropout(e, rate, on_column_axis(generator, 2))
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
