"""The roko consensus network, ``kind="gru"``.

Counterpart of ``roko_tpu/models/model.py``. Inference (``eval()``)
follows its inference branch (:179-231)::

    x: uint8[B,200,90] (0-11)
    one-hot(12) contracted with fc1 over the read axis  -> [B,90,12,100]
    embedding einsum, + fc1 bias, relu                  -> [B,90,50,100]
    fc2 100->10, relu, reshape                          -> [B,90,500]
    bidirectional GRU x3, h=128                         -> [B,90,256]
    fc4 256->5                                          -> logits [B,90,5]

The front end keeps the reference's reassociation: with a 12-word vocab,
``relu(E[x]^T @ W1 + b1)`` equals ``relu(E^T @ (onehot(x)^T @ W1) + b1)``,
two plain matrix products instead of a gather and a relayout.

Training (``train()``) follows the train branch (:144-178): the gather
``E[x]`` -> [B,200,90,50], dropout, fc1 over the read axis + bias, relu,
dropout, fc2, relu, dropout; then the GRU with dropout between layers.
The per-element dropout after the embedding is what rules the
reassociation out there. Dropout masks come from the ``generator`` the
caller passes, on the input's device.

A fresh model is drawn as ``RokoModel.init`` draws it (:91-106), from one
``torch.Generator``: embedding N(0, 1), dense layers U(+-1/sqrt(in)), GRU
orthogonal matrices and N(0, 1) biases. Module names (``embedding``,
``fc1``, ``fc2``, ``gru``, ``fc4``) are those of the reference ``.pth``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models.fused_gru import Recurrence, gru_recurrence
from roko_tpu_torch.models.gru import RokoGRU
from roko_tpu_torch.models.layers import dense, dropout, init_dense


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
        self.cfg = cfg = cfg or ModelConfig()
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
        self.gru = RokoGRU(
            cfg.gru_in_size, cfg.hidden_size, cfg.num_layers, cfg.dropout, generator
        )
        self.eval()

    def forward(
        self, x: torch.Tensor, recurrence: Recurrence = gru_recurrence,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """int[B, rows, cols] feature windows -> float32 logits
        [B, cols, num_classes]. In training, dropout draws from
        ``generator``."""
        h = self._front_train(x, generator) if self.training else self._front_eval(x)
        h = h.reshape(x.shape[0], self.cfg.window_cols, self.cfg.gru_in_size)
        h = self.gru(h, recurrence, generator)
        return dense(h, self.fc4.weight, self.fc4.bias)

    def _front_train(self, x: torch.Tensor, generator) -> torch.Tensor:
        """[B, rows, cols] -> [B, cols, D, read_mlp[-1]] with dropout."""
        rate = self.cfg.dropout
        e = dropout(self.embedding(x.long()), rate, generator)  # [B, R, T, D]
        h = torch.einsum("brtd,rj->btdj", e, self.fc1.weight.t())
        h = dropout(torch.relu(h + self.fc1.bias), rate, generator)
        h = torch.relu(dense(h, self.fc2.weight, self.fc2.bias))
        return dropout(h, rate, generator)

    def _front_eval(self, x: torch.Tensor) -> torch.Tensor:
        """The reassociated inference front end (no dropout)."""
        cfg = self.cfg
        dtype = self.fc1.weight.dtype
        vocab = torch.arange(cfg.embed_vocab, device=x.device, dtype=x.dtype)
        onehot = (x.unsqueeze(-1) == vocab).to(dtype)  # [B, R, T, V]
        m = torch.einsum("brtv,rj->btvj", onehot, self.fc1.weight.t())
        h = torch.einsum("vd,btvj->btdj", self.embedding.weight, m)
        h = torch.relu(h + self.fc1.bias)  # [B, T, D, J]
        return torch.relu(dense(h, self.fc2.weight, self.fc2.bias))
