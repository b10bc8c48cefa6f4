"""The roko consensus network in inference mode, ``kind="gru"``.

Counterpart of the inference branch of ``roko_tpu/models/model.py``
(:179-231)::

    x: uint8[B,200,90] (0-11)
    one-hot(12) contracted with fc1 over the read axis  -> [B,90,12,100]
    embedding einsum, + fc1 bias, relu                  -> [B,90,50,100]
    fc2 100->10, relu, reshape                          -> [B,90,500]
    bidirectional GRU x3, h=128                         -> [B,90,256]
    fc4 256->5                                          -> logits [B,90,5]

The front end keeps the reference's reassociation: with a 12-word vocab,
``relu(E[x]^T @ W1 + b1)`` equals ``relu(E^T @ (onehot(x)^T @ W1) + b1)``,
two plain matrix products instead of a gather and a relayout. Module
names (``embedding``, ``fc1``, ``fc2``, ``gru``, ``fc4``) are those of the
reference ``.pth``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models.fused_gru import Recurrence, gru_recurrence
from roko_tpu_torch.models.gru import RokoGRU
from roko_tpu_torch.models.layers import dense


class RokoModel(nn.Module):
    def __init__(self, cfg: Optional[ModelConfig] = None):
        super().__init__()
        self.cfg = cfg = cfg or ModelConfig()
        self.embedding = nn.Embedding(cfg.embed_vocab, cfg.embed_dim)
        self.fc1 = nn.Linear(cfg.window_rows, cfg.read_mlp[0])
        self.fc2 = nn.Linear(cfg.read_mlp[0], cfg.read_mlp[1])
        self.gru = RokoGRU(cfg.gru_in_size, cfg.hidden_size, cfg.num_layers)
        self.fc4 = nn.Linear(2 * cfg.hidden_size, cfg.num_classes)

    def forward(
        self, x: torch.Tensor, recurrence: Recurrence = gru_recurrence
    ) -> torch.Tensor:
        """int[B, rows, cols] feature windows -> float32 logits
        [B, cols, num_classes]."""
        cfg = self.cfg
        dtype = self.fc1.weight.dtype
        vocab = torch.arange(cfg.embed_vocab, device=x.device, dtype=x.dtype)
        onehot = (x.unsqueeze(-1) == vocab).to(dtype)  # [B, R, T, V]
        m = torch.einsum("brtv,rj->btvj", onehot, self.fc1.weight.t())
        h = torch.einsum("vd,btvj->btdj", self.embedding.weight, m)
        h = torch.relu(h + self.fc1.bias)  # [B, T, D, J]
        h = torch.relu(dense(h, self.fc2.weight, self.fc2.bias))
        h = h.reshape(x.shape[0], cfg.window_cols, cfg.gru_in_size)
        h = self.gru(h, recurrence)
        return dense(h, self.fc4.weight, self.fc4.bias)
