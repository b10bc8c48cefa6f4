"""Configuration of the port: the fields of ``roko_tpu.config`` that the
``kind="gru"`` inference and training paths read, with the same names and
defaults (``ModelConfig``, ``TrainConfig`` and ``GuardConfig``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from roko_tpu_torch import constants as C


@dataclass(frozen=True)
class ModelConfig:
    kind: str = "gru"
    embed_vocab: int = C.FEATURE_VOCAB
    window_rows: int = C.WINDOW_ROWS
    window_cols: int = C.WINDOW_COLS
    embed_dim: int = 50
    read_mlp: Tuple[int, ...] = (100, 10)
    hidden_size: int = 128
    num_layers: int = 3
    #: inverted dropout after the embedding, fc1 and fc2 and between GRU
    #: layers, in training only
    dropout: float = 0.2
    num_classes: int = C.NUM_CLASSES

    def __post_init__(self) -> None:
        if self.kind != "gru":
            raise ValueError(
                f"model kind {self.kind!r} is not ported yet; the PyTorch "
                "port runs kind='gru'"
            )
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")

    @property
    def gru_in_size(self) -> int:
        return self.embed_dim * self.read_mlp[-1]


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation hyperparameters (``roko_tpu/config.py:191-219``)."""

    batch_size: int = 128
    epochs: int = 100
    lr: float = 1e-4
    #: epochs without a better val accuracy before the run stops
    patience: int = 7
    #: seeds the init, the epoch shuffles, the holdout and dropout
    seed: int = 0
    #: with no val set, hold out this fraction of the training windows
    #: (seeded split); 0 = no split, and then no early stopping
    val_fraction: float = 0.0
    #: best checkpoints kept by val accuracy, beside ``latest``
    keep_checkpoints: int = 3
    #: in-epoch heartbeat every N steps (0 disables)
    log_every_steps: int = 200


@dataclass(frozen=True)
class GuardConfig:
    """NaN/loss-spike sentinel (``roko_tpu/config.py:780-815``), on by
    default: a bad step's update is skipped, and ``max_bad_steps`` bad
    steps in a row roll the run back to its last good checkpoint."""

    enabled: bool = True
    #: a loss this many EMA standard deviations above the loss EMA is a spike
    spike_sigma: float = 6.0
    #: decay of the loss EMA and of its variance EMA
    ema_beta: float = 0.98
    #: good steps before spike detection arms (non-finite is armed at once)
    warmup_steps: int = 20
    #: consecutive skipped steps that trigger a rollback
    max_bad_steps: int = 3
    #: rollbacks after which the run gives up
    max_rollbacks: int = 3
