"""Model configuration of the port: the fields of
``roko_tpu.config.ModelConfig`` that the ``kind="gru"`` inference path
reads, with the same names and defaults."""

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
    num_classes: int = C.NUM_CLASSES

    def __post_init__(self) -> None:
        if self.kind != "gru":
            raise ValueError(
                f"model kind {self.kind!r} is not ported yet; the PyTorch "
                "port runs kind='gru'"
            )

    @property
    def gru_in_size(self) -> int:
        return self.embed_dim * self.read_mlp[-1]
