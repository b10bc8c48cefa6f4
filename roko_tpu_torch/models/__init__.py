from roko_tpu_torch.models.gru import RokoGRU
from roko_tpu_torch.models.model import RokoModel

__all__ = ["RokoGRU", "RokoModel"]
