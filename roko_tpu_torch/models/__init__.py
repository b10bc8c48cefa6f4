from roko_tpu_torch.models.gru import RokoGRU
from roko_tpu_torch.models.lingru import RokoLinGRU
from roko_tpu_torch.models.model import RokoModel

__all__ = ["RokoGRU", "RokoLinGRU", "RokoModel"]
