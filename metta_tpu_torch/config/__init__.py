from metta_tpu_torch.config.base import Config
from metta_tpu_torch.config.mettagrid_config import GameConfig, MettaGridConfig

__all__ = ["Config", "GameConfig", "MettaGridConfig"]
