from metta_tpu_torch.map_builder.map_builder import GameMap, MapBuilder, MapBuilderConfig
from metta_tpu_torch.map_builder.random_map import RandomMapBuilder

__all__ = ["GameMap", "MapBuilder", "MapBuilderConfig", "RandomMapBuilder"]
