from metta_tpu_torch.mapgen.mapgen import MapGen, MapGenConfig
from metta_tpu_torch.mapgen.scene import Area, Scene, SceneConfig
from metta_tpu_torch.mapgen.scenes import Random

__all__ = ["Area", "MapGen", "MapGenConfig", "Random", "Scene", "SceneConfig"]
