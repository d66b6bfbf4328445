from metta_tpu_torch.builder import building
from metta_tpu_torch.builder.envs import make_arena, make_combat, make_curriculum, make_navigation

__all__ = ["building", "make_arena", "make_combat", "make_curriculum", "make_navigation"]
