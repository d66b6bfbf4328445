"""Arena recipe with shaped rewards.

Counterpart of ``recipes/arena_basic_easy_shaped.py`` (reference
``recipes/prod/arena_basic_easy_shaped.py``): the stable CI-validated arena
training recipe, the shaped inventory rewards and the reward-weight
curriculum buckets. The env and the curriculum are the port's builders
(``builder/envs.py:make_arena_basic_easy_shaped``, ``make_curriculum``).
``with_simulations`` and the eval, play and replay tools are not here: the
evaluator and the sequential product surface are not ported, and
``evaluate_interval`` is 0, so the simulations are never read.
"""

from __future__ import annotations

from typing import Optional

from metta_tpu_torch.builder import envs
from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.tools.train import TrainTool


def mettagrid(num_agents: int = 24) -> MettaGridConfig:
    return envs.make_arena_basic_easy_shaped(num_agents=num_agents)


def make_curriculum(arena_env: Optional[MettaGridConfig] = None):
    return envs.make_curriculum(arena_env or mettagrid())


def train() -> TrainTool:
    return TrainTool(run="arena").with_curriculum(make_curriculum())


def train_single_task() -> TrainTool:
    return TrainTool(run="arena_single", env=mettagrid())
