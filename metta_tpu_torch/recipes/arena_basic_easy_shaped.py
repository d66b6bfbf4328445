"""Arena recipe with shaped rewards.

Counterpart of ``recipes/arena_basic_easy_shaped.py`` (reference
``recipes/prod/arena_basic_easy_shaped.py``): the stable CI-validated arena
training and eval recipe, the shaped inventory rewards, the reward-weight
curriculum buckets and the basic/combat eval pair. The env and the
curriculum are the port's builders
(``builder/envs.py:make_arena_basic_easy_shaped``, ``make_curriculum``).
"""

from __future__ import annotations

from typing import Optional

from metta_tpu_torch.builder import envs
from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.sim.runner import SimulationConfig
from metta_tpu_torch.tools.evaluate import EvaluateTool
from metta_tpu_torch.tools.play import PlayTool, ReplayTool
from metta_tpu_torch.tools.train import TrainTool


def mettagrid(num_agents: int = 24) -> MettaGridConfig:
    return envs.make_arena_basic_easy_shaped(num_agents=num_agents)


def make_curriculum(arena_env: Optional[MettaGridConfig] = None):
    return envs.make_curriculum(arena_env or mettagrid())


def simulations(env: Optional[MettaGridConfig] = None) -> list[SimulationConfig]:
    basic_env = env or mettagrid()
    basic_env.game.actions.attack.consumed_resources["laser"] = 100
    combat_env = basic_env.model_copy(deep=True)
    combat_env.game.actions.attack.consumed_resources["laser"] = 1
    return [
        SimulationConfig(suite="arena", name="basic", env=basic_env, episodes=4),
        SimulationConfig(suite="arena", name="combat", env=combat_env, episodes=4),
    ]


def train() -> TrainTool:
    tool = TrainTool(run="arena")
    tool.with_curriculum(make_curriculum())
    tool.with_simulations(simulations())
    return tool


def train_single_task() -> TrainTool:
    return TrainTool(run="arena_single", env=mettagrid())


def evaluate(policy_uri: str = "") -> EvaluateTool:
    return EvaluateTool(policy_uri=policy_uri).with_simulations(simulations())


def play() -> PlayTool:
    return PlayTool(env=mettagrid())


def replay() -> ReplayTool:
    return ReplayTool(env=mettagrid())
