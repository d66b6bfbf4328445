"""Cogs-vs-Clips production recipe.

Counterpart of ``recipes/prod/cogs_v_clips.py`` (reference
``recipes/prod/cvc`` and ``experiment/cogs_v_clips.py``): a learning-progress
curriculum over a cogames mission (4 cogs, 24x24, 512 steps) with buckets on
the heart reward and on ``max_steps``, trained through the port's
``TrainTool``, and the two-mission evaluation. Same names and defaults.

Two tasks whose ``max_steps`` differ are not one shape class, so the tool
trains such a pool by whole-batch task swaps, as the JAX tool does; a pool
that varies the heart reward alone trains as one task set.

    python -m metta_tpu_torch.tools.run metta_tpu_torch.recipes.prod.cogs_v_clips.train
"""

from __future__ import annotations

from metta_tpu_torch.cogames.missions import make_mission
from metta_tpu_torch.cogworks.curriculum import LearningProgressConfig, bucketed
from metta_tpu_torch.sim.runner import SimulationConfig
from metta_tpu_torch.tools.evaluate import EvaluateTool
from metta_tpu_torch.tools.train import TrainTool


def mettagrid(mission: str = "training_grounds", num_cogs: int = 4):
    return make_mission(mission, num_agents=num_cogs, width=24, height=24, max_steps=512)


def make_curriculum(mission: str = "training_grounds", num_cogs: int = 4):
    tasks = bucketed(mettagrid(mission, num_cogs))
    tasks.add_bucket("game.agent.rewards.inventory.heart", [0.5, 1.0])
    tasks.add_bucket("game.max_steps", [256, 512])
    return tasks.to_curriculum(algorithm_config=LearningProgressConfig())


def simulations(num_cogs: int = 4) -> list[SimulationConfig]:
    return [
        SimulationConfig(suite="cvc", name=m, env=mettagrid(m, num_cogs), episodes=2)
        for m in ("training_grounds", "basic")
    ]


def train(mission: str = "training_grounds", num_cogs: int = 4) -> TrainTool:
    tool = TrainTool(run=f"cvc_{mission}")
    tool.with_curriculum(make_curriculum(mission, num_cogs))
    tool.with_simulations(simulations(num_cogs))
    return tool


def evaluate(policy_uri: str = "") -> EvaluateTool:
    return EvaluateTool(policy_uri=policy_uri).with_simulations(simulations())
