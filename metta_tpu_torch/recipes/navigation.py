"""Navigation recipe (stage-1 config: single-agent heart navigation);
counterpart of ``recipes/navigation.py``."""

from __future__ import annotations

from metta_tpu_torch.builder.envs import make_navigation
from metta_tpu_torch.rl.config import TrainerConfig
from metta_tpu_torch.tools.train import TrainTool


def train() -> TrainTool:
    return TrainTool(
        run="navigation",
        env=make_navigation(num_agents=4, width=16, height=16),
        trainer=TrainerConfig(
            batch_size=131072, minibatch_size=8192, bptt_horizon=64, num_envs=0,
            total_timesteps=20_000_000,
        ),
    )
