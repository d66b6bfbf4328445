"""Evaluation suite runner.

Counterpart of ``metta_tpu/sim/runner.py`` (reference
``metta/sim/runner.py:46-118``, where ``run_simulations`` fans a list of
SimulationConfigs over a process pool): each simulation's episode batch is
one env batch on the device, so the fan-out is the batch dimension and the
simulations run back to back on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from metta_tpu_torch.config.base import Config
from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.policy.policy import MultiAgentPolicy
from metta_tpu_torch.sim.rollout import MultiEpisodeRolloutResult, multi_episode_rollout


class SimulationConfig(Config):
    suite: str = "eval"
    name: str
    env: MettaGridConfig
    episodes: int = 8
    max_steps: Optional[int] = None


@dataclass
class SimulationResult:
    suite: str
    name: str
    rollout: MultiEpisodeRolloutResult
    # aggregates
    mean_reward: float = 0.0
    mean_reward_by_policy: list = field(default_factory=list)
    mean_stats: dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.suite}/{self.name}"


def aggregate_stats(rollout: MultiEpisodeRolloutResult) -> dict:
    """Mean per-agent stats across episodes (env_agent/* namespace parity)."""
    sums: dict[str, float] = {}
    n_agents = 0
    for ep in rollout.episodes:
        for agent_stats in ep.stats["agent"]:
            n_agents += 1
            for k, v in agent_stats.items():
                sums[k] = sums.get(k, 0.0) + v
    return {k: v / max(n_agents, 1) for k, v in sums.items()}


def run_simulations(
    policies: Sequence[MultiAgentPolicy],
    simulations: Sequence[SimulationConfig],
    seed: int = 0,
    proportions: Optional[Sequence[float]] = None,
    replay_dir: Optional[str] = None,
    device="cuda",
) -> list[SimulationResult]:
    results = []
    for sim in simulations:
        rollout = multi_episode_rollout(
            sim.env,
            list(policies),
            episodes=sim.episodes,
            seed=seed,
            proportions=proportions,
            save_replay=replay_dir,
            max_steps_override=sim.max_steps,
            device=device,
        )
        rewards = np.stack([ep.rewards for ep in rollout.episodes])
        results.append(
            SimulationResult(
                suite=sim.suite,
                name=sim.name,
                rollout=rollout,
                mean_reward=float(rewards.mean()),
                mean_reward_by_policy=rollout.rewards_by_policy(len(policies)),
                mean_stats=aggregate_stats(rollout),
            )
        )
    return results
