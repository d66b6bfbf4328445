"""PettingZoo parallel-API adapter.

Counterpart of ``metta_tpu/envs/pettingzoo_env.py`` (reference
``mettagrid/envs/pettingzoo_env.py``): one env instance, the sequential
step at E=1, through the PettingZoo ParallelEnv conventions (dict-keyed
per-agent observations and rewards) for interop with external MARL
tooling. The env runs on ``device`` (the card by default); each call's
outputs come to the host as numpy arrays and Python scalars in one
transfer. Spaces are gymnasium's where it is installed, else plain dicts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.utils.transfer import to_host


class PettingZooEnv:
    metadata = {"name": "mettagrid_tpu"}

    def __init__(self, cfg: MettaGridConfig, seed: int = 0, device="cuda"):
        self._env = MettaGridEnv(cfg, num_envs=1, desync_episodes=False, device=device)
        self._seed = seed
        self.possible_agents = [f"agent_{i}" for i in range(self._env.num_agents)]
        self.agents = list(self.possible_agents)

    @property
    def num_agents(self) -> int:
        return len(self.agents)

    def observation_space(self, agent: str):
        try:
            import gymnasium as gym

            return gym.spaces.Box(0, 255, shape=self._env.single_observation_space_shape,
                                  dtype=np.uint8)
        except ImportError:
            return {"shape": self._env.single_observation_space_shape, "dtype": "uint8"}

    def action_space(self, agent: str):
        try:
            import gymnasium as gym

            return gym.spaces.Discrete(self._env.compiled.n_actions)
        except ImportError:
            return {"n": self._env.compiled.n_actions}

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        self._env.generator.manual_seed(self._seed if seed is None else seed)
        obs = self._env.reset().cpu().numpy()
        self.agents = list(self.possible_agents)
        observations = {a: obs[0, i] for i, a in enumerate(self.agents)}
        infos = {a: {} for a in self.agents}
        return observations, infos

    def step(self, actions: dict):
        acts = np.array(
            [[actions.get(a, 0) for a in self.possible_agents]], dtype=np.int32
        )
        out = dict(zip(("obs", "rew", "done", "trunc"), self._env.step(acts)))
        out = to_host(out)
        obs, rew, done, trunc = out["obs"], out["rew"], out["done"], out["trunc"]
        observations = {a: obs[0, i] for i, a in enumerate(self.possible_agents)}
        rewards = {a: float(rew[0, i]) for i, a in enumerate(self.possible_agents)}
        terminations = {a: bool(done[0]) for a in self.possible_agents}
        truncations = {a: bool(trunc[0]) for a in self.possible_agents}
        infos = {a: {} for a in self.possible_agents}
        if done[0] or trunc[0]:
            self.agents = []
        return observations, rewards, terminations, truncations, infos

    def close(self):
        pass
