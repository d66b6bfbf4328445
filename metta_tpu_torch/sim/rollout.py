"""Evaluation rollouts.

Counterpart of ``metta_tpu/sim/rollout.py`` (reference
``mettagrid/simulator/multi_episode/rollout.py:58-140``): multi-policy
episodes with largest-remainder proportional agent assignment, reshuffled
per episode; per-episode rewards, stats and replays.

All requested episodes run as one env batch on the device (episode = env),
and the policies act on the whole [episodes x agents] slot batch each step.
The JAX package has two loops: a ``lax.scan`` on the device when every
policy is a ``NetworkPolicy`` and no replay is saved, which freezes each env
after its episode ends, and a host loop otherwise, which stops when every
episode has ended. With ``desync_episodes=False`` every env starts at step 0
and ends at the config's ``max_steps`` (``engine/step_batched.py``, the
truncation at ``step >= max_steps``), so both stop every env after the same
step. The port's one loop runs exactly that many steps, min(``max_steps``,
the config's ``max_steps``), and every episode counts each of them. It runs
on the device: the env state, the actions and the policies' state stay
there, and only the replay's episode 0 comes to the host, once a step, in
one transfer.

The rollout's random draws are made on the host from one CPU
``torch.Generator`` seeded with ``seed``: each step's agent orders, the
clipper's draws where the config runs it, and the reset's unclip protocols
on start-clipped maps. So one seed gives the same episodes on the CPU and on
the card (the JAX package's keys are device-independent in the same way);
the reset template of a start-clipped map is drawn by the env's generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.engine.clipper import ClipDraws, clipper_active, clipper_draws
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.engine.step import unclip_proto_draws
from metta_tpu_torch.engine.step_batched import random_perm
from metta_tpu_torch.policy.policy import MultiAgentPolicy
from metta_tpu_torch.utils.transfer import to_device


def compute_policy_agent_counts(num_agents: int, proportions: list[float]) -> list[int]:
    """Largest-remainder apportionment (rollout.py:40-55)."""
    total = sum(proportions)
    if total <= 0:
        raise ValueError("Total policy proportion must be positive.")
    fractions = [p / total for p in proportions]
    ideals = [num_agents * f for f in fractions]
    counts = [math.floor(x) for x in ideals]
    remaining = num_agents - sum(counts)
    remainders = sorted(
        ((i, ideals[i] - counts[i]) for i in range(len(fractions))),
        key=lambda x: x[1], reverse=True,
    )
    for i in range(remaining):
        counts[remainders[i][0]] += 1
    return counts


@dataclass
class EpisodeRolloutResult:
    assignments: np.ndarray      # [A] agent -> policy idx
    rewards: np.ndarray          # [A] float64
    stats: dict
    replay_path: Optional[str]
    steps: int
    max_steps: int


@dataclass
class MultiEpisodeRolloutResult:
    episodes: list[EpisodeRolloutResult] = field(default_factory=list)

    def rewards_by_policy(self, n_policies: int) -> list[float]:
        sums = np.zeros(n_policies)
        counts = np.zeros(n_policies)
        for ep in self.episodes:
            for a, p in enumerate(ep.assignments):
                sums[p] += ep.rewards[a]
                counts[p] += 1
        return (sums / np.maximum(counts, 1)).tolist()


def episode_stats(env: MettaGridEnv, e: int) -> dict:
    """Engine stat accumulators -> named stats (StatsTracker parity subset)."""
    s = env.env_state(e)
    compiled = env.compiled
    agent_stats = []
    for a in range(compiled.num_agents):
        d = {}
        for r, name in enumerate(compiled.resource_names):
            if s["agent_gained"][a, r]:
                d[f"{name}.gained"] = float(s["agent_gained"][a, r])
            if s["agent_lost"][a, r]:
                d[f"{name}.lost"] = float(s["agent_lost"][a, r])
            if s["agent_inv"][a, r]:
                d[f"{name}.amount"] = float(s["agent_inv"][a, r])
            if s["agent_chest_deposited"][a, r]:
                d[f"chest.{name}.deposited_by_agent"] = float(s["agent_chest_deposited"][a, r])
        d["status.steps_without_motion"] = float(s["agent_steps_without_motion"][a])
        agent_stats.append(d)
    game = {}
    for r, name in enumerate(compiled.resource_names):
        if s["game_chest_deposited"][r]:
            game[f"chest.{name}.deposited"] = float(s["game_chest_deposited"][r])
        if s["game_chest_withdrawn"][r]:
            game[f"chest.{name}.withdrawn"] = float(s["game_chest_withdrawn"][r])
        if s["game_asm_created"][r]:
            game[f"assembler.{name}.created"] = float(s["game_asm_created"][r])
    return {"game": game, "agent": agent_stats}


class RolloutDraws:
    """A rollout's draws from a CPU generator seeded with ``seed``, each put
    on the env's device: the reset's unclip protocols (start-clipped maps
    only) and each step's agent orders and clipper draws (configs that run
    the clipper only)."""

    def __init__(self, env: MettaGridEnv, seed: int):
        self.env = env
        self.generator = torch.Generator().manual_seed(seed)

    def reset_protos(self):
        env = self.env
        if not env._start_clipped:
            return None
        return to_device(unclip_proto_draws(env.tables, env.num_envs, self.generator), env.device)

    def step(self, t: int):
        """(perm [E, A], clip_draws or None) of step ``t``."""
        env = self.env
        perm = random_perm(env.num_envs, env.num_agents, self.generator)
        clip = None
        if clipper_active(env.tables):
            clip = ClipDraws(*(to_device(x, env.device)
                               for x in clipper_draws(env.tables, env.num_envs, self.generator)))
        return to_device(perm, env.device), clip


def multi_episode_rollout(
    env_cfg: MettaGridConfig,
    policies: list[MultiAgentPolicy],
    episodes: int,
    seed: int = 0,
    proportions: Optional[Sequence[float]] = None,
    save_replay: Optional[str] = None,
    max_steps_override: Optional[int] = None,
    step_mode: str = "batched",
    device="cuda",
) -> MultiEpisodeRolloutResult:
    """``step_mode`` defaults to the batched (rank-arbitrated) engine, as
    in the JAX package: eval semantics are identical up to multi-agent
    conflict ordering, which the reference randomizes per step anyway.
    ``device``: where the env runs (each ``NetworkPolicy`` runs on its
    own)."""
    env_cfg = env_cfg.model_copy(deep=True)
    env_cfg.desync_episodes = False
    env = MettaGridEnv(env_cfg, num_envs=episodes, seed=seed, desync_episodes=False,
                       step_mode=step_mode, device=device)
    A = env.num_agents
    E = episodes
    max_steps = max_steps_override or env.compiled.max_steps or 1000
    # every env ends after the config's max_steps (module docstring)
    n_steps = min(max_steps, env.tables.max_steps) if env.tables.max_steps > 0 else max_steps

    counts = compute_policy_agent_counts(
        A, list(proportions) if proportions is not None else [1.0] * len(policies)
    )
    base_assign = np.repeat(np.arange(len(policies)), counts)
    rng = np.random.default_rng(seed)
    assignments = np.stack([rng.permutation(base_assign) for _ in range(E)])  # [E, A]

    for p in policies:
        p.reset(E * A)

    replay = None
    writer = None
    if save_replay is not None:
        from metta_tpu_torch.sim.replay_writer import ReplayLogWriter

        writer = ReplayLogWriter(save_replay)
        replay = writer.new_episode(env, env_cfg)

    draws = RolloutDraws(env, seed)
    dev = env.device
    assign = to_device(torch.from_numpy(assignments.reshape(-1)), dev)          # [E*A]
    masks = [assign == i for i in range(len(policies))]
    # float64 sums of the float32 rewards, as the JAX host loop's numpy sums
    ep_rewards = torch.zeros((E, A), dtype=torch.float64, device=dev)

    obs = env.reset(unclip_proto=draws.reset_protos())
    for t in range(n_steps):
        obs_flat = obs.reshape(E * A, *obs.shape[2:])
        actions = torch.zeros((E * A,), dtype=torch.int32, device=dev)
        for mask, policy in zip(masks, policies):
            actions = torch.where(mask, policy.step_batch(obs_flat).to(dev), actions)
        actions = actions.reshape(E, A)
        perm, clip = draws.step(t)
        obs, rew, _done, _trunc = env.step_no_reset(actions, perm=perm, clip_draws=clip)
        ep_rewards += rew
        if replay is not None:
            replay.log_step(env.state.env, actions[0], env.state.env.action_success[0], rew[0])

    result = MultiEpisodeRolloutResult()
    replay_path = None
    if replay is not None and writer is not None:
        replay_path = writer.finish_episode(replay)
    rewards = ep_rewards.cpu().numpy()
    for e in range(E):
        result.episodes.append(
            EpisodeRolloutResult(
                assignments=assignments[e],
                rewards=rewards[e],
                stats=episode_stats(env, e),
                replay_path=replay_path if e == 0 else None,
                steps=n_steps,
                max_steps=max_steps,
            )
        )
    return result
