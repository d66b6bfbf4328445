"""Vectorized MettaGrid environment on one torch device.

Counterpart of ``metta_tpu/engine/env.py:MettaGridEnv``. The batch is a
real leading dimension of every state tensor. Two step modes, as in the JAX
env:

- ``"sequential"`` (the default): the reference-exact step
  (``engine/step.py:step_env``), each env's agents one at a time in a
  shuffled order, with the render inside the step, by
  ``tables.obs_renderer``: the torch-ops renderer by default, kernel K5
  (``csrc/obs_render.cu``) with ``"pl"``. It is the only correct step for
  configs whose inventory limits couple resources.
- ``"batched"``: the rank-arbitrated step, then the token render: K1,
  ``csrc/obs_render3.cu``, where the JAX package's ``supports_v3`` holds for
  the config and E, else K4, ``csrc/obs_render2.cu``, as the JAX env picks
  its v3 or v2 TPU kernel (:func:`obs_renderer`). The step's interaction
  span is the fused kernel of ``csrc/sim_fused.cu`` wherever
  ``supports_fused`` holds, as in the JAX env, and the config fits the
  kernel's own maxima (``span_fits``); elsewhere, as with
  ``track_stats=True``, it is the torch-ops step, byte-identical. A config
  with coupled inventory limits or the assembler chest search falls back to
  the sequential step (``metta_tpu/engine/env.py:71-77``).

Each kernel runs on a GPU; on the CPU its plain version does.

Auto-reset: envs that terminate or truncate are reset in the same step call
and return the new episode's initial observations; start-clipped
assemblers take a fresh unclip protocol in each reset env. Episode desync
(reference ``envs/early_reset_handler.py:6-20``): the first episode of each
env is truncated at an independent random step.

Randomness comes from the env's ``torch.Generator``; the step and reset
calls take each draw as an optional input instead (``perm``, the clipper's
``clip_draws``, the reset's ``desync_step`` and ``unclip_proto``), which
tests use to feed the JAX env's draws and a GPU run the CPU run's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.engine.compiler import compile_game
from metta_tpu_torch.engine.state import EPISODE_INVARIANT, EnvState, VecEnvState
from metta_tpu_torch.engine.step import (
    int32_on,
    make_reset_batch,
    make_reset_template,
    starts_clipped,
    step_env,
    unclip_proto_draws,
    with_unclip_protos,
)
from metta_tpu_torch.engine.step_batched import check_supported, step_env_batched
from metta_tpu_torch.engine.tables import Tables, attach_static_block_grid
from metta_tpu_torch.ops.obs_render2 import rank_table, render_obs2
from metta_tpu_torch.ops.obs_render3 import prep_env3, render_obs3, supports_v3
from metta_tpu_torch.ops.sim_fused import fused_step_full, span_fits, supports_fused


def obs_renderer(tables, num_envs: int):
    """The batched render of an env of ``num_envs`` envs over ``tables``:
    ``render(env, tables, executed_action, rewards_at_obs)`` -> [E, A, T, 3]
    uint8, through K1 where ``supports_v3(tables, num_envs)`` holds, else
    through K4 (``metta_tpu/engine/env.py:112-151``). ``tables`` may be a
    task set's per-env view: the prep reads each env's own leaves."""
    T, wh, ww = tables.num_obs_tokens, tables.obs_height, tables.obs_width
    scan = tables.obs_scan
    if supports_v3(tables, num_envs):
        def render(env, t, ea, rw):
            return render_obs3(*prep_env3(env, t, ea, rw), scan, T, wh // 2, ww // 2)
    else:
        rank = rank_table(scan, ww)

        def render(env, t, ea, rw):
            return render_obs2(*prep_env3(env, t, ea, rw), rank, T, wh, ww)
    return render


class MettaGridEnv:
    """Batched MettaGrid on a torch device.

    Args:
      cfg: environment config.
      num_envs: batch size E.
      seed: seed of the env's ``torch.Generator`` (agent orders, desync).
      desync_episodes: truncate each env's first episode at a random step.
      track_stats: keep the gained/lost/chest stat accumulators.
      template_unclip_proto: [NA] unclip protocols of the start-clipped
        assemblers in the reset template (its obs show them), else drawn
        from the generator; tests pass the JAX template's.
      step_mode: "sequential" (the reference-exact agent loop) or "batched"
        (rank arbitration; falls back to "sequential" for configs with
        coupled inventory limits or chest search, which the sequential
        step then refuses).
      device: where the state lives and the step runs; "cuda" by default.
    """

    def __init__(
        self,
        cfg: MettaGridConfig,
        num_envs: int = 1,
        seed: int = 0,
        desync_episodes: Optional[bool] = None,
        track_stats: bool = True,
        step_mode: str = "sequential",
        device="cuda",
        template_unclip_proto=None,
    ):
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = torch.device(device)
        self.game_map = cfg.game.map_builder.create().build()
        self.compiled, self._init = compile_game(cfg.game, self.game_map)
        self.tables = Tables(self.compiled, track_stats=track_stats, device=self.device)
        if step_mode == "batched" and (not self.tables.inv_vector_ok
                                       or self.tables.chest_search_distance > 0):
            step_mode = "sequential"
        check_supported(self.tables, step_mode)
        self.step_mode = step_mode
        self.desync = cfg.desync_episodes if desync_episodes is None else desync_episodes
        self.single_observation_space_shape = (self.compiled.num_obs_tokens, 3)
        self.num_agents = self.compiled.num_agents
        self.action_names = self.compiled.action_names

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._start_clipped = starts_clipped(self.tables, self._init)
        if self._start_clipped and template_unclip_proto is None:
            template_unclip_proto = unclip_proto_draws(self.tables, 1, self.generator,
                                                       self.device)[0]
        self._template = make_reset_template(self.tables, self._init, template_unclip_proto)
        attach_static_block_grid(self.tables, self._template[0])
        if step_mode == "batched":
            # the kernel's own maxima decide too: past them the torch-ops
            # step, byte-identical, takes the config before the first step
            fused = supports_fused(self.tables) and span_fits(self.tables)
            self._sim_step = fused_step_full if fused else step_env_batched
            self._render = obs_renderer(self.tables, num_envs)
        self._state: Optional[VecEnvState] = None

    # ------------------------------------------------------------------
    # functional API
    # ------------------------------------------------------------------

    def _reset_protos(self, unclip_proto=None):
        """[E, NA] unclip protocols for reset envs' start-clipped assemblers
        (``unclip_proto`` if given, else drawn), None on maps without them."""
        if not self._start_clipped:
            return None
        if unclip_proto is None:
            return unclip_proto_draws(self.tables, self.num_envs, self.generator, self.device)
        return int32_on(unclip_proto, self.device)

    def reset_state(self, desync_step=None, unclip_proto=None):
        """-> (VecEnvState, obs [E, A, T, 3] uint8).

        ``desync_step`` [E] and ``unclip_proto`` [E, NA] override the desync
        and start-clipped protocol draws (tests pass the JAX env's draws); by
        default they come from the env's generator."""
        E = self.num_envs
        t = self.tables
        env, obs = make_reset_batch(self._template, E, self._reset_protos(unclip_proto))
        if desync_step is not None:
            if not isinstance(desync_step, torch.Tensor):
                desync_step = torch.as_tensor(np.array(desync_step))
            desync = desync_step.to(device=self.device, dtype=torch.int32)
        elif self.desync and t.max_steps > 0:
            desync = torch.randint(1, t.max_steps, (E,), generator=self.generator,
                                   device=self.device, dtype=torch.int32)
        else:
            desync = torch.zeros((E,), dtype=torch.int32, device=self.device)
        return VecEnvState(
            env=env,
            desync_step=desync,
            episode_len=torch.zeros((E,), dtype=torch.int32, device=self.device),
            last_episode_reward=torch.zeros((E, t.num_agents), dtype=torch.float32,
                                            device=self.device),
            last_episode_gained=torch.zeros((E, t.num_resources), dtype=torch.float32,
                                            device=self.device),
        ), obs

    def _stepped(self, env: EnvState, actions, perm=None, clip_draws=None):
        """Sim step + obs render -> (env, obs): the sequential step with its
        own render, or the batched step and the batched render."""
        if self.step_mode == "sequential":
            return step_env(env, actions, self.tables, perm=perm, generator=self.generator,
                            clip_draws=clip_draws)
        env, rew_at_obs = self._sim_step(env, actions, self.tables, perm=perm,
                                         generator=self.generator, clip_draws=clip_draws)
        return env, self._render(env, self.tables, env.executed_action, rew_at_obs)

    def step_state(self, vstate: VecEnvState, actions, perm=None, clip_draws=None,
                   unclip_proto=None):
        """(VecEnvState, actions [E, A]) -> (VecEnvState, obs, rew, done, trunc),
        auto-resetting ended envs. ``perm``, ``clip_draws`` and
        ``unclip_proto`` (the reset envs' start-clipped protocols, [E, NA])
        override the generator's draws."""
        env, obs = self._stepped(vstate.env, actions, perm, clip_draws)
        force_trunc = (vstate.desync_step > 0) & (env.step >= vstate.desync_step)
        truncated = env.truncated | force_trunc
        done = env.done
        ended = done | truncated
        rewards = env.reward
        A = self.tables.num_agents
        episode_len = torch.where(ended, env.step, vstate.episode_len)
        last_reward = torch.where(ended[:, None], env.episode_reward,
                                  vstate.last_episode_reward)
        gained_mean = env.agent_gained.to(torch.float32).sum(1) / A
        last_gained = torch.where(ended[:, None], gained_mean, vstate.last_episode_gained)

        # auto-reset ended envs from the template; fields invariant across
        # episodes of one map pass through
        template, template_obs = self._template
        protos = self._reset_protos(unclip_proto)

        def reset_field(name):
            old = getattr(env, name)
            if name in EPISODE_INVARIANT:
                return old
            new = getattr(template, name)
            if name == "asm_unclip_proto" and protos is not None:
                new = with_unclip_protos(template, protos)
            mask = ended.reshape((-1,) + (1,) * (old.dim() - 1))
            return torch.where(mask, new, old)

        env = EnvState(**{f.name: reset_field(f.name) for f in dataclasses.fields(EnvState)})
        obs = torch.where(ended[:, None, None, None], template_obs, obs)
        vstate = VecEnvState(
            env=env,
            desync_step=torch.where(ended, torch.zeros_like(vstate.desync_step),
                                    vstate.desync_step),
            episode_len=episode_len,
            last_episode_reward=last_reward,
            last_episode_gained=last_gained,
        )
        return vstate, obs, rewards, done, truncated

    def step_no_reset_state(self, vstate: VecEnvState, actions, perm=None, clip_draws=None):
        """Evaluation stepping: no auto-reset; the terminal state (and its
        episode stats) stays readable after the episode ends."""
        env, obs = self._stepped(vstate.env, actions, perm, clip_draws)
        return vstate.replace(env=env), obs, env.reward, env.done, env.truncated

    # ------------------------------------------------------------------
    # stateful API (tests, eval, play); tensors stay on the device
    # ------------------------------------------------------------------

    def _actions(self, actions):
        actions = torch.as_tensor(actions, device=self.device).to(torch.int32)
        return actions[None, :] if actions.dim() == 1 else actions

    def reset(self, desync_step=None, unclip_proto=None):
        self._state, obs = self.reset_state(desync_step, unclip_proto)
        return obs

    def _require_reset(self):
        if self._state is None:
            raise RuntimeError("call reset() first")

    def step(self, actions, perm=None, clip_draws=None, unclip_proto=None):
        self._require_reset()
        self._state, obs, rew, done, trunc = self.step_state(
            self._state, self._actions(actions), perm, clip_draws, unclip_proto)
        return obs, rew, done, trunc

    def step_no_reset(self, actions, perm=None, clip_draws=None):
        self._require_reset()
        self._state, obs, rew, done, trunc = self.step_no_reset_state(
            self._state, self._actions(actions), perm, clip_draws)
        return obs, rew, done, trunc

    # --- inspection helpers (parity with MettaGrid debug accessors) ---

    @property
    def state(self) -> VecEnvState:
        return self._state

    def env_state(self, e: int = 0) -> dict:
        """Single-env view of the batched state (host numpy copies)."""
        return {f.name: getattr(self._state.env, f.name)[e].cpu().numpy()
                for f in dataclasses.fields(EnvState)}

    def action_success(self, e: int = 0):
        return self._state.env.action_success[e].cpu().numpy()

    def episode_rewards(self, e: int = 0):
        return self._state.env.episode_reward[e].cpu().numpy()

    def resource_id(self, name: str) -> int:
        return self.compiled.resource_names.index(name)

    def vibe_id(self, name: str) -> int:
        return self.compiled.vibe_names.index(name)

    def set_agent_inventory(self, agent: int, inventory: dict, e: int = 0):
        """Replace the agent's inventory with {resource_name: amount}
        (parity: MettaGrid::set_inventory)."""
        row = np.zeros((self.compiled.num_resources,), np.int32)
        for name, amt in inventory.items():
            row[self.resource_id(name)] = amt
        inv = self._state.env.agent_inv.clone()
        inv[e, agent] = torch.as_tensor(row, device=self.device)
        self._state = self._state.replace(env=self._state.env.replace(agent_inv=inv))

    def agent_inventory(self, agent: int, e: int = 0) -> dict:
        row = self._state.env.agent_inv[e, agent].cpu().numpy()
        return {
            n: int(row[i]) for i, n in enumerate(self.compiled.resource_names) if row[i] != 0
        }

    def set_agent_vibe(self, agent: int, vibe, e: int = 0):
        v = self.vibe_id(vibe) if isinstance(vibe, str) else int(vibe)
        vibes = self._state.env.agent_vibe.clone()
        vibes[e, agent] = v
        self._state = self._state.replace(env=self._state.env.replace(agent_vibe=vibes))

    def chest_inventory(self, chest: int = 0, e: int = 0) -> dict:
        row = self._state.env.chest_inv[e, chest].cpu().numpy()
        return {
            n: int(row[i]) for i, n in enumerate(self.compiled.resource_names) if row[i] != 0
        }
