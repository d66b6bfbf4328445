"""Multi-task vectorized environment: per-env, per-episode curriculum tasks.

Counterpart of ``metta_tpu/engine/taskset.py`` (reference ``CurriculumEnv``,
``cogworks/curriculum/curriculum_env.py``: every env swaps its task, a whole
env config, at each episode boundary, drawn from the curriculum's weights).

A task set is K compiled configs whose :class:`Tables` are stacked along a
leading axis (``engine/tables.py:stack_tables``); statics and shapes must
agree across the set (map size, agent count, action space, obs geometry,
subsystem usage), values may differ. Each env carries a ``task_id``; the
step reads the leaves that differ across the set at each env's task
(``tables_at``), and every ended episode resets from its env's newly drawn
task's template. Weight updates and slot replacement are data.

Regen, chests and the clipper run over the stacked tables as in the
single-task batched step: every read of their leaves goes through
``Tables.take`` or ``Tables.bcast``, so each env reads its own task's rows.
Start-clipped assemblers keep each task's mask (``TaskSetData.start_clipped``,
[K, NA]); every reset env draws its own unclip protocols for them, while its
first observation is its task's template's, rendered from the template's
draw (the JAX package's quirk, mirrored).

Randomness is an explicit input, as the agent orders are: ``reset_state``
takes the task ids, desync steps and unclip protocols and ``step_state``
the agent orders, the clipper's draws, the task draws and the reset envs'
unclip protocols (tests pass the JAX env's draws); by default they come
from the env's ``torch.Generator``, task ids drawn in proportion to
``max(weight, 1e-9)`` (the JAX package's ``categorical`` over
``log(max(w, 1e-9))``). The step is the torch-ops batched step: as in the
JAX package, a task set never takes the fused span. The render is K1 or K4
by ``supports_v3``, as in :class:`MettaGridEnv`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.engine.compiler import compile_game
from metta_tpu_torch.engine.env import obs_renderer
from metta_tpu_torch.engine.state import EnvState, _Tensors
from metta_tpu_torch.engine.step import (
    int32_on,
    make_reset_template,
    starts_clipped,
    unclip_proto_draws,
)
from metta_tpu_torch.engine.step_batched import check_supported, step_env_batched
from metta_tpu_torch.engine.tables import (
    Tables,
    attach_static_block_grid,
    put_task,
    stack_tables,
    tables_at,
)


@dataclasses.dataclass
class TaskSetData(_Tensors):
    """A task set on the device."""

    tables: Tables            # leaves stacked [K, ...]; statics of task 0
    template: EnvState        # reset-target state of each task, [K, ...]
    obs1: torch.Tensor        # [K, A, T, 3] uint8 initial observations
    start_clipped: torch.Tensor  # [K, NA] bool assemblers that start clipped
    weights: torch.Tensor     # [K] f32 sampling weights (need not be normalized)


@dataclasses.dataclass
class MTVecState(_Tensors):
    """Counterpart of ``metta_tpu/engine/taskset.py:MTVecState``."""

    env: EnvState
    task_id: torch.Tensor              # [E] int32 current task per env
    desync_step: torch.Tensor          # [E] int32; >0 = truncate first episode there
    episode_len: torch.Tensor          # [E] int32 of the last finished episode
    last_episode_reward: torch.Tensor  # [E, A] f32 of the last finished episode
    last_episode_task: torch.Tensor    # [E] int32 task of the last finished episode
    last_episode_gained: torch.Tensor  # [E, R] f32 agent-mean resources gained
    episodes_done: torch.Tensor        # [E] int32 total finished episodes


def _compile_task(cfg: MettaGridConfig, track_stats: bool, device, unclip_proto=None,
                  generator=None):
    """(tables with the static block grid, reset template, initial obs,
    start-clipped mask [1, NA]). Start-clipped assemblers of the template
    take ``unclip_proto`` [NA], else a draw from ``generator``."""
    game_map = cfg.game.map_builder.create().build()
    compiled, init = compile_game(cfg.game, game_map)
    tables = Tables(compiled, track_stats=track_stats, device=device)
    if starts_clipped(tables, init) and unclip_proto is None:
        unclip_proto = unclip_proto_draws(tables, 1, generator, tables.device)[0]
    template, obs1 = make_reset_template(tables, init, unclip_proto)
    attach_static_block_grid(tables, template)
    start_clipped = torch.as_tensor(np.asarray(init["asm_start_clipped"], bool),
                                    device=tables.device)[None]
    return tables, template, obs1, start_clipped


def build_task_set(cfgs: Sequence[MettaGridConfig], track_stats: bool = True,
                   weights=None, device="cpu", template_unclip_proto=None,
                   generator=None) -> tuple[TaskSetData, List[Tables]]:
    """Compile and stack K task configs; raises ValueError if their statics
    or shapes differ (``metta_tpu/engine/taskset.py:build_task_set``), and
    then NotImplementedError for a subsystem no step of the port has.
    ``template_unclip_proto`` [K, NA] gives the start-clipped assemblers'
    protocols of each task's template (the JAX templates draw them from a
    zero key), else they are drawn from ``generator``."""
    protos = [None] * len(cfgs) if template_unclip_proto is None else template_unclip_proto
    built = [_compile_task(cfg, track_stats, device, p, generator)
             for cfg, p in zip(cfgs, protos)]
    tables_list = [b[0] for b in built]
    stacked = stack_tables(tables_list)
    check_supported(stacked, "sequential")
    template = EnvState(**{f.name: torch.cat([getattr(b[1], f.name) for b in built])
                           for f in dataclasses.fields(EnvState)})
    w = (torch.ones((len(cfgs),), dtype=torch.float32) if weights is None
         else torch.as_tensor(np.asarray(weights, np.float32)))
    return TaskSetData(
        tables=stacked, template=template, obs1=torch.cat([b[2] for b in built]),
        start_clipped=torch.cat([b[3] for b in built]), weights=w.to(device),
    ), tables_list


class MultiTaskEnv:
    """Batched MettaGrid over a task set on a torch device.

    Args:
      cfgs: the task configs (one shape class).
      num_envs: batch size E.
      seed: seed of the env's ``torch.Generator`` (task draws, agent orders,
        desync).
      desync_episodes: truncate each env's first episode at a random step
        (default: the first config's setting).
      track_stats: keep the gained/lost/chest stat accumulators.
      step_mode: only "batched" is ported for a task set.
      device: where the state lives and the step runs; "cuda" by default.
      template_unclip_proto: [K, NA] unclip protocols of the start-clipped
        assemblers in each task's reset template (its obs show them), else
        drawn from the generator; tests pass the JAX templates'.
    """

    def __init__(self, cfgs: Sequence[MettaGridConfig], num_envs: int = 1, seed: int = 0,
                 desync_episodes: Optional[bool] = None, track_stats: bool = False,
                 step_mode: str = "batched", device="cuda", template_unclip_proto=None):
        self.cfgs = list(cfgs)
        self.num_envs = num_envs
        self.track_stats = track_stats
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.tsdata, tables_list = build_task_set(
            self.cfgs, track_stats, device=self.device,
            template_unclip_proto=template_unclip_proto, generator=self.generator)
        self.tables = tables_list[0]   # statics view (shared across the set)
        if (step_mode != "batched" or not self.tables.inv_vector_ok
                or self.tables.chest_search_distance > 0):
            # the JAX task set takes its sequential step here
            raise NotImplementedError(
                "not ported yet: the sequential step of a task set "
                "(metta_tpu/engine/taskset.py:144-147)")
        check_supported(self.tables, step_mode)
        self.step_mode = step_mode
        self.compiled = self.tables._cfg
        self.desync = self.cfgs[0].desync_episodes if desync_episodes is None else desync_episodes
        self.num_agents = self.compiled.num_agents
        self.single_observation_space_shape = (self.compiled.num_obs_tokens, 3)
        self.action_names = self.compiled.action_names
        # static shapes are shared across the set, so one check covers it
        self._render = obs_renderer(self.tables, num_envs)
        self._state: Optional[MTVecState] = None

    # ------------------------------------------------------------------
    # functional API
    # ------------------------------------------------------------------

    def _ints(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.array(x))
        return x.to(device=self.device, dtype=torch.int32)

    def draw_tasks(self):
        """[E] int32 task ids drawn from the sampling weights."""
        w = self.tsdata.weights.clamp(min=1e-9)
        return torch.multinomial(w, self.num_envs, replacement=True,
                                 generator=self.generator).to(torch.int32)

    def _fresh(self, task_id, unclip_proto=None):
        """Reset-target state and obs of each env from its task's template;
        with the clipper on, the start-clipped assemblers take
        ``unclip_proto`` [E, NA] (else drawn), every other slot -1
        (``metta_tpu/engine/taskset.py:_fresh_batch``)."""
        idx = task_id.long()
        ts = self.tsdata
        state = ts.template.map(lambda x: x[idx])
        if self.tables.clipper_enabled:
            protos = (unclip_proto_draws(self.tables, self.num_envs, self.generator, self.device)
                      if unclip_proto is None else int32_on(unclip_proto, self.device))
            state = state.replace(asm_unclip_proto=torch.where(
                ts.start_clipped[idx], protos, -1).to(torch.int32))
        return state, ts.obs1[idx]

    def reset_state(self, task_id=None, desync_step=None, unclip_proto=None):
        """-> (MTVecState, obs [E, A, T, 3] uint8). ``task_id`` and
        ``desync_step`` [E] and ``unclip_proto`` [E, NA] override the draws
        (tests pass the JAX env's); by default they come from the env's
        generator, tasks first."""
        E = self.num_envs
        t = self.tables
        task_id = self.draw_tasks() if task_id is None else self._ints(task_id)
        env, obs = self._fresh(task_id, unclip_proto)
        if desync_step is not None:
            desync = self._ints(desync_step)
        elif self.desync and t.max_steps > 0:
            desync = torch.randint(1, t.max_steps, (E,), generator=self.generator,
                                   device=self.device, dtype=torch.int32)
        else:
            desync = torch.zeros((E,), dtype=torch.int32, device=self.device)
        zeros = torch.zeros((E,), dtype=torch.int32, device=self.device)
        return MTVecState(
            env=env, task_id=task_id, desync_step=desync, episode_len=zeros,
            last_episode_reward=torch.zeros((E, t.num_agents), dtype=torch.float32,
                                            device=self.device),
            last_episode_task=zeros.clone(),
            last_episode_gained=torch.zeros((E, t.num_resources), dtype=torch.float32,
                                            device=self.device),
            episodes_done=zeros.clone(),
        ), obs

    def step_state(self, vstate: MTVecState, actions, perm=None, task_draws=None,
                   clip_draws=None, unclip_proto=None):
        """(MTVecState, actions [E, A]) -> (MTVecState, obs, rew, done, trunc).

        ``perm`` and ``clip_draws`` override the step's agent orders and
        clipper draws. Ended envs draw a new task (``task_draws`` [E] gives
        every env's draw; the ended ones take it) and reset from its
        template, start-clipped assemblers with ``unclip_proto`` [E, NA]."""
        tables = tables_at(self.tsdata.tables, vstate.task_id)
        env, rew_at_obs = step_env_batched(vstate.env, actions, tables, perm=perm,
                                           generator=self.generator, clip_draws=clip_draws)
        obs = self._render(env, tables, env.executed_action, rew_at_obs)
        force_trunc = (vstate.desync_step > 0) & (env.step >= vstate.desync_step)
        truncated = env.truncated | force_trunc
        done = env.done
        ended = done | truncated
        rewards = env.reward
        A = self.num_agents
        episode_len = torch.where(ended, env.step, vstate.episode_len)
        last_reward = torch.where(ended[:, None], env.episode_reward,
                                  vstate.last_episode_reward)
        last_task = torch.where(ended, vstate.task_id, vstate.last_episode_task)
        gained_mean = env.agent_gained.to(torch.float32).sum(1) / A
        last_gained = torch.where(ended[:, None], gained_mean, vstate.last_episode_gained)

        # per-episode task resample and auto-reset: every field comes from
        # the new task's template (its map may differ from the old one's)
        draws = self.draw_tasks() if task_draws is None else self._ints(task_draws)
        task_id = torch.where(ended, draws, vstate.task_id)
        fresh, fresh_obs = self._fresh(task_id, unclip_proto)
        env = EnvState(**{
            f.name: torch.where(
                ended.reshape((-1,) + (1,) * (getattr(env, f.name).dim() - 1)),
                getattr(fresh, f.name), getattr(env, f.name))
            for f in dataclasses.fields(EnvState)
        })
        obs = torch.where(ended[:, None, None, None], fresh_obs, obs)
        vstate = MTVecState(
            env=env, task_id=task_id,
            desync_step=torch.where(ended, torch.zeros_like(vstate.desync_step),
                                    vstate.desync_step),
            episode_len=episode_len, last_episode_reward=last_reward,
            last_episode_task=last_task, last_episode_gained=last_gained,
            episodes_done=vstate.episodes_done + ended.to(torch.int32),
        )
        return vstate, obs, rewards, done, truncated

    # ------------------------------------------------------------------
    # task-pool mutation (data only)
    # ------------------------------------------------------------------

    def set_weights(self, weights):
        self.tsdata = self.tsdata.replace(weights=torch.as_tensor(
            np.asarray(weights, np.float32), device=self.device))

    def set_task(self, slot: int, cfg: MettaGridConfig, template_unclip_proto=None):
        """Replace one task slot (curriculum pool eviction). Data only; the
        new task is compiled with the set's own ``track_stats``, its
        template's start-clipped assemblers with ``template_unclip_proto``
        [NA] (else drawn)."""
        tables, template, obs1, start_clipped = _compile_task(
            cfg, self.track_stats, self.device, template_unclip_proto, self.generator)
        ts = self.tsdata
        put_task(ts.tables, slot, tables)
        for f in dataclasses.fields(EnvState):
            getattr(ts.template, f.name)[slot] = getattr(template, f.name)[0]
        ts.obs1[slot] = obs1[0]
        ts.start_clipped[slot] = start_clipped[0]
        self.cfgs[slot] = cfg

    # ------------------------------------------------------------------
    # stateful numpy API (tests, eval)
    # ------------------------------------------------------------------

    def reset(self, task_id=None, desync_step=None, unclip_proto=None):
        self._state, obs = self.reset_state(task_id, desync_step, unclip_proto)
        return obs.cpu().numpy()

    def step(self, actions, perm=None, task_draws=None, clip_draws=None, unclip_proto=None):
        if self._state is None:
            raise RuntimeError("call reset() first")
        actions = self._ints(actions)
        if actions.dim() == 1:
            actions = actions[None, :]
        self._state, *out = self.step_state(self._state, actions, perm, task_draws,
                                            clip_draws, unclip_proto)
        return tuple(x.cpu().numpy() for x in out)

    @property
    def state(self) -> MTVecState:
        return self._state
