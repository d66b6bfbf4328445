"""The exact sequential step, initial state, reset template and reset obs.

Counterpart of ``metta_tpu/engine/step.py`` (``make_initial_state``,
``make_reset_template``, ``make_reset_batch``, ``initial_observations``,
``step_env``). Every env of a map starts from the same state, so the
template is built once (a batch of one) and broadcast; only the unclip
protocols of start-clipped assemblers are drawn per env.

:func:`step_env` is the reference's ``MettaGrid::_step``
(``bindings/mettagrid_c.cpp:572-678``) over a batch: clear the per-step
outputs, step + 1, each env's shuffled agent order, the agents' actions one
at a time (``engine/actions.py``), the occupancy grid rebuilt, inventory
regen, the clipper, the observations (before the stat rewards, so the
last-reward token reads the pre-stat reward), the stat and episode rewards,
truncation. The JAX
function takes one env under ``vmap``; here every env of the batch runs the
same Python loop over ``i in range(A)``, with its own agent
``perm[:, i]``.
"""

from __future__ import annotations

import numpy as np
import torch

from metta_tpu_torch.engine.actions import apply_agent_action
from metta_tpu_torch.engine.obs import render_observations
from metta_tpu_torch.engine.rewards import compute_stat_rewards
from metta_tpu_torch.engine.state import EnvState
from metta_tpu_torch.engine.step_batched import (
    agent_grid_from_positions,
    check_supported,
    random_perm,
    world_systems,
)


def int32_on(x, device):
    """An int32 tensor on ``device`` from a tensor or an array-like."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x))
    return x.to(device=device, dtype=torch.int32)


def starts_clipped(tables, init: dict) -> bool:
    """Whether the map has assemblers that start clipped (only with the
    clipper on)."""
    return bool(tables.clipper_enabled and np.asarray(init["asm_start_clipped"]).any())


def unclip_proto_draws(tables, E: int, generator=None, device="cpu"):
    """[E, NA] uniform unclip protocols, one per assembler slot of each env
    (the draw of ``make_reset_batch`` in JAX)."""
    return torch.randint(0, max(tables.n_unclip_protocols, 1), (E, tables.n_assembler_slots),
                         generator=generator, device=device, dtype=torch.int32)


def make_initial_state(tables, init: dict, unclip_proto=None) -> EnvState:
    """The reset-target EnvState (a batch of one) from compiled init arrays.

    Start-clipped assemblers take the unclip protocols ``unclip_proto``
    [NA] (0 where None: :func:`make_reset_batch` draws each env's own), the
    other slots -1."""
    dev = tables.device
    A = tables.num_agents
    R = tables.num_resources
    NA = tables.n_assembler_slots
    if starts_clipped(tables, init):
        start_clipped = torch.as_tensor(np.asarray(init["asm_start_clipped"]), device=dev)
        protos = (torch.zeros(NA, dtype=torch.int32, device=dev) if unclip_proto is None
                  else int32_on(unclip_proto, dev))
        unclip = torch.where(start_clipped, protos, -1)
    else:
        start_clipped = torch.zeros(NA, dtype=torch.bool, device=dev)
        unclip = torch.full((NA,), -1, dtype=torch.int32, device=dev)

    def i32(x):
        return torch.as_tensor(x, device=dev).to(torch.int32)[None]

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((1,) + shape, dtype=dtype, device=dev)

    coll_inv = tables.coll_initial_inv.to(torch.int32)
    return EnvState(
        step=zeros(),
        done=zeros(dtype=torch.bool),
        truncated=zeros(dtype=torch.bool),
        agent_r=i32(init["agent_r"]),
        agent_c=i32(init["agent_c"]),
        agent_prev_r=i32(init["agent_r"]),
        agent_prev_c=i32(init["agent_c"]),
        agent_inv=tables.agent_initial_inv.clamp(0, 65535).to(torch.int32)[None],
        agent_frozen=zeros(A),
        agent_vibe=tables.agent_initial_vibe.to(torch.int32)[None],
        agent_steps_without_motion=zeros(A),
        agent_current_stat_reward=zeros(A, dtype=torch.float32),
        agent_gained=zeros(A, R),
        agent_lost=zeros(A, R),
        agent_chest_deposited=zeros(A, R),
        agent_grid=i32(init["agent_grid"]),
        static_kind=i32(init["static_kind"]),
        static_idx=i32(init["static_idx"]),
        static_type=i32(init["static_type"]),
        asm_r=i32(init["asm_r"]),
        asm_c=i32(init["asm_c"]),
        asm_type=i32(init["asm_type"]),
        asm_cooldown_end=zeros(NA),
        asm_cooldown_duration=zeros(NA),
        asm_uses=zeros(NA),
        asm_clipped=start_clipped[None],
        asm_unclip_proto=unclip[None],
        asm_valid=torch.as_tensor(init["asm_valid"], device=dev)[None],
        chest_inv=i32(init["chest_inv"]),
        chest_type=i32(init["chest_type"]),
        chest_valid=torch.as_tensor(init["chest_valid"], device=dev)[None],
        coll_inv=coll_inv.clamp(0, 65535)[None],
        agent_coll=tables.agent_collective.to(torch.int32)[None],
        coll_aligned=tables.coll_aligned_init.to(torch.int32)[None],
        coll_deposited=torch.zeros_like(coll_inv)[None],
        coll_withdrawn=torch.zeros_like(coll_inv)[None],
        game_chest_deposited=zeros(R),
        game_chest_withdrawn=zeros(R),
        game_asm_created=zeros(R),
        reward=zeros(A, dtype=torch.float32),
        episode_reward=zeros(A, dtype=torch.float32),
        action_success=zeros(A, dtype=torch.bool),
        executed_action=zeros(A),
    )


def initial_observations(state, tables):
    """Reset-time observations: every agent starts with a noop
    (mettagrid_c.cpp:285-288), rendered by ``tables.obs_renderer``."""
    E, A = state.agent_r.shape
    dev = state.agent_r.device
    return render_observations(
        state, tables, torch.zeros((E, A), dtype=torch.int32, device=dev),
        torch.zeros((E, A), dtype=torch.float32, device=dev),
    )


def make_reset_template(tables, init: dict, unclip_proto=None):
    """The per-episode template state and its initial obs, each a batch of
    one, computed once per map; start-clipped assemblers take
    ``unclip_proto`` [NA] (see :func:`make_initial_state`). Every reset env
    starts from this obs, as in JAX: its assembler tokens show the
    template's protocols."""
    template = make_initial_state(tables, init, unclip_proto)
    return template, initial_observations(template, tables)


def make_reset_batch(template, num_envs: int, unclip_proto=None):
    """Batched reset: the template state and obs broadcast over E envs
    (materialized, so the batch can be updated in place). Where the
    template has start-clipped assemblers, ``unclip_proto`` [E, NA] gives
    each env's protocols for them (:func:`unclip_proto_draws`)."""
    template_state, obs1 = template
    state = template_state.map(
        lambda x: x.expand((num_envs,) + x.shape[1:]).clone()
    )
    if unclip_proto is not None:
        state = state.replace(asm_unclip_proto=with_unclip_protos(state, unclip_proto))
    obs = obs1.expand((num_envs,) + obs1.shape[1:]).clone()
    return state, obs


def with_unclip_protos(state, unclip_proto):
    """The start-clipped slots of ``state`` [E, NA] with the protocols
    ``unclip_proto`` [E, NA]: a reset state's slots are clipped only where
    they start so."""
    return torch.where(state.asm_clipped, int32_on(unclip_proto, state.asm_clipped.device), -1)


def step_env(state, actions, tables, perm=None, generator=None, clip_draws=None):
    """One exact sequential step of every env -> (new_state, obs [E, A, T, 3]).

    ``actions`` [E, A] int; ``perm`` [E, A] overrides each env's random agent
    order (the reference's ``std::shuffle``, ``mettagrid_c.cpp:591-593``)
    and ``clip_draws`` (``clipper.ClipDraws``) the clipper's draws, else each
    is drawn from ``generator``. Single-task tables only."""
    check_supported(tables, "sequential")
    if tables.per_env:
        raise NotImplementedError("not ported yet: the sequential step of a task set "
                                  "(metta_tpu/engine/taskset.py:144-147)")
    E, A = actions.shape
    dev = actions.device
    state = state.replace(
        step=state.step + 1,
        reward=torch.zeros_like(state.reward),
        action_success=torch.zeros_like(state.action_success),
        executed_action=torch.zeros_like(state.executed_action),
    )
    if perm is None:
        perm = random_perm(E, A, generator, dev)
    perm = perm.to(device=dev, dtype=torch.int64)
    actions = actions.to(torch.int32)
    for i in range(A):
        a = perm[:, i]
        state = apply_agent_action(state, tables, a, actions.gather(1, a[:, None])[:, 0])

    # the occupancy grid, rebuilt once for the observations (the loop reads
    # occupancy from positions)
    state = state.replace(agent_grid=agent_grid_from_positions(
        tables, state.agent_r, state.agent_c))
    state = world_systems(state, tables, generator, clip_draws)
    obs = render_observations(state, tables, state.executed_action, state.reward)

    state = compute_stat_rewards(state, tables)
    state = state.replace(episode_reward=state.episode_reward + state.reward)
    if tables.max_steps > 0:
        ended = state.step >= tables.max_steps
        if tables.episode_truncates:
            state = state.replace(truncated=ended)
        else:
            state = state.replace(done=ended)
    return state, obs
