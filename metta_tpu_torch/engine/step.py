"""Initial state, reset template and reset-time observations.

Counterpart of ``metta_tpu/engine/step.py`` (``make_initial_state``,
``make_reset_template``, ``make_reset_batch``, ``initial_observations``).
Every env of a map starts from the same state, so the template is built once
(a batch of one) and broadcast. The sequential step (``step_env``) is not
ported: the port runs the batched step only.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.state import EnvState


def make_initial_state(tables, init: dict) -> EnvState:
    """The reset-target EnvState (a batch of one) from compiled init arrays."""
    dev = tables.device
    A = tables.num_agents
    R = tables.num_resources
    NA = tables.n_assembler_slots
    if tables.clipper_enabled and bool(init["asm_start_clipped"].any()):
        raise NotImplementedError(
            "start-clipped assemblers need the clipper "
            "(metta_tpu/engine/step.py:make_initial_state, engine/clipper.py)"
        )

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
        asm_clipped=zeros(NA, dtype=torch.bool),
        asm_unclip_proto=torch.full((1, NA), -1, dtype=torch.int32, device=dev),
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
    (mettagrid_c.cpp:285-288). Rendered by the plain gather renderer."""
    from metta_tpu_torch.engine.obs import render_observations_ref

    E, A = state.agent_r.shape
    dev = state.agent_r.device
    return render_observations_ref(
        state, tables, torch.zeros((E, A), dtype=torch.int32, device=dev),
        torch.zeros((E, A), dtype=torch.float32, device=dev),
    )


def make_reset_template(tables, init: dict):
    """The per-episode template state and its initial obs, each a batch of
    one, computed once per map."""
    template = make_initial_state(tables, init)
    return template, initial_observations(template, tables)


def make_reset_batch(template, num_envs: int):
    """Batched reset: the template state and obs broadcast over E envs
    (materialized, so the batch can be updated in place)."""
    template_state, obs1 = template
    state = template_state.map(
        lambda x: x.expand((num_envs,) + x.shape[1:]).clone()
    )
    obs = obs1.expand((num_envs,) + obs1.shape[1:]).clone()
    return state, obs
