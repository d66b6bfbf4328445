"""Stat-based rewards and inventory regeneration.

Counterpart of ``metta_tpu/engine/rewards.py``. Parity:

- stat rewards: ``objects/agent.cpp:104-135``: reward level = sum of stat x
  weight (capped per stat); the *delta* vs the previous level is added to
  the step reward. Stat keys are compiled to (source, index) pairs by the
  compiler.
- regen: ``bindings/mettagrid_c.cpp:625-640``: every
  ``inventory_regen_interval`` steps, vibe-keyed amounts (with the vibe-0
  fallback baked into the compiled table) are applied.

Damage (``agent.cpp:137-183``, JAX ``apply_damage``) is not ported yet;
``step_batched.check_supported`` refuses a config that uses it.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.compiler import (
    SRC_ALIGNED,
    SRC_COLL_DEPOSITED,
    SRC_COLL_WITHDRAWN,
)
from metta_tpu_torch.engine.inventory import inv_update
from metta_tpu_torch.engine.inventory_vec import all_agents_update_multi


def _gather_last(x, idx, n):
    """x[..., idx] with out-of-range idx reading 0 (the one-hot miss of the
    JAX formulation). x [E, A, n], idx [A, S] or [E, A, S] -> [E, A, S]."""
    ok = (idx >= 0) & (idx < n)
    i = idx.clamp(0, n - 1).long().expand(x.shape[0], -1, -1)
    return torch.where(ok, x.gather(2, i), torch.zeros((), dtype=x.dtype, device=x.device))


def _per_collective(state, x):
    """Rows of a per-collective table [E, NL, X] for each agent's live
    collective, zeros for agents in none -> [E, A, X]."""
    NL = x.shape[1]
    coll = state.agent_coll
    ok = (coll >= 0) & (coll < NL)
    i = coll.clamp(0, NL - 1).long()[..., None].expand(-1, -1, x.shape[2])
    return torch.where(ok[..., None], x.gather(1, i), torch.zeros((), dtype=x.dtype, device=x.device))


def compute_stat_rewards(state, tables):
    """Add stat-reward deltas to the per-step reward; returns new state."""
    E, A, R = state.agent_inv.shape
    chest_amount = torch.where(
        state.chest_valid[..., None], state.chest_inv, torch.zeros_like(state.chest_inv)
    ).sum(1).to(torch.int32)                                         # [E, R]

    def bcast(x):                                                    # [E, R] -> [E, A, R]
        return x[:, None, :].expand(E, A, R)

    table = torch.stack([
        torch.zeros_like(state.agent_inv),               # SRC_ZERO
        state.agent_inv,                                 # SRC_INV_AMOUNT
        state.agent_gained,                              # SRC_GAINED
        state.agent_lost,                                # SRC_LOST
        bcast(chest_amount),                             # SRC_CHEST_AMOUNT
        bcast(state.game_chest_deposited),               # SRC_CHEST_DEPOSITED
        bcast(state.game_chest_withdrawn),               # SRC_CHEST_WITHDRAWN
        state.agent_chest_deposited,                     # SRC_CHEST_DEPOSITED_BY_AGENT
        bcast(state.game_asm_created),                   # SRC_ASM_CREATED
        _per_collective(state, state.coll_deposited),    # 9: collective deposited
        _per_collective(state, state.coll_withdrawn),    # 10: collective withdrawn
    ], dim=2)                                            # [E, A, 11, R]

    src = tables.stat_src                                # [A, S], or [E, A, S] per env
    idx = tables.stat_idx
    src_r = torch.where(src == SRC_COLL_DEPOSITED, 9,
                        torch.where(src == SRC_COLL_WITHDRAWN, 10, src))
    src_r = torch.where(src == SRC_ALIGNED, 0, src_r)    # aligned handled below
    # picked[e, a, s, :] = table[e, a, src_r[a, s], :]
    S = src.shape[-1]
    picked = table.gather(
        2, src_r.long().expand(E, A, S)[..., None].expand(E, A, S, R)
    )                                                    # [E, A, S, R]
    ok = (idx >= 0) & (idx < R)
    vals = picked.gather(3, idx.clamp(0, R - 1).long().expand(E, A, S)[..., None])[..., 0]
    vals = torch.where(ok, vals, torch.zeros_like(vals)).to(torch.float32)

    if tables.any_stat_aligned:
        # aligned.<type>: idx indexes the TYPE axis of the live member counts
        my_aligned = _per_collective(state, state.coll_aligned)     # [E, A, NT]
        aligned_vals = _gather_last(my_aligned, idx, tables.n_object_types)
        vals = torch.where(src == SRC_ALIGNED, aligned_vals.to(torch.float32), vals)

    contrib = torch.minimum(vals * tables.stat_w, tables.stat_max)  # [E, A, S]
    # left-to-right sum over the few stat slots (the order XLA reduces in)
    new_level = contrib[..., 0]
    for s in range(1, contrib.shape[-1]):
        new_level = new_level + contrib[..., s]
    delta = new_level - state.agent_current_stat_reward
    return state.replace(
        reward=state.reward + delta,
        agent_current_stat_reward=new_level,
    )



def agents_update_vec(state, tables, r: int, deltas, do):
    """Update resource ``r`` of every agent by ``deltas`` [E, A] where ``do``
    [E, A], each agent on its own (agents are independent); returns
    (state, actual [E, A])."""
    E, A, _ = state.agent_inv.shape
    cls = tables.agent_inv_class.expand(E, A)
    new_inv, actual = inv_update(tables.inv_tables, cls, state.agent_inv, r, deltas)
    actual = torch.where(do, actual, torch.zeros_like(actual))
    state = state.replace(agent_inv=torch.where(do[..., None], new_inv, state.agent_inv))
    if tables.track_gained:
        gained, lost = state.agent_gained.clone(), state.agent_lost.clone()
        gained[..., r] += actual.clamp(min=0)
        lost[..., r] += (-actual).clamp(min=0)
        state = state.replace(agent_gained=gained, agent_lost=lost)
    return state, actual


def apply_regen(state, tables):
    """Vibe-keyed inventory regeneration on the configured interval, in
    every env whose step is a multiple of it."""
    E, A, R = state.agent_inv.shape
    tick = (state.step % tables.inventory_regen_interval) == 0            # [E]
    vibes = state.agent_vibe.long().clamp(0, tables.num_vibes - 1)
    agents = torch.arange(A, device=vibes.device).expand(E, A)
    amounts = tables.take("agent_regen", agents, vibes)                   # [E, A, R]
    do = tick[:, None] & tables.bcast("agent_has_regen", 2)               # [E, A]
    if tables.inv_vector_ok:
        state, _ = all_agents_update_multi(state, tables, amounts,
                                           do[..., None] & (amounts != 0))
        return state
    for r in range(R):
        state, _ = agents_update_vec(state, tables, r, amounts[..., r],
                                     do & (amounts[..., r] != 0))
    return state
