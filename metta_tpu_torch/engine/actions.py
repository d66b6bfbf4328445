"""Per-agent action application: the body of the sequential step's loop.

Counterpart of ``metta_tpu/engine/actions.py`` (``try_attack`` :33,
``try_transfer`` :141, ``chest_use`` :187, ``do_move`` :248,
``apply_agent_action`` :337). The
reference processes agents one at a time in a shuffled order
(``mettagrid_c.cpp:591-622``), so earlier agents' moves affect later ones.
One call applies one agent's action in every env: ``a`` [E] is each env's
acting agent (each env has its own order), every read of "agent a" is a
gather at ``(arange(E), a)`` and every write a masked scatter there
(``refs.rows_at``, ``refs.masked_set``), and each branch runs for every env
under its mask, as the JAX body does under ``vmap``.

Two departures, neither changing a result:

- A per-resource loop (the coupled-inventory path) skips a resource whose
  table entry is zero for every action or vibe: there the JAX update is
  masked off.
- A branch that no env takes at this agent (an attack, a transfer, an
  assembler or chest use) is skipped after one host read of its mask: its
  masked updates would change nothing.

Still refused by ``step_batched.unsupported``, naming its JAX source: the
bump handlers (``activation_wiring.py:193``).
"""

from __future__ import annotations

import numpy as np
import torch

from metta_tpu_torch.engine.assembler import assembler_use
from metta_tpu_torch.engine.compiler import ACT_CHANGE_VIBE, ACT_MOVE, ACT_NOOP
from metta_tpu_torch.engine.inventory_vec import (
    agent_update_multi,
    chest_update_multi,
    row_limits,
)
from metta_tpu_torch.engine.protocols import agent_at
from metta_tpu_torch.engine.refs import (
    add_at,
    add_item_at,
    agent_free_space_vec,
    agent_update,
    chest_update,
    masked_set,
    rows_at as _at,
)
from metta_tpu_torch.engine.state import KIND_ASSEMBLER, KIND_CHEST


def _taken(mask) -> bool:
    """Whether any env takes a branch (one host read)."""
    return bool(mask.any())


def _live(table):
    """Resources whose column of a host table [..., R] (numpy, from the
    compiled config) holds True somewhere."""
    t = np.asarray(table).reshape(-1, table.shape[-1])
    return [r for r in range(t.shape[1]) if t[:, r].any()]


def _each_resource(state, tables, a, deltas, do, live):
    """agent_update of agents ``a`` by ``deltas[:, r]`` where ``do[:, r]``,
    resource by resource in ascending id over the resources ``live`` (the
    JAX ``fori_loop``s over every resource; ``do`` is false for the rest)."""
    for r in live:
        state, _ = agent_update(state, tables, a, r, deltas[:, r], do[:, r])
    return state


def try_attack(state, tables, a, tgt, mask):
    """Vibe-triggered attack on target agents ``tgt`` (attack.hpp:93-224).

    Returns (handled, state): handled also for a *blocked* attack (the move
    still counts as a successful attack attempt)."""
    E = a.shape[0]
    A = tables.num_agents
    t = tgt.clamp(0, A - 1)
    inv_a = _at(state.agent_inv, a)
    can_afford = (inv_a >= tables.attack_consumed).all(-1)
    valid = mask & (tgt >= 0) & (_at(state.agent_frozen, t) <= 0) & can_afford
    if not _taken(valid):
        return valid, state

    # weapon/armor power (attack.hpp:143-177)
    weapon = (inv_a * tables.attack_weapon_w).sum(-1)
    t_vibe = _at(state.agent_vibe, t).long().clamp(0, tables.num_vibes - 1)
    vibing = tables.vibe_matches_resource[t_vibe]                   # [E, R]
    inv_t = _at(state.agent_inv, t)
    armor_amounts = inv_t + torch.where(vibing, tables.attack_vibe_bonus[t_vibe][:, None],
                                        torch.zeros_like(inv_t))
    armor = (armor_amounts * tables.attack_armor_w).sum(-1)
    damage_bonus = (weapon - armor).clamp(min=0)

    if tables.attack_defense_any:
        required = tables.attack_defense + damage_bonus[:, None]    # [E, R]
        mask_r = tables.attack_defense_mask
        can_defend = (~mask_r | (inv_t >= required)).all(-1)
        blocked = valid & can_defend
        # blocked: the target pays the defense cost (attack.hpp:200-207)
        deltas = torch.where(mask_r, -required, torch.zeros_like(required))
        if tables.inv_vector_ok:
            state, _ = agent_update_multi(state, tables, t, deltas, blocked)
        else:
            state = _each_resource(state, tables, t, deltas, blocked[:, None] & mask_r,
                                   _live(tables._cfg.attack_defense_mask))
    else:
        blocked = torch.zeros_like(valid)

    hit = valid & ~blocked
    if tables.attack_freeze > 0:
        state = state.replace(agent_frozen=masked_set(
            state.agent_frozen, t, torch.full_like(t, tables.attack_freeze), hit))

    # actor / target inventory deltas (ascending resource id)
    if tables.any_attack_delta:
        d_actor = tables.attack_actor_delta.expand(E, -1)
        d_target = tables.attack_target_delta.expand(E, -1)
        if tables.inv_vector_ok:
            state, _ = agent_update_multi(state, tables, a, d_actor, hit)
            state, _ = agent_update_multi(state, tables, t, d_target, hit)
        else:
            cfg = tables._cfg
            for r in _live((cfg.attack_actor_delta != 0) | (cfg.attack_target_delta != 0)):
                state, _ = agent_update(state, tables, a, r, d_actor[:, r],
                                        hit & (d_actor[:, r] != 0))
                state, _ = agent_update(state, tables, t, r, d_target[:, r],
                                        hit & (d_target[:, r] != 0))

    # loot: steal everything the target holds, capped by the actor's
    # capacity (config order matters for capacity spillover, attack.hpp:216-223)
    for r_loot in tables.loot_ids:
        amount = _at(state.agent_inv, t)[:, r_loot]
        do = hit & (amount > 0)
        if tables.inv_vector_ok:
            inv_a = _at(state.agent_inv, a)
            lim = row_limits(tables, tables.agent_inv_class[a.long()])[:, r_loot]
            new_a = torch.minimum(inv_a[:, r_loot] + amount, lim)
            stolen = torch.where(do, new_a - inv_a[:, r_loot], torch.zeros_like(amount))
            state = _move_item(state, tables, a, t, r_loot, stolen)
        else:
            state, stolen = agent_update(state, tables, a, r_loot, amount, do)
            state, _ = agent_update(state, tables, t, r_loot, -stolen, do)

    # the attack's cost, from the actor (on success, blocked included)
    if tables.any_attack_consumed:
        consumed = tables.attack_consumed.expand(E, -1)
        if tables.inv_vector_ok:
            state, _ = agent_update_multi(state, tables, a, -consumed, valid)
        else:
            state = _each_resource(state, tables, a, -consumed, valid[:, None] & (consumed > 0),
                                   _live(tables._cfg.attack_consumed > 0))
    return valid, state


def _move_item(state, tables, a, t, r: int, amount):
    """``amount`` [E] of resource ``r`` from agents ``t`` to agents ``a``
    (unclamped: the caller clamped it), with gained/lost."""
    state = state.replace(agent_inv=add_item_at(add_item_at(state.agent_inv, a, r, amount),
                                                t, r, -amount))
    if tables.track_gained:
        state = state.replace(agent_gained=add_item_at(state.agent_gained, a, r, amount),
                              agent_lost=add_item_at(state.agent_lost, t, r, amount))
    return state


def try_transfer(state, tables, a, tgt, mask):
    """Vibe-triggered resource exchange (transfer.hpp:73-160)."""
    A = tables.num_agents
    t = tgt.clamp(0, A - 1)
    vibe = _at(state.agent_vibe, a).long().clamp(0, tables.num_vibes - 1)
    d_actor = tables.transfer_actor_delta[vibe]                     # [E, R]
    d_target = tables.transfer_target_delta[vibe]
    inv_a, inv_t = _at(state.agent_inv, a), _at(state.agent_inv, t)
    has_required = (inv_a >= tables.transfer_required).all(-1)
    valid = mask & (tgt >= 0) & (_at(state.agent_frozen, t) <= 0) & has_required
    if not _taken(valid):
        return valid, state

    if tables.inv_vector_ok:
        free_a = (row_limits(tables, tables.agent_inv_class[a.long()]) - inv_a).clamp(min=0)
        free_t = (row_limits(tables, tables.agent_inv_class[t.long()]) - inv_t).clamp(min=0)
    else:
        free_a = agent_free_space_vec(state, tables, a)
        free_t = agent_free_space_vec(state, tables, t)
    ok = valid
    ok = ok & ((d_actor >= 0) | (inv_a >= -d_actor)).all(-1)
    ok = ok & ((d_target >= 0) | (inv_t >= -d_target)).all(-1)
    ok = ok & ((d_actor <= 0) | (d_actor <= free_a)).all(-1)
    ok = ok & ((d_target <= 0) | (d_target <= free_t)).all(-1)

    if tables.inv_vector_ok:
        state, _ = agent_update_multi(state, tables, a, d_actor, ok)
        state, _ = agent_update_multi(state, tables, t, d_target, ok)
    else:
        cfg = tables._cfg
        state = _each_resource(state, tables, a, d_actor, ok[:, None] & (d_actor != 0),
                               _live(cfg.transfer_actor_delta != 0))
        state = _each_resource(state, tables, t, d_target, ok[:, None] & (d_target != 0),
                               _live(cfg.transfer_target_delta != 0))
    return ok, state


def chest_use(state, tables, a, chest_idx, mask):
    """Vibe-keyed deposit and withdraw "as much as possible" at chests
    ``chest_idx`` [E] (chest.hpp:31-126): a deposit takes what the agent
    offers (the untransferred rest is destroyed) and the chest keeps what
    fits; a withdrawal the same the other way. Returns (success, state)."""
    i = chest_idx.long().clamp(0, tables.n_chest_slots - 1)
    t = _at(state.chest_type, i).long()
    vibe = _at(state.agent_vibe, a).long().clamp(0, tables.num_vibes - 1)
    deltas = tables.chest_vibe_delta[t, vibe]                       # [E, R]
    ok = mask & tables.chest_vibe_has[t, vibe]
    if not _taken(ok):
        return ok, state
    zero = torch.zeros_like(deltas)

    def deposited(state, got):
        if not tables.track_chest_stats:
            return state
        return state.replace(agent_chest_deposited=add_at(
            state.agent_chest_deposited, a, got.clamp(min=0)))

    if tables.inv_vector_ok:
        give_dep = torch.where(deltas > 0, torch.minimum(_at(state.agent_inv, a), deltas), zero)
        state, got_dep = chest_update_multi(state, tables, i, give_dep, ok)
        state, _ = agent_update_multi(state, tables, a, -give_dep, ok)
        state = deposited(state, got_dep)
        give_w = torch.where(deltas < 0, torch.minimum(_at(state.chest_inv, i), -deltas), zero)
        state, got_w = agent_update_multi(state, tables, a, give_w, ok)
        state, _ = chest_update_multi(state, tables, i, -give_w, ok)
        return ok & ((got_dep > 0) | (got_w > 0)).any(-1), state

    any_tr = torch.zeros_like(ok)
    for r in _live(tables._cfg.chest_vibe_delta != 0):
        d = deltas[:, r]
        dep = ok & (d > 0)
        give = torch.minimum(_at(state.agent_inv, a)[:, r], d)
        state, moved = chest_update(state, tables, i, r, give, dep)
        state, _ = agent_update(state, tables, a, r, -give, dep)
        if tables.track_chest_stats:
            state = state.replace(agent_chest_deposited=add_item_at(
                state.agent_chest_deposited, a, r,
                torch.where(dep, moved.clamp(min=0), torch.zeros_like(moved))))
        any_tr = any_tr | (dep & (moved > 0))
        wd = ok & (d < 0)
        give_w = torch.minimum(_at(state.chest_inv, i)[:, r], -d)
        state, got = agent_update(state, tables, a, r, give_w, wd)
        state, _ = chest_update(state, tables, i, r, -give_w, wd)
        any_tr = any_tr | (wd & (got > 0))
    return ok & any_tr, state


def do_move(state, tables, a, dir_arg, mask):
    """Move with vibe overrides, swap and bump-to-use (move.hpp:76-148).

    Occupancy comes from agent positions (:func:`agent_at`), not the grid."""
    H, W = tables.height, tables.width
    delta = tables.move_deltas[dir_arg.long().clamp(0, 7)]          # [E, 2]
    r0, c0 = _at(state.agent_r, a), _at(state.agent_c, a)
    r1, c1 = r0 + delta[:, 0], c0 + delta[:, 1]
    in_bounds = (r1 >= 0) & (r1 < H) & (c1 >= 0) & (c1 < W)
    rs, cs = r1.clamp(0, H - 1), c1.clamp(0, W - 1)
    mask = mask & in_bounds

    occ, occ_idx = agent_at(state, rs, cs)
    tgt_agent = torch.where(occ, occ_idx, torch.full_like(occ_idx, -1))
    flat = (rs.long() * W + cs.long())[:, None]
    skind = state.static_kind.flatten(1).gather(1, flat)[:, 0]
    sidx = state.static_idx.flatten(1).gather(1, flat)[:, 0]
    vibe = _at(state.agent_vibe, a).long().clamp(0, tables.num_vibes - 1)

    handled = torch.zeros_like(mask)
    success = torch.zeros_like(mask)

    # 1) vibe-triggered attack (only when showing an attack vibe)
    if tables.has_attack:
        atk_ok, state = try_attack(state, tables, a, tgt_agent,
                                   mask & tables.attack_vibe_mask[vibe])
        handled = handled | atk_ok
        success = success | atk_ok

    # 2) vibe-triggered transfer
    if tables.has_transfer:
        tr_ok, state = try_transfer(state, tables, a, tgt_agent,
                                    mask & ~handled & tables.transfer_vibe_mask[vibe])
        handled = handled | tr_ok
        success = success | tr_ok

    # 3) plain move into an empty cell
    empty = (tgt_agent < 0) & (skind == 0)
    move_ok = mask & ~handled & empty
    state = state.replace(agent_r=masked_set(state.agent_r, a, r1, move_ok),
                          agent_c=masked_set(state.agent_c, a, c1, move_ok))
    handled = handled | move_ok
    success = success | move_ok

    # 4) swap with a frozen agent
    if tables.has_swap:
        t = tgt_agent.clamp(0, tables.num_agents - 1)
        swap_ok = mask & ~handled & (tgt_agent >= 0) & (_at(state.agent_frozen, t) > 0)
        state = state.replace(agent_r=masked_set(state.agent_r, a, r1, swap_ok),
                              agent_c=masked_set(state.agent_c, a, c1, swap_ok))
        state = state.replace(agent_r=masked_set(state.agent_r, t, r0, swap_ok),
                              agent_c=masked_set(state.agent_c, t, c0, swap_ok))
        handled = handled | swap_ok
        success = success | swap_ok

    # 5) bump-to-use: assembler, chest
    if tables.has_assemblers:
        use = mask & ~handled & (tgt_agent < 0) & (skind == KIND_ASSEMBLER)
        if _taken(use):
            use_ok, state = assembler_use(state, tables, a, sidx, use)
            success = success | use_ok
        handled = handled | use
    if tables.has_chests:
        c_ok, state = chest_use(state, tables, a, sidx,
                                mask & ~handled & (tgt_agent < 0) & (skind == KIND_CHEST))
        success = success | c_ok
    return success, state


def apply_agent_action(state, tables, a, action_idx):
    """Agents ``a`` [E] take actions ``action_idx`` [E]: gating, dispatch,
    motion stats, resource consumption (``mettagrid_c.cpp:602-621``,
    ``action_handler.hpp:105-160``)."""
    n_actions = tables.n_actions
    act_ok = (action_idx >= 0) & (action_idx < n_actions)
    act = action_idx.long().clamp(0, n_actions - 1)
    kind = tables.action_kind[act]
    arg = tables.action_arg[act]

    frozen = _at(state.agent_frozen, a)
    is_frozen = frozen != 0
    # the frozen tick-down happens on any (valid-index) action attempt
    state = state.replace(agent_frozen=masked_set(
        state.agent_frozen, a, frozen - 1, act_ok & is_frozen & (frozen > 0)))
    has_required = (_at(state.agent_inv, a) >= tables.action_required[act]).all(-1)
    attempt = act_ok & ~is_frozen & has_required

    success = attempt & (kind == ACT_NOOP)
    cv = attempt & (kind == ACT_CHANGE_VIBE)
    state = state.replace(agent_vibe=masked_set(state.agent_vibe, a, arg, cv))
    success = success | cv
    mv_ok, state = do_move(state, tables, a, arg, attempt & (kind == ACT_MOVE))
    success = success | mv_ok

    # motion tracking (whenever handle_action ran, i.e. act_ok & ~frozen)
    ran = act_ok & ~is_frozen
    r, c = _at(state.agent_r, a), _at(state.agent_c, a)
    moved = (r != _at(state.agent_prev_r, a)) | (c != _at(state.agent_prev_c, a))
    swm = torch.where(moved, 0, _at(state.agent_steps_without_motion, a) + 1)
    state = state.replace(
        agent_steps_without_motion=masked_set(state.agent_steps_without_motion, a, swm, ran),
        agent_prev_r=masked_set(state.agent_prev_r, a, r, ran),
        agent_prev_c=masked_set(state.agent_prev_c, a, c, ran),
    )

    # the action's own resources, on success
    if tables.any_action_consumed:
        consumed = tables.action_consumed[act]
        if tables.inv_vector_ok:
            state, _ = agent_update_multi(state, tables, a, -consumed, success)
        else:
            state = _each_resource(state, tables, a, -consumed, success[:, None] & (consumed > 0),
                                   _live(tables._cfg.action_consumed > 0))

    everyone = torch.ones_like(success)
    return state.replace(
        action_success=masked_set(state.action_success, a, success, everyone),
        executed_action=masked_set(state.executed_action, a,
                                    torch.where(success, act, torch.zeros_like(act)), everyone),
    )
