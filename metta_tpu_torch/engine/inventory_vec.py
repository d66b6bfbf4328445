"""Vectorized inventory fast path (all resources of an inventory at once).

Counterpart of ``metta_tpu/engine/inventory_vec.py``. Enabled when
``tables.inv_vector_ok`` (every limit group is a single resource, no
modifiers): per-resource clamped updates are then order-independent, so the
reference's per-item loops collapse into [..., R] row operations.

Inventories are addressed per env: ``a`` [E] (or ``idxs`` [E, L]) int
indices, read and written at ``(arange(E), a)``; a ref's ``kinds``
(``refs.REF_AGENT`` or ``refs.REF_CHEST``, None for agents only) says
whether it is an agent's inventory or a chest's.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.compiler import INT16_MAX
from metta_tpu_torch.engine.inventory import trunc_div
from metta_tpu_torch.engine.refs import REF_AGENT, add_at, chest_class, rows_at


def row_limits(tables, cls):
    """Per-resource effective limits [..., R] of singleton-group inventories
    of class ``cls`` [...] ([E, ...] where the limit tables are per env)."""
    cls = cls.long()
    lim = tables.take("inv_group_base", cls).gather(
        -1, tables.take("inv_res_group", cls).long())
    return lim.clamp(0, INT16_MAX)


def clamp_row(tables, cls, inv_row, deltas):
    """Clamped multi-resource update; returns (new_row, actual_row)."""
    lim = row_limits(tables, cls)
    new = torch.minimum((inv_row + deltas).clamp(min=0), lim).to(inv_row.dtype)
    return new, new - inv_row


def agent_update_multi(state, tables, a, deltas, do):
    """Update every resource of agent ``a`` [E] by ``deltas`` [E, R] where
    ``do`` [E]. Returns (state, actual [E, R])."""
    inv = rows_at(state.agent_inv, a)
    _, actual = clamp_row(tables, tables.agent_inv_class[a.long()], inv, deltas)
    actual = torch.where(do[:, None], actual, torch.zeros_like(actual))
    state = state.replace(agent_inv=add_at(state.agent_inv, a, actual))
    if tables.track_gained:
        state = state.replace(agent_gained=add_at(state.agent_gained, a, actual.clamp(min=0)),
                              agent_lost=add_at(state.agent_lost, a, (-actual).clamp(min=0)))
    return state, actual


def chest_update_multi(state, tables, i, deltas, do):
    """Update every resource of chest ``i`` [E] by ``deltas`` [E, R] where
    ``do`` [E], with the game's chest stats. Returns (state, actual [E, R])."""
    inv = rows_at(state.chest_inv, i)
    _, actual = clamp_row(tables, chest_class(state, tables, i), inv, deltas)
    actual = torch.where(do[:, None], actual, torch.zeros_like(actual))
    state = state.replace(chest_inv=add_at(state.chest_inv, i, actual))
    if tables.track_chest_stats:
        state = state.replace(
            game_chest_deposited=state.game_chest_deposited + actual.clamp(min=0),
            game_chest_withdrawn=state.game_chest_withdrawn + (-actual).clamp(min=0))
    return state, actual


def all_agents_update_multi(state, tables, deltas, do):
    """Independent multi-resource updates of every agent: ``deltas`` and
    ``do`` [E, A, R]. Returns (state, actual [E, A, R])."""
    inv = state.agent_inv
    _, actual = clamp_row(tables, tables.agent_inv_class.expand(inv.shape[:2]), inv, deltas)
    actual = torch.where(do, actual, torch.zeros_like(actual))
    state = state.replace(agent_inv=inv + actual)
    if tables.track_gained:
        state = state.replace(agent_gained=state.agent_gained + actual.clamp(min=0),
                              agent_lost=state.agent_lost + (-actual).clamp(min=0))
    return state, actual


def _ref_index(tables, idxs, kinds):
    """(agent index, chest index, is-agent mask [E, L, 1]) of mixed refs."""
    return (idxs.clamp(0, tables.num_agents - 1), idxs.clamp(0, tables.n_chest_slots - 1),
            (kinds == REF_AGENT)[..., None])


def ref_rows(state, tables, idxs, kinds=None):
    """Inventory rows [E, L, R] of the refs ``idxs`` [E, L] (agents, or by
    ``kinds``) and their limits (``_ref_rows`` of the JAX module)."""
    if kinds is None:
        return (rows_at(state.agent_inv, idxs),
                row_limits(tables, tables.agent_inv_class[idxs.long()]))
    a, ch, is_agent = _ref_index(tables, idxs, kinds)
    rows = torch.where(is_agent, rows_at(state.agent_inv, a), rows_at(state.chest_inv, ch))
    lims = torch.where(is_agent, row_limits(tables, tables.agent_inv_class[a.long()]),
                       row_limits(tables, chest_class(state, tables, ch)))
    return rows, lims


def _apply_ref_rows(state, tables, idxs, deltas, mask, kinds=None):
    """Apply clamped per-slot deltas [E, L, R] where ``mask`` [E, L, R];
    returns (state, actual [E, L, R]). The live slots address distinct
    inventories, so a scatter-add is race-free; masked slots add zero."""
    rows, lims = ref_rows(state, tables, idxs, kinds)
    new = torch.minimum((rows + deltas).clamp(min=0), lims)
    actual = torch.where(mask, new - rows, torch.zeros_like(rows)).to(rows.dtype)
    if kinds is None:
        a, d_agent = idxs, actual
    else:
        a, ch, is_agent = _ref_index(tables, idxs, kinds)
        zero = torch.zeros_like(actual)
        d_agent, d_chest = torch.where(is_agent, actual, zero), torch.where(is_agent, zero, actual)
        state = state.replace(chest_inv=add_at(state.chest_inv, ch, d_chest))
        if tables.track_chest_stats:
            state = state.replace(
                game_chest_deposited=state.game_chest_deposited
                + d_chest.clamp(min=0).sum(1).to(torch.int32),
                game_chest_withdrawn=state.game_chest_withdrawn
                + (-d_chest).clamp(min=0).sum(1).to(torch.int32))
    state = state.replace(agent_inv=add_at(state.agent_inv, a, d_agent))
    if tables.track_gained:
        state = state.replace(agent_gained=add_at(state.agent_gained, a, d_agent.clamp(min=0)),
                              agent_lost=add_at(state.agent_lost, a, (-d_agent).clamp(min=0)))
    return state, actual


def shared_update_multi(state, tables, idxs, valid, deltas, do, kinds=None):
    """Distribute ``deltas`` [E, R] across the refs ``idxs`` [E, L] (agents,
    or by ``kinds``) where ``valid`` [E, L] (has_inventory.cpp:7-74), every
    resource at once; each pass kicks every saturating slot together, and
    the remainder goes out in
    the closed form of the reference's reverse loop. Runs while any env
    kicks a slot (the JAX ``while_loop``; a pass that kicks nothing changes
    nothing). Returns (state, consumed [E, R])."""
    deltas = torch.where(do[:, None], deltas, torch.zeros_like(deltas))
    active = valid[:, :, None] & (deltas != 0)[:, None, :]                 # [E, L, R]
    n_rem = active.sum(1)                                                  # [E, R]
    delta_rem = deltas.long()
    zero = torch.zeros_like(delta_rem)
    going = True
    while going:
        per = torch.where(n_rem > 0, trunc_div(delta_rem, n_rem), zero)     # [E, R]
        rows, lims = ref_rows(state, tables, idxs, kinds)
        free = (lims - rows).clamp(min=0)
        kick = active & torch.where(delta_rem[:, None] > 0, free <= per[:, None],
                                    rows <= -per[:, None])
        state, actual = _apply_ref_rows(
            state, tables, idxs, per[:, None].expand(kick.shape), kick, kinds)
        delta_rem = delta_rem - actual.sum(1)
        n_rem = n_rem - kick.sum(1)
        active = active & ~kick
        going = bool(kick.any()) and bool((n_rem > 0).any())

    rank = active.long().cumsum(1) - 1                                     # [E, L, R]
    base = torch.where(n_rem > 0, trunc_div(delta_rem, n_rem), zero)
    surplus = delta_rem - base * n_rem
    extra = torch.where(rank < surplus.abs()[:, None], surplus.sign()[:, None],
                        torch.zeros_like(rank))
    d = torch.where(active, base[:, None] + extra, torch.zeros_like(extra))
    state, actual = _apply_ref_rows(state, tables, idxs, d, active, kinds)
    delta_rem = delta_rem - actual.sum(1)
    return state, deltas - delta_rem
