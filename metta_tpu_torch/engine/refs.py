"""Masked inventory-reference operations on EnvState.

Counterpart of ``metta_tpu/engine/refs.py``. A "ref" addresses one
inventory: an agent's, or with ``kind`` :data:`REF_CHEST` a chest's. These
wrap :mod:`metta_tpu_torch.engine.inventory` with EnvState reads and writes
and the stat side effects of the reference's ``on_inventory_change``
callbacks (``agent.cpp:70-83`` gained/lost, ``chest.hpp:59-66`` the game's
deposit and withdraw stats). Every write is gated by a ``do`` mask, so the
sequential agent loop evaluates each branch for every env.

Agents and chests are addressed per env: ``a`` is an [E] (or [E, L]) int
tensor of indices, read at ``(arange(E), a)``. Writes add each row's
change, so an [E, L] index must name distinct inventories wherever ``do``
holds (the slots of an assembler's neighbourhood do); rows where ``do``
fails add nothing.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.inventory import (
    enforce_limits,
    free_space,
    free_space_all,
    inv_update,
    update_cap,
)

REF_AGENT = 0
REF_CHEST = 1


def rows_at(x, a):
    """``x[e, a[e, ...]]`` of an [E, A, ...] tensor for an [E, ...] index."""
    e = torch.arange(x.shape[0], device=x.device).view((-1,) + (1,) * (a.dim() - 1))
    return x[e, a.long()]


def masked_set(x, a, value, do):
    """``x`` with ``x[e, a[e]] = value[e]`` where ``do[e]``."""
    e = torch.arange(x.shape[0], device=x.device)
    out = x.clone()
    out[e, a.long()] = torch.where(do, value, x[e, a.long()]).to(x.dtype)
    return out


def add_at(x, a, v):
    """``x`` with ``v`` [E, ..., *x.shape[2:]] added at rows ``a`` [E, ...]."""
    E, tail = x.shape[0], x.shape[2:]
    idx = a.long().reshape((E, -1) + (1,) * len(tail))
    v = v.reshape((E, idx.shape[1]) + tail).to(x.dtype)
    return x.scatter_add(1, idx.expand(v.shape), v)


def add_item_at(x, a, r: int, v):
    """``x`` with ``v`` [E, ...] added at ``x[e, a, r]``."""
    out = x.clone()
    out[:, :, r] = add_at(x[:, :, r], a, v)
    return out


def agent_inv_write(state, tables, a, new_inv, actual_r: int, actual, do):
    """Write agents ``a``'s inventory rows where ``do``, with gained/lost
    accounting for item ``actual_r``."""
    old = rows_at(state.agent_inv, a)
    change = torch.where(do[..., None], new_inv - old, torch.zeros_like(old))
    state = state.replace(agent_inv=add_at(state.agent_inv, a, change))
    if tables.track_gained:
        zero = torch.zeros_like(actual)
        state = state.replace(
            agent_gained=add_item_at(state.agent_gained, a, actual_r,
                                   torch.where(do & (actual > 0), actual, zero)),
            agent_lost=add_item_at(state.agent_lost, a, actual_r,
                                 torch.where(do & (actual < 0), -actual, zero)),
        )
    return state


def agent_update(state, tables, a, r: int, delta, do, ignore_limits: bool = False):
    """Clamped update of agents ``a``'s resource ``r``; returns
    (state, actual_delta). A loss of a limit modifier drops what the lowered
    limits no longer hold (``enforce_limits``)."""
    inv = rows_at(state.agent_inv, a)
    cls = tables.agent_inv_class[a.long()]
    new_inv, actual = inv_update(tables.inv_tables, cls, inv, r, delta, ignore_limits)
    actual = torch.where(do, actual, torch.zeros_like(actual))
    state = agent_inv_write(state, tables, a, new_inv, r, actual, do)
    if tables.has_mods:
        cascade = do & (actual < 0) & tables.inv_is_modifier[cls.long(), r]
        inv = rows_at(state.agent_inv, a)
        inv2, dropped = enforce_limits(tables.inv_tables, cls, inv)
        keep = ~cascade[..., None]
        state = state.replace(agent_inv=add_at(
            state.agent_inv, a, torch.where(keep, torch.zeros_like(inv), inv2 - inv)))
        if tables.track_gained:
            state = state.replace(agent_lost=add_at(
                state.agent_lost, a, torch.where(keep, torch.zeros_like(dropped), dropped)))
    return state, actual


def chest_class(state, tables, i):
    """Inventory class of chests ``i`` (their type's)."""
    return tables.chest_type_inv_class[rows_at(state.chest_type, i).long()]


def chest_update(state, tables, i, r: int, delta, do):
    """Clamped update of chests ``i``'s resource ``r`` with the game stats;
    returns (state, actual_delta)."""
    inv = rows_at(state.chest_inv, i)
    new_inv, actual = inv_update(tables.inv_tables, chest_class(state, tables, i), inv, r, delta)
    actual = torch.where(do, actual, torch.zeros_like(actual))
    change = torch.where(do[..., None], new_inv - inv, torch.zeros_like(inv))
    state = state.replace(chest_inv=add_at(state.chest_inv, i, change))
    if tables.track_chest_stats:
        dep, wd = state.game_chest_deposited.clone(), state.game_chest_withdrawn.clone()
        dep[:, r] += actual.clamp(min=0).reshape(dep.shape[0], -1).sum(1)
        wd[:, r] += (-actual).clamp(min=0).reshape(wd.shape[0], -1).sum(1)
        state = state.replace(game_chest_deposited=dep, game_chest_withdrawn=wd)
    return state, actual


def agent_free_space_vec(state, tables, a):
    """[E, R] free space of every resource of agents ``a`` [E]."""
    return free_space_all(tables.inv_tables, tables.agent_inv_class[a.long()],
                          rows_at(state.agent_inv, a))


def _by_kind(state, tables, idx, kind, fn):
    """``fn(rows, cls)`` of the agents ``idx``, or with ``kind`` of each
    ref's own inventory, an agent's or a chest's (the JAX refs' ``where``
    on ``kind``)."""
    if kind is None:
        return fn(rows_at(state.agent_inv, idx), tables.agent_inv_class[idx.long()])
    a = idx.clamp(0, tables.num_agents - 1)
    ch = idx.clamp(0, tables.n_chest_slots - 1)
    return torch.where(kind == REF_AGENT,
                       fn(rows_at(state.agent_inv, a), tables.agent_inv_class[a.long()]),
                       fn(rows_at(state.chest_inv, ch), chest_class(state, tables, ch)))


def ref_amount(state, tables, idx, r: int, kind=None):
    """Amount of item ``r`` the refs hold (agents, or by ``kind``)."""
    return _by_kind(state, tables, idx, kind, lambda rows, cls: rows[..., r])


def ref_free(state, tables, idx, r: int, kind=None):
    return _by_kind(state, tables, idx, kind,
                    lambda rows, cls: free_space(tables.inv_tables, cls, rows, r))


def ref_cap(state, tables, idx, r: int, kind=None):
    """The clamp of an update of item ``r`` (``inventory.update_cap``)."""
    return _by_kind(state, tables, idx, kind,
                    lambda rows, cls: update_cap(tables.inv_tables, cls, rows, r))


def ref_update(state, tables, idx, r: int, delta, do, kind=None):
    """Update the inventories the refs address (agents, or each ref's
    ``kind``: :data:`REF_AGENT` or :data:`REF_CHEST`); returns (state,
    actual)."""
    if kind is None:
        return agent_update(state, tables, idx, r, delta, do)
    is_agent = kind == REF_AGENT
    state, actual_a = agent_update(state, tables, idx.clamp(0, tables.num_agents - 1), r,
                                   delta, do & is_agent)
    state, actual_c = chest_update(state, tables, idx.clamp(0, tables.n_chest_slots - 1), r,
                                   delta, do & ~is_agent)
    return state, torch.where(is_agent, actual_a, actual_c)
