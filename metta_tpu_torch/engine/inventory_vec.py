"""Vectorized inventory fast path (all resources of an inventory at once).

Counterpart of ``metta_tpu/engine/inventory_vec.py:25-54`` and ``:70-181``
for agent inventories. Enabled when ``tables.inv_vector_ok`` (every limit
group is a single resource, no modifiers): per-resource clamped updates are
then order-independent, so the reference's per-item loops collapse into
[..., R] row operations. The chest and all-agents variants wait for chests.

Agents are addressed per env: ``a`` [E] (or ``idxs`` [E, L]) int agent
indices, read and written at ``(arange(E), a)``.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.compiler import INT16_MAX
from metta_tpu_torch.engine.inventory import trunc_div
from metta_tpu_torch.engine.refs import add_at, rows_at


def row_limits(tables, cls):
    """Per-resource effective limits [..., R] of singleton-group inventories
    of class ``cls`` [...]."""
    res_group, group_base, _ = tables.inv_tables
    cls = cls.long()
    lim = group_base[cls].gather(-1, res_group[cls].long())
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


def ref_rows(state, tables, idxs):
    """Inventory rows [E, L, R] of agents ``idxs`` [E, L] and their limits
    (``_ref_rows`` of the JAX module, agent refs only)."""
    return (rows_at(state.agent_inv, idxs),
            row_limits(tables, tables.agent_inv_class[idxs.long()]))


def _apply_ref_rows(state, tables, idxs, deltas, mask):
    """Apply clamped per-slot deltas [E, L, R] where ``mask`` [E, L, R];
    returns (state, actual [E, L, R]). The live slots address distinct
    agents, so a scatter-add is race-free; masked slots add zero."""
    rows, lims = ref_rows(state, tables, idxs)
    new = torch.minimum((rows + deltas).clamp(min=0), lims)
    actual = torch.where(mask, new - rows, torch.zeros_like(rows)).to(rows.dtype)
    state = state.replace(agent_inv=add_at(state.agent_inv, idxs, actual))
    if tables.track_gained:
        state = state.replace(agent_gained=add_at(state.agent_gained, idxs, actual.clamp(min=0)),
                              agent_lost=add_at(state.agent_lost, idxs, (-actual).clamp(min=0)))
    return state, actual


def shared_update_multi(state, tables, idxs, valid, deltas, do):
    """Distribute ``deltas`` [E, R] across the agents ``idxs`` [E, L] where
    ``valid`` [E, L] (has_inventory.cpp:7-74), every resource at once; each
    pass kicks every saturating slot together, and the remainder goes out in
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
        rows, lims = ref_rows(state, tables, idxs)
        free = (lims - rows).clamp(min=0)
        kick = active & torch.where(delta_rem[:, None] > 0, free <= per[:, None],
                                    rows <= -per[:, None])
        state, actual = _apply_ref_rows(
            state, tables, idxs, per[:, None].expand(kick.shape), kick)
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
    state, actual = _apply_ref_rows(state, tables, idxs, d, active)
    delta_rem = delta_rem - actual.sum(1)
    return state, deltas - delta_rem
