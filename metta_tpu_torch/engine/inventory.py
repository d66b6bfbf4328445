"""Inventory operations: shared limits, clamped updates, the shared_update fixpoint.

Counterpart of ``metta_tpu/engine/inventory.py``. Parity targets:
``objects/inventory.cpp:37-158`` (clamped ``update``, ``free_space``,
``enforce_all_limits`` with modifier-driven dynamic limits) and
``objects/has_inventory.cpp:7-74`` (``shared_update``). Inventories are
``[..., R]`` int32 rows; limit semantics come from the per-class tables of
:class:`CompiledConfig` (``res_group`` [C, R], ``group_base`` [C, G],
``group_mod`` [C, G, R]). Every function takes any leading dims; ``cls``,
``g`` and deltas carry those dims, ``r`` is a Python int.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.compiler import INT16_MAX


def trunc_div(a, b):
    """C-style integer division truncating toward zero (b > 0)."""
    q = torch.div(a.abs(), b.clamp(min=1), rounding_mode="floor")
    return torch.where(a >= 0, q, -q)


def group_effective_limit(inv_tables, cls, inv, g):
    """Effective limit of group ``g``: base + sum of modifier bonus x held,
    clamped (``inventory.hpp:21-34``)."""
    _, group_base, group_mod = inv_tables
    cls, g = cls.long(), g.long()
    bonus = (group_mod[cls, g] * inv).sum(-1)
    return (group_base[cls, g] + bonus).clamp(0, INT16_MAX)


def group_amount(inv_tables, cls, inv, g):
    """Amount held of the resources of group ``g``."""
    in_group = inv_tables[0][cls.long()] == g[..., None]
    return torch.where(in_group, inv, torch.zeros_like(inv)).sum(-1)


def _group_of(inv_tables, cls, inv, r: int):
    """(effective limit, amount held) of resource ``r``'s group."""
    g = inv_tables[0][cls.long(), r]
    return (group_effective_limit(inv_tables, cls, inv, g),
            group_amount(inv_tables, cls, inv, g))


def free_space(inv_tables, cls, inv, r: int):
    """Free space for resource ``r`` (inventory.cpp:96-109)."""
    eff, used = _group_of(inv_tables, cls, inv, r)
    return (eff - used).clamp(min=0)


def free_space_all(inv_tables, cls, inv):
    """Free space of every resource [..., R]: :func:`free_space` for each
    ``r`` at once, each resource's group through the same helpers."""
    g = inv_tables[0][cls.long()]                                  # [..., R]
    cls, inv = cls[..., None], inv[..., None, :]
    eff = group_effective_limit(inv_tables, cls, inv, g)
    return (eff - group_amount(inv_tables, cls, inv, g)).clamp(min=0)


def update_cap(inv_tables, cls, inv, r: int, ignore_limits: bool = False):
    """The most resource ``r`` may hold after an update:
    ``effective_limit - (group_amount - current)`` clamped to >= 0."""
    if ignore_limits:
        return torch.full(inv.shape[:-1], INT16_MAX, dtype=inv.dtype, device=inv.device)
    eff, used = _group_of(inv_tables, cls, inv, r)
    return (eff - (used - inv[..., r]).clamp(min=0)).clamp(min=0)


def inv_update(inv_tables, cls, inv, r: int, delta, ignore_limits: bool = False):
    """Clamped update of resource ``r``; returns (new_inv, actual_delta).

    The new amount is clamped to [0, cap] (:func:`update_cap`), so an
    over-limit inventory can shrink even on a nominally positive delta,
    matching the reference (inventory.cpp:37-92)."""
    cur = inv[..., r]
    cap = update_cap(inv_tables, cls, inv, r, ignore_limits)
    clamped = torch.minimum((cur + delta).clamp(min=0), cap).to(inv.dtype)
    new_inv = inv.clone()
    new_inv[..., r] = clamped
    return new_inv, clamped - cur


def enforce_limits(inv_tables, cls, inv, max_passes: int = 4):
    """Drop excess items after a limit decrease (inventory.cpp:128-158).

    Excess goes from each over-limit group's resources in ascending resource
    id, in up to ``max_passes`` passes (modifier chains can re-create
    excess); a pass after the first runs only where excess remains (the JAX
    ``lax.cond``). Returns (new_inv, dropped [..., R])."""
    R = inv.shape[-1]
    res_group = inv_tables[0][cls.long()]                          # [..., R]

    def over(inv, r):
        g = res_group[..., r]
        return (group_amount(inv_tables, cls, inv, g)
                - group_effective_limit(inv_tables, cls, inv, g))

    dropped = torch.zeros_like(inv)
    again = torch.ones(inv.shape[:-1], dtype=torch.bool, device=inv.device)
    for _ in range(max_passes):
        new, new_dropped = inv.clone(), dropped.clone()
        for r in range(R):
            drop = torch.minimum(new[..., r], over(new, r).clamp(min=0))
            new[..., r] -= drop
            new_dropped[..., r] += drop
        inv = torch.where(again[..., None], new, inv)
        dropped = torch.where(again[..., None], new_dropped, dropped)
        again = torch.stack([over(inv, r) > 0 for r in range(R)], -1).any(-1)
    return inv, dropped


def shared_update(cur, cap, free, delta, valid, do):
    """Split ``delta`` [E] across L inventories (has_inventory.cpp:7-74).

    Fixpoint: repeatedly kick out the inventories that would saturate at
    the current per-inventory share (each absorbs what it can, the rest is
    re-divided among the survivors); then the survivors take the remainder
    in reverse order, so earlier ones receive the rounding surplus.

    The L slots address distinct inventories and each is updated once, so
    a slot's amount ``cur``, clamp ``cap`` (:func:`update_cap`) and free
    space ``free`` ([E, L] each) stay what they were until the slot itself is
    updated: they are read once, and the JAX ``apply_fn`` calls become the
    returned per-slot deltas, which the caller applies with its clamped
    update. An update actually moves ``clamp(cur + d, 0, cap) - cur`` where
    ``do`` [E] holds, nothing elsewhere. ``valid`` [E, L] marks live slots.

    Returns (d [E, L], the delta each valid slot is updated by; consumed [E]).
    The JAX ``while_loop`` runs until no env kicks a slot; a pass runs only
    for the envs whose own loop is still going."""
    E, L = cur.shape
    zero = torch.zeros_like(delta)

    def actual(i, d):
        moved = torch.minimum((cur[:, i] + d).clamp(min=0), cap[:, i]) - cur[:, i]
        return torch.where(do, moved, zero)

    d_out = torch.zeros_like(cur)
    active = valid.clone()
    delta_rem = delta.clone()
    n_rem = valid.sum(-1).to(delta.dtype)
    going = n_rem > 0
    while bool(going.any()):
        per = trunc_div(delta_rem, n_rem)
        changed = torch.zeros_like(going)
        for i in range(L):
            update_now = torch.where(delta_rem > 0, free[:, i] <= per, cur[:, i] <= -per)
            kick = going & active[:, i] & update_now
            d_out[:, i] = torch.where(kick, per, d_out[:, i])
            delta_rem = torch.where(kick, delta_rem - actual(i, per), delta_rem)
            n_rem = n_rem - kick.to(n_rem.dtype)
            per = torch.where(kick & (n_rem > 0), trunc_div(delta_rem, n_rem), per)
            active[:, i] &= ~kick
            changed |= kick
        going = changed & (n_rem > 0)

    rank = active.long().cumsum(-1) - 1                            # rank among survivors
    for i in reversed(range(L)):
        take = active[:, i] & (n_rem > 0)
        d = trunc_div(delta_rem, (rank[:, i] + 1).to(delta.dtype))
        d_out[:, i] = torch.where(take, d, d_out[:, i])
        delta_rem = torch.where(take, delta_rem - actual(i, d), delta_rem)
    return d_out, delta - delta_rem
