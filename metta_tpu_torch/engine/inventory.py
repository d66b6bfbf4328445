"""Inventory operations used by the batched step.

Counterpart of ``metta_tpu/engine/inventory.py`` (``trunc_div``,
``inv_update``). Parity targets: ``objects/inventory.cpp:37-92`` (clamped
``update``). Inventories are ``[..., R]`` int32 rows; limit semantics come from
the per-class tables of :class:`CompiledConfig`.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.compiler import INT16_MAX


def trunc_div(a, b):
    """C-style integer division truncating toward zero (b > 0)."""
    q = torch.div(a.abs(), b.clamp(min=1), rounding_mode="floor")
    return torch.where(a >= 0, q, -q)


def inv_update(inv_tables, cls, inv, r: int, delta):
    """Clamped update of resource ``r``; returns (new_inv, actual_delta).

    ``cls`` [...] int, ``inv`` [..., R], ``delta`` [...]. The cap is
    ``effective_limit - (group_amount - current)`` clamped to >= 0; the new
    amount is clamped to [0, cap] (inventory.cpp:37-92).
    """
    res_group, group_base, group_mod = inv_tables
    cls = cls.long()
    g = res_group[cls, r].long()                                   # [...]
    base = group_base[cls, g]
    bonus = (group_mod[cls, g] * inv).sum(-1)
    eff = (base + bonus).clamp(0, INT16_MAX)
    in_group = res_group[cls] == g[..., None]                      # [..., R]
    group_amt = torch.where(in_group, inv, torch.zeros_like(inv)).sum(-1)
    cur = inv[..., r]
    cap = (eff - (group_amt - cur).clamp(min=0)).clamp(min=0)
    clamped = torch.minimum((cur + delta).clamp(min=0), cap).to(inv.dtype)
    new_inv = inv.clone()
    new_inv[..., r] = clamped
    return new_inv, clamped - cur
