"""Assembler onUse for the sequential step.

Counterpart of ``metta_tpu/engine/assembler.py:31-254``. Parity:
``objects/assembler.hpp:455-526`` (onUse), ``:48-121`` (surrounding agents
rotated from the actor's slot), ``:427-453`` (partial-usage scaling),
``:125-223`` (afford / receive checks, shared_update consume + distribute).

One call serves one agent per env: ``a`` and ``asm_idx`` are [E], and every
branch is masked, so each env takes its own path. The input refs are the 8
neighbours, then, with the assembler chest search (``:103-130``,
``metta_tpu/engine/assembler.py:103-130``), the chests within the type's
Chebyshev distance in row-major window order.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.inventory import shared_update
from metta_tpu_torch.engine.inventory_vec import ref_rows, shared_update_multi
from metta_tpu_torch.engine.protocols import (
    NEIGHBOR_OFFS,
    select_protocol,
    select_unclip_protocol,
    surrounding_agents,
)
from metta_tpu_torch.engine.refs import (
    REF_AGENT,
    REF_CHEST,
    masked_set,
    ref_amount,
    ref_cap,
    ref_free,
    ref_update,
)
from metta_tpu_torch.engine.refs import rows_at as _at
from metta_tpu_torch.engine.state import KIND_CHEST


def _ceil_div(a, b):
    return torch.div(a + b - 1, b.clamp(min=1), rounding_mode="floor")


def _shared_item(state, tables, idx, valid, r: int, delta, ok, kind=None):
    """shared_update of item ``r`` over the refs ``idx`` [E, L] (agents, or
    by ``kind``): the slots' amounts, free space and clamps read once, the
    fixpoint on them, then each valid slot's update. Returns (state,
    consumed [E])."""
    cur = ref_amount(state, tables, idx, r, kind)
    d, consumed = shared_update(cur, ref_cap(state, tables, idx, r, kind),
                                ref_free(state, tables, idx, r, kind), delta, valid, ok)
    state, _ = ref_update(state, tables, idx, r, d, ok[:, None] & valid, kind)
    return state, consumed


def chest_refs(state, tables, t, ar_, ac_):
    """(chest index, is-chest mask), [E, N] each, of the cells of the search
    window around assemblers at (``ar_``, ``ac_``) of types ``t`` [E]: every
    cell within ``chest_search_distance`` but the centre, row-major, a chest
    there within its type's Chebyshev distance."""
    d_max = tables.chest_search_distance
    cells = [(dr, dc) for dr in range(-d_max, d_max + 1) for dc in range(-d_max, d_max + 1)
             if not (dr == 0 and dc == 0)]
    offs = torch.tensor(cells, dtype=torch.int64, device=ar_.device)
    H, W = tables.height, tables.width
    rr = ar_.long()[:, None] + offs[:, 0]
    cc = ac_.long()[:, None] + offs[:, 1]
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)
    cheb = torch.maximum(offs[:, 0].abs(), offs[:, 1].abs())
    within = cheb <= tables.type_chest_search[t][:, None]
    kind = state.static_kind.flatten(1).gather(1, flat)
    is_chest = inb & within & (kind == KIND_CHEST)
    idx = torch.where(is_chest, state.static_idx.flatten(1).gather(1, flat), 0)
    return idx.to(torch.int32), is_chest


def assembler_use(state, tables, a, asm_idx, mask):
    """Agents ``a`` [E] use assemblers ``asm_idx`` [E] where ``mask`` [E].
    Returns (success [E], state)."""
    E = a.shape[0]
    dev = a.device
    NA, R, V = tables.n_assembler_slots, tables.num_resources, tables.num_vibes
    i = asm_idx.long().clamp(0, NA - 1)
    t = _at(state.asm_type, i).long()
    ar_, ac_ = _at(state.asm_r, i), _at(state.asm_c, i)

    # --- gate: max_uses, cooldown ---
    max_uses = tables.type_max_uses[t]
    ok = mask & ((max_uses == 0) | (_at(state.asm_uses, i) < max_uses))
    remaining = (_at(state.asm_cooldown_end, i) - state.step).clamp(min=0)
    allow_partial = tables.type_allow_partial[t]
    ok = ok & ((remaining == 0) | allow_partial)

    # --- protocol selection ---
    key_vec, n_agents, nb_is_agent, nb_agent_idx, nb_inb = surrounding_agents(
        state, tables, ar_, ac_)
    clipped = _at(state.asm_clipped, i)
    p_norm = select_protocol(tables, t, key_vec, n_agents)
    p_un = select_unclip_protocol(tables, _at(state.asm_unclip_proto, i), key_vec, n_agents)
    p_idx = torch.where(clipped, p_un, p_norm)
    ok = ok & (p_idx >= 0)
    pn = p_idx.clamp(0, tables.n_protocols - 1)
    pu = p_idx.clamp(0, tables.n_unclip_protocols - 1)

    def gather(name):
        n, u = getattr(tables, "proto_" + name)[pn], getattr(tables, "uproto_" + name)[pu]
        return torch.where(clipped.view((E,) + (1,) * (n.dim() - 1)), u, n)

    inputs, outputs = gather("in"), gather("out")                       # [E, R]
    cooldown, nvibes = gather("cooldown"), gather("nvibes")            # [E]
    vibe_counts = gather("vibe_counts")                                 # [E, V]
    orig_has_output = (outputs > 0).any(-1)

    # --- partial-usage scaling (assembler.hpp:427-453) ---
    if tables.any_allow_partial:
        cd_dur = _at(state.asm_cooldown_duration, i)
        duration = cd_dur.clamp(min=1)[:, None]
        elapsed = (cd_dur - remaining)[:, None]
        do_scale = (remaining > 0) & allow_partial
        inputs = torch.where(do_scale[:, None], _ceil_div(inputs * elapsed, duration), inputs)
        outputs = torch.where(do_scale[:, None],
                              torch.div(outputs * elapsed, duration, rounding_mode="floor"),
                              outputs)
        wasteful = do_scale & ~(outputs > 0).any(-1) & orig_has_output & ~clipped
        ok = ok & ~wasteful

    # --- input refs: the surrounding agents rotated from the actor's slot ---
    rank_inb = nb_inb.long().cumsum(-1) - 1
    n_inb = nb_inb.sum(-1, keepdim=True)
    offs = torch.tensor(NEIGHBOR_OFFS, dtype=torch.int32, device=dev)
    actor_dr = (_at(state.agent_r, a) - ar_)[:, None]
    actor_dc = (_at(state.agent_c, a) - ac_)[:, None]
    is_actor_slot = (offs[:, 0] == actor_dr) & (offs[:, 1] == actor_dc)
    start_rank = torch.where(is_actor_slot, rank_inb, torch.zeros_like(rank_inb)).sum(
        -1, keepdim=True)
    rot = torch.remainder(rank_inb - start_rank, n_inb.clamp(min=1))
    order_key = torch.where(nb_is_agent, rot, 1000 + torch.arange(8, device=dev))
    order = order_key.argsort(dim=-1, stable=True)
    agent_idx = nb_agent_idx.gather(-1, order)
    agent_valid = nb_is_agent.gather(-1, order)

    # --- input refs: the rotated agents, then the chests the search finds ---
    in_kind = None
    ref_idx, ref_valid = agent_idx, agent_valid
    if tables.chest_search_distance > 0:
        chest_idx, is_chest = chest_refs(state, tables, t, ar_, ac_)
        ref_idx = torch.cat([agent_idx.to(torch.int32), chest_idx], -1)
        ref_valid = torch.cat([agent_valid, is_chest], -1)
        in_kind = torch.cat([torch.full_like(agent_idx, REF_AGENT, dtype=torch.int32),
                             torch.full_like(chest_idx, REF_CHEST)], -1)

    # --- afford check: totals across the input refs ---
    inv_rows = ref_rows(state, tables, ref_idx, in_kind)[0]         # [E, L, R]
    totals = torch.where(ref_valid[..., None], inv_rows, torch.zeros_like(inv_rows)).sum(1)
    ok = ok & ((inputs == 0) | (totals >= inputs)).all(-1)

    # --- output refs (assembler.hpp:198-223): single-vibe protocols pay the
    # actor; multi-vibe ones the participating vibers, in rotated order ---
    counts = vibe_counts.clone()
    n_sel = torch.zeros_like(nvibes)
    sel = []
    for s in range(8):
        v = state.agent_vibe.gather(1, agent_idx[:, s:s + 1])[:, 0]
        vc = v.long().clamp(0, V - 1)
        want = agent_valid[:, s] & (v != 0) & (_at(counts, vc) > 0) & (n_sel < nvibes)
        counts = counts.scatter_add(1, vc[:, None], -want[:, None].to(counts.dtype))
        n_sel = n_sel + want.to(n_sel.dtype)
        sel.append(want)
    sel_valid = torch.stack(sel, -1)
    use_multi = ((nvibes > 1) & (n_sel > 0))[:, None]
    slot0 = torch.arange(8, device=dev) == 0
    out_idx = torch.where(use_multi, agent_idx, a[:, None].to(agent_idx.dtype))
    out_valid = torch.where(use_multi, sel_valid, slot0)

    # --- receive check (assembler.hpp:146-178) ---
    if tables.inv_vector_ok:
        o_rows, o_lims = ref_rows(state, tables, out_idx)
        out_frees = (o_lims - o_rows).clamp(min=0)                       # [E, 8, R]
    else:
        out_frees = torch.stack([ref_free(state, tables, out_idx, r)
                                 for r in range(R)], -1)
    total_free = torch.where(out_valid[..., None], out_frees,
                             torch.zeros_like(out_frees)).sum(1)
    has_output = (outputs > 0).any(-1)
    can_absorb = ((outputs > 0) & (total_free >= 1)).any(-1)
    ok = ok & (~has_output | can_absorb | clipped)

    # --- consume inputs, distribute outputs ---
    if tables.inv_vector_ok:
        state, _ = shared_update_multi(state, tables, ref_idx, ref_valid, -inputs, ok,
                                       in_kind)
        state, created = shared_update_multi(state, tables, out_idx, out_valid, outputs, ok)
        created = created.clamp(min=0)
    else:
        zero = torch.zeros_like(inputs[:, 0])
        for r in range(R):
            state, _ = _shared_item(state, tables, ref_idx, ref_valid, r,
                                    torch.where(ok, -inputs[:, r], zero), ok, in_kind)
        created = []
        for r in range(R):
            state, dist = _shared_item(state, tables, out_idx, out_valid, r,
                                       torch.where(ok, outputs[:, r], zero), ok)
            created.append(dist.clamp(min=0))
        created = torch.stack(created, -1)
    if tables.track_chest_stats:
        state = state.replace(
            game_asm_created=(state.game_asm_created + created).to(state.game_asm_created.dtype))
    return _finish(state, i, ok, clipped, cooldown)


def _finish(state, i, ok, clipped, cooldown):
    """Cooldown / uses / unclip bookkeeping after a (masked) use."""
    unclip_now = ok & clipped
    return ok, state.replace(
        asm_cooldown_duration=masked_set(state.asm_cooldown_duration, i, cooldown, ok),
        asm_cooldown_end=masked_set(state.asm_cooldown_end, i, state.step + cooldown, ok),
        asm_uses=masked_set(state.asm_uses, i, _at(state.asm_uses, i) + 1, ok & ~clipped),
        asm_clipped=masked_set(state.asm_clipped, i, torch.zeros_like(clipped), unclip_now),
        asm_unclip_proto=masked_set(state.asm_unclip_proto, i,
                                    torch.full_like(i, -1), unclip_now),
    )
