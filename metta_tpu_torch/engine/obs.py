"""Token observation blocks and the plain (gather) renderer.

Counterpart of ``metta_tpu/engine/obs.py``. Parity:
``bindings/mettagrid_c.cpp:397-563`` + ``systems/observation_encoder.hpp``.
Each observation is ``[num_tokens, 3] uint8`` of ``(packed_location,
feature_id, value)`` tokens: global tokens at the window center, an optional
compass token, then visible objects in center-out order until the buffer
fills. Empty slots are 0xff. Packed location = ``row<<4 | col`` in window
coordinates.

Per-object token *blocks* are built once per step (agents, object types,
assemblers, chests), compacted into one table of block ids, and each agent's
render reads the block id of each of its window cells. The block builders
return every token candidate with a validity mask; the compaction
(``obs_mm.compact_blocks``) keeps the first ``max_tokens_per_cell`` valid ones,
which is what the JAX ``_pad_block`` + compaction pair does.
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.obs_mm import compact_blocks
from metta_tpu_torch.engine.protocols import (
    select_protocol,
    select_unclip_protocol,
    surrounding_vibe_key,
)

EMPTY = 255


def _inventory_tokens(tables, inv):
    """Multi-token inventory encoding of inventories [..., R].

    Returns (feats, vals, valid) [..., R*n_tok]: base token per nonzero
    resource, power tokens while the shifted remainder is nonzero
    (observation_encoder.hpp:160-180), interleaved per resource."""
    base = tables.token_value_base
    n_tok = tables.num_inv_tokens
    inv = inv.to(torch.int64)
    pows = torch.tensor([base ** p for p in range(n_tok)], device=inv.device)
    shifted = torch.div(inv[..., None], pows, rounding_mode="floor")     # [..., R, n_tok]
    vals = torch.remainder(shifted, base)
    feats = tables.bcast("inv_feature_ids", shifted.dim()).to(torch.int64).expand(shifted.shape)
    flat = lambda x: x.reshape(x.shape[:-2] + (-1,))
    return flat(feats), flat(vals), flat(shifted > 0)


def _tag_tokens(tables, tags):
    """Tag tokens of tag rows [..., max_tags] (-1 pad)."""
    feats = torch.full(tags.shape, tables.feat_id["tag"], dtype=torch.int64,
                       device=tags.device)
    return feats, tags.to(torch.int64).clamp(min=0), tags >= 0


def _cat(*parts):
    """Concatenate (feats, vals, ok) triples along the token axis."""
    return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(3))


def build_agent_blocks(state, tables):
    """Agent token candidates [E, A, n]; order per agent.cpp:195-225."""
    E, A = state.agent_r.shape
    dev = state.agent_r.device
    f = tables.feat_id
    head_f = torch.tensor([f["agent:group"], f["agent:frozen"], f["vibe"]], device=dev)
    head = (
        head_f.expand(E, A, 3),
        torch.stack([tables.agent_group.to(torch.int64).expand(E, A),
                     (state.agent_frozen != 0).to(torch.int64),
                     state.agent_vibe.to(torch.int64)], dim=-1),
        torch.stack([torch.ones_like(state.agent_r, dtype=torch.bool),
                     torch.ones_like(state.agent_r, dtype=torch.bool),
                     state.agent_vibe != 0], dim=-1),
    )
    tags = _tag_tokens(tables, tables.agent_tags.expand(E, A, -1))
    return _cat(head, _inventory_tokens(tables, state.agent_inv), tags)


def build_wall_blocks(tables):
    """Per-object-type token candidates [NT, n] (or [E, NT, n] when the
    types' tables differ per env): tags then vibe (wall.hpp:26-38)."""
    vibe = tables.type_vibe.to(torch.int64)[..., None]
    vibe_tok = (torch.full_like(vibe, tables.feat_id["vibe"]), vibe, vibe != 0)
    return _cat(_tag_tokens(tables, tables.type_tags), vibe_tok)


def _asm_protocols(state, tables):
    """Selected protocol per assembler (p_idx [E, NA], use_un [E, NA])."""
    key_vec, n_agents = surrounding_vibe_key(
        tables, state.agent_grid, state.agent_vibe, state.asm_r, state.asm_c
    )
    p_norm = select_protocol(tables, state.asm_type, key_vec, n_agents)
    p_un = select_unclip_protocol(tables, state.asm_unclip_proto, key_vec, n_agents)
    use_un = state.asm_clipped
    return torch.where(use_un, p_un, p_norm), use_un


def build_assembler_blocks(state, tables):
    """Per-assembler token candidates [E, NA, n] (assembler.hpp:528-578)."""
    E, NA = state.asm_type.shape
    dev = state.asm_type.device
    f = tables.feat_id
    t = state.asm_type.long()
    type_vibe = tables.take("type_vibe", t).to(torch.int64)
    max_uses = tables.take("type_max_uses", t).to(torch.int64)
    remaining = (state.asm_cooldown_end - state.step[:, None]).to(torch.int64).clamp(0, 255)
    remaining_uses = (max_uses - state.asm_uses).clamp(0, 255)
    head_f = torch.tensor([f["cooldown_remaining"], f["clipped"], f["remaining_uses"]],
                          device=dev)
    parts = [(
        head_f.expand(E, NA, 3),
        torch.stack([remaining, state.asm_clipped.to(torch.int64), remaining_uses], -1),
        torch.stack([remaining > 0, state.asm_clipped, max_uses > 0], -1),
    )]
    if tables.protocol_details_obs:
        p_idx, use_un = _asm_protocols(state, tables)
        pn = p_idx.clamp(0, tables.n_protocols - 1)
        pu = p_idx.clamp(0, tables.n_unclip_protocols - 1)
        u = use_un[..., None]
        inputs = torch.where(u, tables.take("uproto_in", pu), tables.take("proto_in", pn))
        outputs = torch.where(u, tables.take("uproto_out", pu), tables.take("proto_out", pn))
        proto_v = torch.cat([inputs, outputs], -1).to(torch.int64)
        proto_f = torch.cat([tables.bcast(n, 3).expand(E, NA, -1) for n in
                             ("proto_input_feature", "proto_output_feature")], -1)
        parts.append((proto_f.to(torch.int64), proto_v,
                      (proto_v > 0) & (p_idx >= 0)[..., None]))
    parts.append(_tag_tokens(tables, tables.take("type_tags", t)))
    parts.append((torch.full_like(type_vibe, f["vibe"])[..., None], type_vibe[..., None],
                  (type_vibe != 0)[..., None]))
    feats, vals, ok = _cat(*parts)
    return feats, vals, ok & state.asm_valid[..., None]


def build_chest_blocks(state, tables):
    """Per-chest token candidates [E, NC, n]: vibe, inventory, tags
    (chest.hpp:128-150)."""
    t = state.chest_type.long()
    type_vibe = tables.take("type_vibe", t).to(torch.int64)
    feats, vals, ok = _cat(
        (torch.full_like(type_vibe, tables.feat_id["vibe"])[..., None], type_vibe[..., None],
         (type_vibe != 0)[..., None]),
        _inventory_tokens(tables, state.chest_inv),
        _tag_tokens(tables, tables.take("type_tags", t)),
    )
    return feats, vals, ok & state.chest_valid[..., None]


def block_table(state, tables):
    """Compacted token table of every block id, per env.

    Block ids: 0 none, 1..A agents, then object types, assemblers, chests.
    Returns (tok [E, NB, K, 2] uint8, counts [E, NB] int32)."""
    E, A = state.agent_r.shape
    dev = state.agent_r.device
    K = tables.max_tokens_per_cell

    def compacted(feats, vals, ok):
        return compact_blocks(feats, vals, ok, K)

    def empty(n):
        return (torch.zeros((E, n, K, 2), dtype=torch.uint8, device=dev),
                torch.zeros((E, n), dtype=torch.int32, device=dev))

    wall_tok, wall_cnt = compacted(*build_wall_blocks(tables))
    parts = [
        empty(1),
        compacted(*build_agent_blocks(state, tables)),
        (wall_tok.expand(E, -1, -1, -1), wall_cnt.expand(E, -1)),
        compacted(*build_assembler_blocks(state, tables))
        if tables.has_assemblers else empty(tables.n_assembler_slots),
        compacted(*build_chest_blocks(state, tables))
        if tables.has_chests else empty(tables.n_chest_slots),
    ]
    tok = torch.cat([p[0] for p in parts], dim=1).contiguous()
    counts = torch.cat([p[1] for p in parts], dim=1).contiguous()
    return tok, counts


def render_observations(state, tables, executed_actions, rewards_at_obs):
    """Render every agent's token observation -> [E, A, T, 3] uint8, by
    ``tables.obs_renderer`` (``metta_tpu/engine/obs.py:303-322``): ``"pl"``
    through kernel K5 (``ops/obs_render.py``), ``"mm"`` and ``"ref"``
    through the torch-ops renderer :func:`render_observations_ref`, the
    counterpart of the JAX package's XLA renderers (all byte-identical)."""
    if tables.obs_renderer == "pl":
        from metta_tpu_torch.ops.obs_render import prep_obs1, render_obs1

        return render_obs1(*prep_obs1(state, tables, executed_actions, rewards_at_obs),
                           tables.obs_scan, tables.num_obs_tokens, tables.obs_height // 2,
                           tables.obs_width // 2)
    return render_observations_ref(state, tables, executed_actions, rewards_at_obs)


def render_observations_ref(state, tables, executed_actions, rewards_at_obs):
    """Render every agent's token observation -> [E, A, T, 3] uint8.

    The plain gather renderer: block ids come straight from the state's
    grids (not the cached static block grid), then
    ``ops.obs_render3.render_obs3_plain`` places the tokens."""
    from metta_tpu_torch.engine.obs_mm import global_tokens_all
    from metta_tpu_torch.engine.tables import static_block_grid
    from metta_tpu_torch.ops.obs_render3 import render_obs3_plain

    tok, counts = block_table(state, tables)
    sbg = static_block_grid(tables, state.static_kind, state.static_idx, state.static_type)
    sb = torch.where(state.agent_grid > 0, state.agent_grid, sbg)
    g_count, g_tok = global_tokens_all(state, tables, executed_actions, rewards_at_obs)
    rc = torch.stack([state.agent_r, state.agent_c], dim=-1).to(torch.int32)
    return render_obs3_plain(
        sb, tok, counts, rc, g_count, g_tok, tables.obs_scan,
        tables.num_obs_tokens, tables.obs_height // 2, tables.obs_width // 2,
    )
