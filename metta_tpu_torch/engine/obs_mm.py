"""Block compaction and global tokens for the token render.

Counterpart of ``_compact_blocks_mm`` and ``_global_tokens_all`` in
``metta_tpu/engine/obs_mm.py``, with the same semantics. The JAX functions
compact with rank one-hots (the TPU has no cheap gather or scatter); here a
stable valid-to-front compaction is one ``cumsum`` and one ``scatter`` into a
spare slot that is dropped afterwards. Outputs are the token bytes the render
kernel reads (values wrap mod 256, the engine's token byte contract).
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.scan import cumsum_last


def _compact(parts, ok, n_out: int):
    """Stable valid-to-front compaction of token candidates.

    ``parts``: list of P int tensors [..., n]; ``ok`` [..., n] bool. Keeps the
    first ``n_out`` valid candidates. Returns (tokens [..., n_out, P] uint8
    with unused slots 0, count [...] int32)."""
    rank = cumsum_last(ok) - ok.to(torch.int64)
    keep = ok & (rank < n_out)
    dest = torch.where(keep, rank, torch.full_like(rank, n_out))
    src = torch.stack([(p.to(torch.int64) & 255) for p in parts], dim=-1).to(torch.uint8)
    out = torch.zeros(src.shape[:-2] + (n_out + 1, len(parts)),
                      dtype=torch.uint8, device=src.device)
    out.scatter_(-2, dest[..., None].expand(src.shape), src)
    return out[..., :n_out, :].contiguous(), keep.sum(-1).to(torch.int32)


def compact_blocks(feats, vals, oks, K: int):
    """Valid tokens of each block moved to the front (stable), at most K.

    feats/vals/oks [..., NB, n] -> (tok [..., NB, K, 2] uint8 (feat, val),
    counts [..., NB] int32)."""
    return _compact([feats, vals], oks, K)


def global_tokens_all(state, tables, executed_actions, rewards_at_obs):
    """Global tokens of every agent, compacted.

    Returns (g_count [E, A] int32, g_tok [E, A, G, 3] uint8 (loc, feat, val))
    with G static (1 when the config has no global tokens)."""
    E, A = state.agent_r.shape
    dev = state.agent_r.device
    f = tables.feat_id
    ohr, owr = tables.obs_height // 2, tables.obs_width // 2
    center_loc = (ohr << 4) | owr
    ones = torch.ones((E, A), dtype=torch.int64, device=dev)
    tru = torch.ones((E, A), dtype=torch.bool, device=dev)
    feats, vals, oks, locs = [], [], [], []
    if tables.global_episode_completion:
        step = state.step.to(torch.int64)
        if tables.max_steps > 0:
            pct = torch.where(step >= tables.max_steps, 255,
                              torch.div(256 * step, tables.max_steps, rounding_mode="floor"))
        else:
            pct = torch.zeros_like(step)
        feats.append(ones * f["episode_completion_pct"])
        vals.append(pct[:, None].expand(E, A))
        oks.append(tru)
        locs.append(ones * center_loc)
    if tables.global_last_action:
        feats.append(ones * f["last_action"])
        vals.append(executed_actions.to(torch.int64))
        oks.append(tru)
        locs.append(ones * center_loc)
    if tables.global_last_reward:
        feats.append(ones * f["last_reward"])
        vals.append(torch.round(rewards_at_obs * 100.0).to(torch.int32).to(torch.int64))
        oks.append(tru)
        locs.append(ones * center_loc)
    if tables.global_goal:
        for r in range(tables.num_resources):
            feats.append(ones * f["goal"])
            vals.append(tables.bcast("inv_feature_ids", 4)[..., r, 0].to(torch.int64).expand(E, A))
            oks.append(tables.goal_token_mask[..., r].expand(E, A))
            locs.append(ones * center_loc)
    if tables.global_compass:
        sr = torch.sign(tables.height // 2 - state.agent_r.to(torch.int64))
        sc = torch.sign(tables.width // 2 - state.agent_c.to(torch.int64))
        feats.append(ones * f["agent:compass"])
        vals.append(ones)
        oks.append((sr != 0) | (sc != 0))
        locs.append(((ohr + sr) << 4) | (owr + sc))

    G = len(feats)
    if G == 0:
        return (torch.zeros((E, A), dtype=torch.int32, device=dev),
                torch.zeros((E, A, 1, 3), dtype=torch.uint8, device=dev))
    parts = [torch.stack(x, dim=-1) for x in (locs, feats, vals)]   # [E, A, G]
    g_tok, g_count = _compact(parts, torch.stack(oks, dim=-1), G)
    return g_count, g_tok
