"""Assembler protocol machinery: GroupVibe keys and protocol selection.

Counterpart of ``metta_tpu/engine/protocols.py``, batched over any leading
dims. Parity: ``objects/assembler.hpp:326-408``: the "local vibe" of an
assembler is the multiset of nonzero vibes shown by the 8 surrounding agents;
protocol lookup tries the exact key then falls back to the empty key, picking
the candidate with the largest ``min_agents`` that is <= the number of
surrounding agents (insertion order breaks ties, baked into ``proto_rank``).
The key is a sorted ascending length-8 vector, front-padded with zeros.
"""

from __future__ import annotations

import torch

NEIGHBOR_OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def agent_at(state, rr, cc):
    """(is_agent, agent_idx) of the occupant of cells (rr, cc) [E, ...].

    Derived by comparing against every agent position (an A-way compare),
    not from the occupancy grid: the sequential step moves agents one at a
    time and rebuilds the grid only after its loop
    (``metta_tpu/engine/protocols.py:agent_at``). Agents stand at distinct
    cells; ``agent_idx`` is 0 where no agent stands."""
    E = state.agent_r.shape[0]
    r = rr.reshape(E, -1, 1)
    c = cc.reshape(E, -1, 1)
    match = (state.agent_r[:, None, :] == r) & (state.agent_c[:, None, :] == c)  # [E, N, A]
    idx = match.to(torch.uint8).argmax(-1)
    return match.any(-1).reshape(rr.shape), idx.reshape(rr.shape)


def surrounding_agents(state, tables, r, c):
    """The 8 cells around (r, c) [E] from agent positions (:func:`agent_at`),
    as the sequential step's assembler reads them: (key_vec [E, 8],
    n_agents [E], is_agent [E, 8], agent_idx [E, 8], in_bounds [E, 8])
    (``metta_tpu/engine/protocols.py:surrounding_vibe_key``)."""
    H, W = tables.height, tables.width
    offs = torch.tensor(NEIGHBOR_OFFS, dtype=torch.int32, device=r.device)
    rr = r[:, None] + offs[:, 0]
    cc = c[:, None] + offs[:, 1]
    in_bounds = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    occ, a_idx = agent_at(state, rr, cc)
    is_agent = in_bounds & occ
    vibes = state.agent_vibe.gather(1, a_idx)
    vibes = torch.where(is_agent, vibes, torch.zeros_like(vibes))
    return (sorted_vibe_key(vibes, tables.num_vibes), is_agent.sum(-1), is_agent, a_idx,
            in_bounds)


def neighbors(tables, agent_grid, agent_vibe, r, c):
    """The 8 cells around (r, c), read from the occupancy grid.

    ``agent_grid`` [E, H, W] (agent idx+1, 0 empty), ``agent_vibe`` [E, A],
    ``r``/``c`` [E, N]. Returns (inb, is_agent, nb_idx, vibes), each
    [E, N, 8]; ``nb_idx``/``vibes`` are 0 where no agent stands.
    """
    E = agent_grid.shape[0]
    H, W = tables.height, tables.width
    offs = torch.tensor(NEIGHBOR_OFFS, dtype=torch.int64, device=r.device)
    rr = r.long()[..., None] + offs[:, 0]
    cc = c.long()[..., None] + offs[:, 1]
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = (rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)).reshape(E, -1)
    occ = agent_grid.reshape(E, -1).gather(1, flat).reshape(rr.shape)
    is_agent = inb & (occ > 0)
    nb_idx = torch.where(is_agent, occ - 1, torch.zeros_like(occ)).long()
    vibes = agent_vibe.gather(1, nb_idx.reshape(E, -1)).reshape(rr.shape)
    vibes = torch.where(is_agent, vibes, torch.zeros_like(vibes))
    return inb, is_agent, nb_idx, vibes


def sorted_vibe_key(vibes, num_vibes: int):
    """Ascending sort of [..., 8] vibes by counting (values in [0, V)), as
    the batched JAX paths do: key[j] = #{v : cum(v) <= j} with cum(v) the
    number of vibes in [0, v]."""
    v = torch.arange(num_vibes, device=vibes.device)
    cum = ((vibes[..., None] >= 0) & (vibes[..., None] <= v)).sum(-2)   # [..., V]
    j = torch.arange(8, device=vibes.device)
    return (cum[..., None, :] <= j[:, None]).sum(-1).to(torch.int32)


def surrounding_vibe_key(tables, agent_grid, agent_vibe, r, c):
    """(key_vec [E, N, 8], n_agents [E, N]) for the 8 cells around (r, c).

    OOB and non-agent cells contribute vibe 0, which is identical to an
    agent showing the default vibe (the semantics of the packed key)."""
    _, is_agent, _, vibes = neighbors(tables, agent_grid, agent_vibe, r, c)
    return sorted_vibe_key(vibes, tables.num_vibes), is_agent.sum(-1)


def _pick(tables, cand_mask):
    rank = tables.bcast("proto_rank", cand_mask.dim())
    score = torch.where(cand_mask, rank, torch.full_like(rank, -1))
    best = score.argmax(-1)
    return torch.where(score.amax(-1) >= 0, best, torch.full_like(best, -1))


def select_protocol(tables, type_id, key_vec, n_agents):
    """Index of the active protocol for an (unclipped) assembler, or -1.

    ``type_id``/``n_agents`` [E, ...], ``key_vec`` [E, ..., 8] -> [E, ...]
    int64."""
    nd = type_id.dim() + 1
    cands = (
        tables.bcast("proto_valid", nd)
        & (tables.bcast("proto_type", nd) == type_id[..., None])
        & (tables.bcast("proto_min_agents", nd) <= n_agents[..., None])
    )                                                                # [..., NP]
    key = tables.bcast("proto_key", nd + 1)
    exact = (key == key_vec[..., None, :]).all(-1)
    idx = _pick(tables, cands & exact)
    zero = (key == 0).all(-1)
    idx0 = _pick(tables, cands & zero)
    return torch.where(idx >= 0, idx, idx0)


def select_unclip_protocol(tables, uproto_idx, key_vec, n_agents):
    """The single assigned unclip protocol, if its key matches (else -1)."""
    NUP = tables.uproto_key.shape[-2]
    i = uproto_idx.long().clamp(0, NUP - 1)
    min_agents = tables.take("uproto_min_agents", i)
    key_i = tables.take("uproto_key", i)                             # [..., 8]
    ok = (uproto_idx >= 0) & (min_agents <= n_agents)
    key_match = (key_i == key_vec).all(-1) | (key_i == 0).all(-1)
    return torch.where(ok & key_match, i, torch.full_like(i, -1))
