"""Batched (vectorized-over-agents) environment step.

Counterpart of ``metta_tpu/engine/step_batched.py:step_env_batched``: every
agent of every env resolves at once, with rank-based conflict arbitration.
The per-step random permutation becomes a priority *rank*, and every conflict
(contested cell, attack target, station) is won by the lowest-rank agent,
the one that would have acted first sequentially. The module docstring of
the JAX step lists where this differs from the sequential reference step.

A step is :func:`batched_step`: the rank, an interaction span (decode to
action consumption) and the tail (motion stats, stat rewards, episode end).
:func:`interaction_span` is the span in torch ops, and the plain version of
the fused kernel K2 (``ops/sim_fused.py``), which takes its place on the
``track_stats=False`` path.

Where the port departs from the JAX formulation:

- The JAX step expresses every table lookup, grid read, per-target reduction
  and the grid rebuild as one-hot float GEMMs, because the TPU serializes
  gathers and scatters. On a GPU those GEMMs would be a trap (TF32 there,
  as bf16 was on the TPU); here they are integer indexing, ``gather``,
  ``scatter_add`` and ``scatter_reduce``. No float op touches an integer.
- The assembler phase indexes claimed stations by their claimant agent (at
  most one station per agent, at most one winner per station) instead of
  compacting the station axis with a cumsum one-hot.
- Randomness is an explicit input: ``perm`` [E, A], else a permutation drawn
  from the caller's ``torch.Generator``.

Subsystems the ported configs do not use raise ``NotImplementedError``
naming their JAX source (see :func:`check_supported`).
"""

from __future__ import annotations

import torch

from metta_tpu_torch.engine.compiler import ACT_CHANGE_VIBE, ACT_MOVE, ACT_NOOP
from metta_tpu_torch.engine.inventory import trunc_div
from metta_tpu_torch.engine.inventory_vec import row_limits
from metta_tpu_torch.engine.protocols import (
    NEIGHBOR_OFFS,
    neighbors,
    select_protocol,
    select_unclip_protocol,
    sorted_vibe_key,
)
from metta_tpu_torch.engine.clipper import clipper_active, clipper_draws, clipper_step
from metta_tpu_torch.engine.rewards import apply_regen, compute_stat_rewards
from metta_tpu_torch.engine.scan import cumsum_last
from metta_tpu_torch.engine.state import KIND_ASSEMBLER, KIND_CHEST

_I32 = torch.int32


def unsupported(tables, step_mode: str = "batched"):
    """Names of the JAX subsystems this config needs that the port's step of
    ``step_mode`` ("batched" or "sequential") lacks."""
    seq = step_mode == "sequential"
    gates = [
        (not seq and not tables.inv_vector_ok,
         "shared inventory limit groups in the batched step (metta_tpu/engine/"
         "step_batched.py; the env takes step_mode='sequential' for them)"),
        (tables.chest_search_distance > 0,
         "assembler chest search (metta_tpu/engine/assembler.py:103-130)"),
        (tables.has_bump_handlers,
         "bump handlers (metta_tpu/engine/activation_wiring.py:"
         + ("bump_handlers_seq)" if seq else "bump_handlers_batched)")),
        (tables.has_damage, "damage (metta_tpu/engine/rewards.py:apply_damage)"),
        (tables.has_aoe, "AOE (metta_tpu/engine/activation_wiring.py:apply_aoe)"),
    ]
    return [name for on, name in gates if on]


def check_supported(tables, step_mode: str = "batched"):
    missing = unsupported(tables, step_mode)
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def _clip(x, lims):
    """clip(x, 0, lims) cast back to int32."""
    return torch.minimum(x.clamp(min=0), lims).to(_I32)


def _track_agent_inv(state, tables, old_inv):
    """Accumulate gained/lost from the net inventory change since ``old_inv``
    (per-phase net, as in the JAX batched step)."""
    if not tables.track_gained:
        return state
    d = state.agent_inv - old_inv
    return state.replace(
        agent_gained=state.agent_gained + d.clamp(min=0),
        agent_lost=state.agent_lost + (-d).clamp(min=0),
    )


def random_perm(E: int, A: int, generator=None, device="cpu"):
    """[E, A] independent random agent orders."""
    keys = torch.rand((E, A), generator=generator, device=device)
    return keys.argsort(dim=1)


def agent_grid_from_positions(tables, agent_r, agent_c):
    """[E, H, W] occupancy grid (agent idx + 1, 0 empty) from positions."""
    E, A = agent_r.shape
    H, W = tables.height, tables.width
    grid = torch.zeros((E, H * W), dtype=_I32, device=agent_r.device)
    ids = torch.arange(1, A + 1, dtype=_I32, device=agent_r.device).expand(E, A)
    grid.scatter_(1, (agent_r.long() * W + agent_c.long()), ids)
    return grid.reshape(E, H, W)


def world_systems(state, tables, generator=None, clip_draws=None):
    """Inventory regen, then the clipper with ``clip_draws`` (else drawn from
    ``generator``): what both steps run after the agents' actions
    (``metta_tpu/engine/step.py:184-193``, ``step_batched.py:448-457``)."""
    if tables.has_regen:
        state = apply_regen(state, tables)
    if clipper_active(tables):
        if clip_draws is None:
            clip_draws = clipper_draws(tables, state.step.shape[0], generator,
                                       state.step.device)
        state = clipper_step(state, tables, clip_draws)
    return state


def rank_from_perm(perm, E: int, A: int, generator=None, device="cpu"):
    """[E, A] int32 rank of each agent in the step's order (rank[a] =
    position of a in ``perm``); ``perm`` None draws one from ``generator``."""
    if perm is None:
        perm = random_perm(E, A, generator, device)
    perm = perm.to(device=device, dtype=torch.int64)
    ar = torch.arange(A, dtype=_I32, device=device).expand(E, A)
    return torch.empty((E, A), dtype=_I32, device=device).scatter_(1, perm, ar)


def batched_step(state, actions, tables, span, perm=None, generator=None, clip_draws=None):
    """One batched-arbitration step with the interaction span ``span``
    (:func:`interaction_span` or the fused kernel's wrapper): step + 1 and
    zero the reward, draw the rank, run the span, then the tail (motion
    stats, regen and the clipper, stat rewards, episode end). ``perm`` and
    ``clip_draws`` override the order's and the clipper's draws from
    ``generator``. Returns (new_state, rewards_at_obs)."""
    check_supported(tables)
    dev = actions.device
    E, A = actions.shape
    prev = state
    state = state.replace(
        step=state.step + 1,
        reward=torch.zeros_like(state.reward),
    )
    rank = rank_from_perm(perm, E, A, generator, dev)
    state, success, executed = span(state, actions, rank, tables)

    # ---------- motion stats ----------
    act_ok = (actions >= 0) & (actions < tables.n_actions)
    ran = act_ok & (prev.agent_frozen == 0)
    moved_any = (state.agent_r != state.agent_prev_r) | (state.agent_c != state.agent_prev_c)
    swm = torch.where(moved_any, torch.zeros_like(state.agent_steps_without_motion),
                      state.agent_steps_without_motion + 1)
    state = state.replace(
        agent_steps_without_motion=torch.where(ran, swm, state.agent_steps_without_motion),
        agent_prev_r=torch.where(ran, state.agent_r, state.agent_prev_r),
        agent_prev_c=torch.where(ran, state.agent_c, state.agent_prev_c),
        action_success=success,
        executed_action=executed,
    )
    state = world_systems(state, tables, generator, clip_draws)

    rewards_at_obs = state.reward
    state = compute_stat_rewards(state, tables)
    state = state.replace(episode_reward=state.episode_reward + state.reward)

    if tables.max_steps > 0:
        ended = state.step >= tables.max_steps
        if tables.episode_truncates:
            state = state.replace(truncated=ended)
        else:
            state = state.replace(done=ended)
    return state, rewards_at_obs


def step_env_batched(state, actions, tables, perm=None, generator=None, clip_draws=None):
    """One batched-arbitration step of every env.

    ``actions`` [E, A] int; ``perm`` [E, A] overrides the random agent order
    and ``clip_draws`` the clipper's draws (``clipper.ClipDraws``).
    Returns (new_state, rewards_at_obs [E, A]): the render is left to the
    caller (``render="defer"`` in the JAX step), and observations see the
    action-phase rewards, not the stat rewards (mettagrid_c.cpp:653 obs
    before :656 stat rewards).
    """
    return batched_step(state, actions, tables, interaction_span, perm, generator, clip_draws)


def interaction_span(state, actions, rank, tables):
    """The interaction span of one batched step, decode to action
    consumption, in torch ops: the plain version of the fused kernel
    (``ops/sim_fused.py``).

    ``state`` has the step already counted; ``actions`` [E, A] int; ``rank``
    [E, A] int32 (see :func:`rank_from_perm`). Returns (state, success [E, A]
    bool, executed_action [E, A] int32). The returned state carries the new
    agent positions, vibes, freezes, inventories (and gained/lost), the
    claimed assemblers' fields, and ``agent_grid`` rebuilt from the new
    positions; every other field passes through.
    """
    dev = actions.device
    E, A = actions.shape
    H, W = tables.height, tables.width
    NACT = tables.n_actions

    # ---------- decode ----------
    act_ok = (actions >= 0) & (actions < NACT)
    act = actions.long().clamp(0, NACT - 1)
    kind = tables.take("action_kind", act)
    arg = tables.take("action_arg", act)
    frozen = state.agent_frozen
    is_frozen = frozen != 0
    state = state.replace(agent_frozen=torch.where(
        act_ok & is_frozen & (frozen > 0), frozen - 1, frozen
    ))
    has_required = (state.agent_inv >= tables.take("action_required", act)).all(-1)
    attempt = act_ok & ~is_frozen & has_required
    success = attempt & (kind == ACT_NOOP)

    # ---------- change_vibe (conflict-free) ----------
    cv = attempt & (kind == ACT_CHANGE_VIBE)
    state = state.replace(agent_vibe=torch.where(cv, arg, state.agent_vibe))
    success = success | cv

    # ---------- movement proposals ----------
    movers = attempt & (kind == ACT_MOVE)
    delta = tables.take("move_deltas", arg.long().clamp(0, 7))  # [E, A, 2]
    r0, c0 = state.agent_r, state.agent_c
    r1 = r0 + delta[..., 0]
    c1 = c0 + delta[..., 1]
    in_b = (r1 >= 0) & (r1 < H) & (c1 >= 0) & (c1 < W)
    movers = movers & in_b
    rs, cs = r1.clamp(0, H - 1), c1.clamp(0, W - 1)
    flat = rs.long() * W + cs.long()                     # [E, A]
    skind = state.static_kind.reshape(E, -1).gather(1, flat)
    skind = torch.where(movers, skind, torch.zeros_like(skind))
    sidx = state.static_idx.reshape(E, -1).gather(1, flat)

    # pre-step occupant of the target cell (agent_grid matches the pre-step
    # positions: it is rebuilt from them at the end of every step)
    occ0 = state.agent_grid.reshape(E, -1).gather(1, flat)
    has_tgt_agent = movers & (occ0 > 0)
    tgt_agent = torch.where(has_tgt_agent, occ0 - 1, torch.zeros_like(occ0)).long()

    vibe = state.agent_vibe.clamp(0, tables.num_vibes - 1).long()
    lims = tables.agent_lims                             # [A, R], or [E, A, R] per env
    big = A + 1

    def from_targets(x):
        """x[target] per actor, 0 for actors without a target agent."""
        if x.dim() == 2:
            g = x.gather(1, tgt_agent)
            return torch.where(has_tgt_agent, g, torch.zeros_like(g))
        g = x.gather(1, tgt_agent[..., None].expand(-1, -1, x.shape[2]))
        return torch.where(has_tgt_agent[..., None], g, torch.zeros_like(g))

    def sum_to_targets(vals, mask):
        """Sum over actors with mask (and a target) of vals into the target."""
        m = mask & has_tgt_agent
        if vals.dim() == 2:
            v = torch.where(m, vals, torch.zeros_like(vals))
            return torch.zeros_like(v).scatter_add_(1, tgt_agent, v)
        v = torch.where(m[..., None], vals, torch.zeros_like(vals))
        idx = tgt_agent[..., None].expand(-1, -1, v.shape[2])
        return torch.zeros_like(v).scatter_add_(1, idx, v)

    def lowest_rank_per(cands, key, n_keys):
        """cands [E, A] bool; keep the lowest-rank candidate per key value."""
        score = torch.where(cands, rank, torch.full_like(rank, big))
        best = torch.full((E, n_keys), big, dtype=rank.dtype, device=dev)
        best = best.scatter_reduce(1, key, score, reduce="amin")
        return cands & (score == best.gather(1, key))

    def winner_per_target(cands):
        return lowest_rank_per(cands, tgt_agent, A)

    # ---------- vibe-triggered attacks ----------
    if tables.has_attack:
        wants_attack = movers & tables.take("attack_vibe_mask", vibe) & has_tgt_agent
        afford = (state.agent_inv >= tables.bcast("attack_consumed", 3)).all(-1)
        valid = wants_attack & (from_targets(state.agent_frozen) <= 0) & afford
        valid = winner_per_target(valid)

        weapon = (state.agent_inv * tables.bcast("attack_weapon_w", 3)).sum(-1)  # [E, A]
        t_vibe = from_targets(vibe)
        vibing = tables.take("vibe_matches_resource", t_vibe)          # [E, A, R]
        vibe_bonus = tables.take("attack_vibe_bonus", t_vibe)
        inv_t = from_targets(state.agent_inv)                            # [E, A, R]
        armor_amounts = inv_t + torch.where(
            vibing, vibe_bonus[..., None], torch.zeros_like(inv_t)
        )
        armor = (armor_amounts * tables.bcast("attack_armor_w", 3)).sum(-1)
        bonus = (weapon - armor).clamp(min=0)

        if tables.attack_defense_any:
            required = tables.bcast("attack_defense", 3) + bonus[..., None]  # [E, A, R]
            defense_mask = tables.bcast("attack_defense_mask", 3)
            can_defend = (~defense_mask | (inv_t >= required)).all(-1)
            blocked = valid & can_defend
            pay = torch.where(defense_mask, -required,
                              torch.zeros_like(required))
            d_target = sum_to_targets(pay, blocked)
            old_inv = state.agent_inv
            new_inv = _clip(old_inv + d_target, lims)
            state = state.replace(agent_inv=new_inv)
            if tables.track_gained:
                state = state.replace(
                    agent_lost=state.agent_lost + (old_inv - new_inv).clamp(min=0)
                )
        else:
            blocked = torch.zeros_like(valid)

        hit = valid & ~blocked
        if tables.attack_freeze > 0:
            state = state.replace(agent_frozen=(
                state.agent_frozen + sum_to_targets(
                    torch.full_like(state.agent_frozen, tables.attack_freeze), hit
                )
            ).to(_I32))
        # actor/target deltas + loot + consume, one combined clamp
        zero_r = torch.zeros_like(state.agent_inv)
        d = torch.where(hit[..., None], tables.bcast("attack_actor_delta", 3), zero_r)
        d = d + sum_to_targets(
            tables.bcast("attack_target_delta", 3).expand_as(state.agent_inv), hit
        )
        inv_t_now = from_targets(state.agent_inv)
        for r_loot in tables.loot_ids:
            amount = inv_t_now[..., r_loot]
            space = (lims[..., r_loot] - state.agent_inv[..., r_loot]).clamp(min=0)
            stolen = torch.where(hit, torch.minimum(amount, space),
                                 torch.zeros_like(amount))
            d[..., r_loot] += stolen - sum_to_targets(stolen, hit)
        d = d - torch.where(valid[..., None], tables.bcast("attack_consumed", 3), zero_r)
        old_inv = state.agent_inv
        state = state.replace(agent_inv=_clip(old_inv + d, lims))
        state = _track_agent_inv(state, tables, old_inv)
        success = success | valid
        # only resolved attacks handle the move; a failed try_attack falls
        # through to transfer/swap/onUse (move.hpp:103-139)
        handled_attack = valid
    else:
        handled_attack = torch.zeros_like(movers)

    # ---------- vibe-triggered transfers ----------
    if tables.has_transfer:
        wants_tr = (movers & ~handled_attack & tables.take("transfer_vibe_mask", vibe)
                    & has_tgt_agent)
        d_actor = tables.take("transfer_actor_delta", vibe)            # [E, A, R]
        d_target = tables.take("transfer_target_delta", vibe)
        req_ok = (state.agent_inv >= tables.bcast("transfer_required", 3)).all(-1)
        valid = wants_tr & (from_targets(state.agent_frozen) <= 0) & req_ok
        valid = winner_per_target(valid)
        free_a = (lims - state.agent_inv).clamp(min=0)
        free_t = from_targets(free_a)
        inv_t = from_targets(state.agent_inv)
        ok = valid
        ok = ok & ((d_actor >= 0) | (state.agent_inv >= -d_actor)).all(-1)
        ok = ok & ((d_target >= 0) | (inv_t >= -d_target)).all(-1)
        ok = ok & ((d_actor <= 0) | (d_actor <= free_a)).all(-1)
        ok = ok & ((d_target <= 0) | (d_target <= free_t)).all(-1)
        d = torch.where(ok[..., None], d_actor, torch.zeros_like(d_actor))
        d = d + sum_to_targets(d_target, ok)
        old_inv = state.agent_inv
        state = state.replace(agent_inv=_clip(old_inv + d, lims))
        state = _track_agent_inv(state, tables, old_inv)
        success = success | ok
        # a failed try_transfer falls through like a failed try_attack
        handled_tr = ok
    else:
        handled_tr = torch.zeros_like(movers)

    # ---------- swaps with frozen agents ----------
    handled_station = torch.zeros_like(movers)
    if tables.has_swap:
        wants_swap = (
            movers & ~handled_attack & ~handled_tr & has_tgt_agent
            & (from_targets(state.agent_frozen) > 0)
        )
        swap_ok = winner_per_target(wants_swap)
        # positions exchange (disjoint pairs: each winner targets a distinct
        # frozen agent; a frozen agent never moves itself this step)
        swapped_in = sum_to_targets(swap_ok.to(_I32), swap_ok) > 0      # [E, A]
        new_r = torch.where(swap_ok, from_targets(state.agent_r), state.agent_r)
        new_c = torch.where(swap_ok, from_targets(state.agent_c), state.agent_c)
        new_r = torch.where(swapped_in, sum_to_targets(r0, swap_ok), new_r)
        new_c = torch.where(swapped_in, sum_to_targets(c0, swap_ok), new_c)
        state = state.replace(agent_r=new_r.to(_I32), agent_c=new_c.to(_I32))
        success = success | swap_ok
        handled_station = handled_station | wants_swap

    interacted = handled_attack | handled_tr | handled_station

    # ---------- plain moves: rank-arbitrated rounds ----------
    # (movers whose pre-step target held an agent take part too: the rounds
    # let them follow an earlier-rank agent out of the cell, as sequentially)
    plain = movers & ~interacted & (skind == 0)
    unresolved = plain
    moved = torch.zeros_like(plain)
    not_self = ~torch.eye(A, dtype=torch.bool, device=dev)
    later = rank[:, None, :] > rank[:, :, None]                          # [E, A, A]
    cell = flat
    for _round in range(4):
        occ = ((r1[:, :, None] == state.agent_r[:, None, :])
               & (c1[:, :, None] == state.agent_c[:, None, :]) & not_self)
        occ_any = occ.any(-1)
        # fail if blocked by a later-rank agent or by one that already resolved
        blocker_later = (occ & later).any(-1)
        blocker_stuck = (occ & ~unresolved[:, None, :] & ~moved[:, None, :]).any(-1)
        unresolved = unresolved & ~(blocker_later | blocker_stuck)
        # contention: lowest rank per target cell among unresolved movers
        wins = lowest_rank_per(unresolved, cell, H * W) & ~occ_any
        state = state.replace(
            agent_r=torch.where(wins, r1, state.agent_r),
            agent_c=torch.where(wins, c1, state.agent_c),
        )
        moved = moved | wins
        unresolved = unresolved & ~wins
    success = success | moved

    # positions are final from here on: one occupancy grid serves the
    # station neighbourhoods and the next step
    grid = agent_grid_from_positions(tables, state.agent_r, state.agent_c)
    state = state.replace(agent_grid=grid)

    # ---------- station bumps: winner per station (assemblers, then chests) ----------
    if tables.has_assemblers:
        bump_asm = movers & ~interacted & (skind == KIND_ASSEMBLER)
        is_winner = lowest_rank_per(
            bump_asm, sidx.long().clamp(0, tables.n_assembler_slots - 1),
            tables.n_assembler_slots,
        )
        state, asm_success = _assembler_phase(state, tables, is_winner, sidx, lims)
        success = success | asm_success
    if tables.has_chests:
        bump_chest = movers & ~interacted & (skind == KIND_CHEST)
        is_winner = lowest_rank_per(
            bump_chest, sidx.long().clamp(0, tables.n_chest_slots - 1), tables.n_chest_slots)
        state, chest_success = _chest_phase(state, tables, is_winner, sidx, lims)
        success = success | chest_success

    # ---------- action resource consumption ----------
    if tables.any_action_consumed:
        consumed = torch.where(success[..., None], tables.take("action_consumed", act),
                               torch.zeros_like(state.agent_inv))
        old_inv = state.agent_inv
        state = state.replace(agent_inv=_clip(old_inv - consumed, lims))
        state = _track_agent_inv(state, tables, old_inv)
    executed = torch.where(success, act, torch.zeros_like(act)).to(_I32)
    return state, success, executed


# ---------------------------------------------------------------------------
# stations
# ---------------------------------------------------------------------------


def _local_shared_consume(rows, lims, valid, delta, passes: int = 3):
    """shared_update on local copies: distribute delta [..., R] (+/-) over
    the 8 rows [..., 8, R] of each station. Returns per-row deltas."""
    applied = torch.zeros_like(rows)
    active = valid[..., None] & (delta != 0)[..., None, :]
    delta_rem = delta
    n_rem = active.sum(-2)
    cur = rows
    free = (lims - rows).clamp(min=0)
    zero = torch.zeros_like(rows)
    for _ in range(passes):
        per = torch.where(n_rem > 0, trunc_div(delta_rem, n_rem.clamp(min=1)),
                          torch.zeros_like(delta_rem))[..., None, :]
        kick = active & torch.where(delta_rem[..., None, :] > 0,
                                    (free - applied) <= per,
                                    (cur + applied) <= -per)
        take = torch.where(kick, per, zero)
        take = torch.minimum(torch.maximum(take, -(cur + applied)), free - applied)
        applied = applied + take
        delta_rem = delta_rem - take.sum(-2)
        n_rem = n_rem - kick.sum(-2)
        active = active & ~kick
    # final distribution: base + sign-surplus to the earliest actives
    rank_l = active.long().cumsum(-2) - 1
    base = torch.where(n_rem > 0, trunc_div(delta_rem, n_rem.clamp(min=1)),
                       torch.zeros_like(delta_rem))
    surplus = delta_rem - base * n_rem
    extra = torch.where(rank_l < surplus.abs()[..., None, :],
                        surplus.sign()[..., None, :], torch.zeros_like(rank_l))
    final = torch.where(active, base[..., None, :] + extra, torch.zeros_like(extra))
    final = torch.minimum(torch.maximum(final, -(cur + applied)),
                          (lims - rows).clamp(min=0) - applied)
    return applied + final


def _assembler_phase(state, tables, is_winner, sidx, lims):
    """Every claimed assembler fires at once.

    A station is claimed by at most one winner and a winner claims exactly
    one station, so the claimed stations are indexed by their claimant:
    row ``a`` of every [E, A, ...] tensor below is the station agent ``a``
    won (meaningful where ``is_winner[a]``).
    """
    E, A, R = state.agent_inv.shape
    dev = sidx.device
    NA = tables.n_assembler_slots
    NP = tables.n_protocols
    NUP = tables.n_unclip_protocols
    V = tables.num_vibes
    st = sidx.long().clamp(0, NA - 1)                                   # [E, A]

    def at_station(x):
        return x.gather(1, st)

    s_type = at_station(state.asm_type).long()
    s_r, s_c = at_station(state.asm_r), at_station(state.asm_c)
    uses = at_station(state.asm_uses)
    cd_end = at_station(state.asm_cooldown_end)
    cd_dur = at_station(state.asm_cooldown_duration)
    clipped = at_station(state.asm_clipped)
    uproto = at_station(state.asm_unclip_proto)
    do = is_winner & at_station(state.asm_valid)

    max_uses = tables.take("type_max_uses", s_type)
    allow_partial = tables.take("type_allow_partial", s_type)
    ok = do & ((max_uses == 0) | (uses < max_uses))
    remaining = (cd_end - state.step[:, None]).clamp(min=0)
    ok = ok & ((remaining == 0) | allow_partial)

    inb, nb_is_agent, nb_idx, vibes = neighbors(
        tables, state.agent_grid, state.agent_vibe, s_r, s_c
    )                                                                   # [E, A, 8]
    key_vec = sorted_vibe_key(vibes, V)
    n_agents = nb_is_agent.sum(-1)

    p_norm = select_protocol(tables, s_type, key_vec, n_agents)
    p_un = select_unclip_protocol(tables, uproto, key_vec, n_agents)
    p_idx = torch.where(clipped, p_un, p_norm)
    ok = ok & (p_idx >= 0)
    pn = p_idx.clamp(0, NP - 1)
    pu = p_idx.clamp(0, NUP - 1)

    def pick(name):
        n, u = tables.take("proto_" + name, pn), tables.take("uproto_" + name, pu)
        c = clipped.reshape(clipped.shape + (1,) * (n.dim() - clipped.dim()))
        return torch.where(c, u, n)

    inputs = pick("in")                                                 # [E, A, R]
    outputs = pick("out")
    cooldown = pick("cooldown")                                         # [E, A]
    nvibes = pick("nvibes")
    vibe_counts = pick("vibe_counts")                                   # [E, A, V]
    orig_has_output = (outputs > 0).any(-1)

    if tables.any_allow_partial:
        duration = cd_dur.clamp(min=1)[..., None]
        elapsed = (cd_dur - remaining)[..., None]
        do_scale = (remaining > 0) & allow_partial
        ds = do_scale[..., None]
        inputs = torch.where(
            ds, torch.div(inputs * elapsed + duration - 1, duration, rounding_mode="floor"),
            inputs)
        outputs = torch.where(
            ds, torch.div(outputs * elapsed, duration, rounding_mode="floor"), outputs)
        wasteful = do_scale & ~(outputs > 0).any(-1) & orig_has_output & ~clipped
        ok = ok & ~wasteful

    # neighbour order: agents by rotation index from the actor's slot, then
    # non-agents, both stable in slot order
    offs = torch.tensor(NEIGHBOR_OFFS, dtype=torch.int32, device=dev)
    rank_inb = cumsum_last(inb) - 1
    n_inb = inb.sum(-1, keepdim=True)
    is_actor_slot = ((offs[:, 0] == (state.agent_r - s_r)[..., None])
                     & (offs[:, 1] == (state.agent_c - s_c)[..., None]))
    start_rank = torch.where(is_actor_slot, rank_inb, torch.zeros_like(rank_inb)).sum(
        -1, keepdim=True)
    rot = torch.remainder(rank_inb - start_rank, n_inb.clamp(min=1))
    order_key = torch.where(nb_is_agent, rot,
                            1000 + torch.arange(8, device=dev).expand_as(rot))
    # position of slot j = #slots with a smaller key + #earlier slots with
    # an equal key (a stable sort by counting); slots move to their position
    slots = torch.arange(8, device=dev)
    before_j = (order_key[..., None, :] < order_key[..., :, None]) | (
        (order_key[..., None, :] == order_key[..., :, None]) & (slots < slots[:, None])
    )
    pos = before_j.sum(-1)                                              # [E, A, 8]

    def to_positions(x):
        return torch.empty_like(x).scatter_(-1, pos, x)

    ref_idx = to_positions(nb_idx)
    ref_valid = to_positions(nb_is_agent)
    v8 = to_positions(vibes)

    # output selection: occurrence index of each slot's vibe among earlier slots
    v8c = v8.clamp(0, V - 1).long()
    before = torch.ones(8, 8, dtype=torch.bool, device=dev).tril(-1)    # [p, q]: q < p
    occ_idx = ((v8c[..., :, None] == v8c[..., None, :]) & before).sum(-1)
    count_v = vibe_counts.gather(-1, v8c)
    sel = ref_valid & (v8 != 0) & (occ_idx < count_v)
    use_multi = (nvibes > 1) & sel.any(-1)
    out_valid = torch.where(use_multi[..., None], sel,
                            torch.arange(8, device=dev) == 0)
    actor = torch.arange(A, device=dev).expand(E, A)
    out_idx = torch.where(use_multi[..., None], ref_idx, actor[..., None])

    def rows_of(idx, valid, table):
        """table [E, A, R] rows at agent idx [E, A, 8]; invalid slots 0."""
        g = table.gather(1, idx.reshape(E, -1, 1).expand(-1, -1, R)).reshape(E, A, 8, R)
        return torch.where(valid[..., None], g, torch.zeros_like(g))

    lims_b = lims.expand(E, A, R)
    rows = rows_of(ref_idx, ref_valid, state.agent_inv)
    lim_rows = rows_of(ref_idx, ref_valid, lims_b)
    out_rows = rows_of(out_idx, out_valid, state.agent_inv)
    out_lims = rows_of(out_idx, out_valid, lims_b)

    totals = torch.where(ref_valid[..., None], rows, torch.zeros_like(rows)).sum(-2)
    ok = ok & ((inputs == 0) | (totals >= inputs)).all(-1)
    total_free = torch.where(out_valid[..., None], (out_lims - out_rows).clamp(min=0),
                             torch.zeros_like(out_rows)).sum(-2)
    has_output = (outputs > 0).any(-1)
    can_absorb = ((outputs > 0) & (total_free >= 1)).any(-1)
    ok = ok & (~has_output | can_absorb | clipped)

    zero_r = torch.zeros_like(inputs)
    in_d = _local_shared_consume(rows, lim_rows, ref_valid,
                                 torch.where(ok[..., None], -inputs, zero_r))
    out_d = _local_shared_consume(out_rows, out_lims, out_valid,
                                  torch.where(ok[..., None], outputs, zero_r))

    # write every delta back to its agent (sum, then one clamp)
    def scatter_rows(idx, valid, deltas):
        v = torch.where(valid[..., None], deltas, torch.zeros_like(deltas))
        out = torch.zeros((E, A, R), dtype=v.dtype, device=dev)
        return out.scatter_add_(1, idx.reshape(E, -1, 1).expand(-1, -1, R),
                                v.reshape(E, -1, R))

    d = scatter_rows(ref_idx, ref_valid, in_d) + scatter_rows(out_idx, out_valid, out_d)
    old_inv = state.agent_inv
    state = state.replace(agent_inv=_clip(old_inv + d, lims))
    state = _track_agent_inv(state, tables, old_inv)
    if tables.track_chest_stats:
        # assembler.<r>.created game stat
        created = out_d.clamp(min=0).sum(dim=(1, 2))
        state = state.replace(game_asm_created=(state.game_asm_created + created).to(_I32))

    # per-station results back to the NA axis; rows of non-winners write to
    # a spare column NA that is dropped
    dest = torch.where(is_winner, st, torch.full_like(st, NA))

    def to_stations(v, fill):
        out = torch.full((E, NA + 1), fill, dtype=v.dtype, device=dev)
        return out.scatter_(1, dest, v)[:, :NA]

    ok_na = to_stations(ok, False)
    cooldown_na = to_stations(cooldown.to(_I32), 0)
    unclip_now = ok_na & state.asm_clipped
    state = state.replace(
        asm_cooldown_duration=torch.where(ok_na, cooldown_na, state.asm_cooldown_duration),
        asm_cooldown_end=torch.where(ok_na, state.step[:, None] + cooldown_na,
                                     state.asm_cooldown_end),
        asm_uses=state.asm_uses + (ok_na & ~state.asm_clipped).to(_I32),
        asm_clipped=state.asm_clipped & ~unclip_now,
        asm_unclip_proto=torch.where(unclip_now, -1, state.asm_unclip_proto),
    )
    return state, ok


def _chest_phase(state, tables, is_winner, sidx, lims):
    """Every claimed chest processes its winner's vibe transfer at once
    (``metta_tpu/engine/step_batched.py:857``): deposits capped by the
    agent's inventory and the chest's free space, withdrawals by the
    chest's contents and the agent's free space; the agent loses what it
    offers (the untransferred rest is destroyed). A chest is claimed by at
    most one winner. Returns (state, success [E, A])."""
    E, A, R = state.agent_inv.shape
    dev = sidx.device
    NC, V = tables.n_chest_slots, tables.num_vibes
    NTC = tables.chest_type_inv_class.shape[0]
    in_range = (sidx >= 0) & (sidx < NC)
    ch = sidx.long().clamp(0, NC - 1)
    # the claimant of each chest (-1: unclaimed); a spare column NC is dropped
    dest = torch.where(is_winner & in_range, ch, NC)
    claim = torch.full((E, NC + 1), -1, dtype=torch.long, device=dev).scatter_(
        1, dest, torch.arange(A, device=dev).expand(E, A))[:, :NC]
    claimed = claim >= 0
    ca = claim.clamp(min=0)

    def of_claimant(x):
        """Rows of x [E, A, R] (or [A, R]) at each chest's claimant, 0 unclaimed."""
        g = x.expand(E, A, R).gather(1, ca[..., None].expand(E, NC, R))
        return torch.where(claimed[..., None], g, torch.zeros_like(g))

    a_vibe = torch.where(claimed, state.agent_vibe.gather(1, ca), 0)
    a_inv, a_lim = of_claimant(state.agent_inv), of_claimant(lims)
    t = state.chest_type.long()
    t_ok = (t >= 0) & (t < NTC)
    tc, vc = t.clamp(0, NTC - 1), a_vibe.long().clamp(0, V - 1)
    has = t_ok & tables.chest_vibe_has[tc, vc]                              # [E, NC]
    deltas = torch.where(t_ok[..., None], tables.chest_vibe_delta[tc, vc], 0)  # [E, NC, R]
    c_lim = row_limits(tables, torch.where(t_ok, tables.chest_type_inv_class[tc], 0))

    ok = claimed & state.chest_valid & has
    c_inv = state.chest_inv
    zero = torch.zeros_like(c_inv)
    give_dep = torch.where((deltas > 0) & ok[..., None], torch.minimum(a_inv, deltas), zero)
    got_dep = torch.minimum(give_dep, (c_lim - c_inv).clamp(min=0))
    give_w = torch.where((deltas < 0) & ok[..., None], torch.minimum(c_inv, -deltas), zero)
    got_w = torch.minimum(give_w, (a_lim - a_inv).clamp(min=0))
    ok_v = ok & ((got_dep > 0) | (got_w > 0)).any(-1)

    def to_agents(v):
        """Per-chest rows [E, NC, R] summed into their claimants [E, A, R]."""
        v = torch.where(claimed[..., None], v, torch.zeros_like(v))
        return torch.zeros_like(state.agent_inv).scatter_add_(
            1, ca[..., None].expand(E, NC, R), v.to(torch.int32))

    old_inv = state.agent_inv
    state = state.replace(
        agent_inv=_clip(old_inv + to_agents(got_w - give_dep), lims),
        chest_inv=(c_inv + got_dep - give_w).clamp(0, 65535).to(torch.int32),
    )
    state = _track_agent_inv(state, tables, old_inv)
    if tables.track_chest_stats:
        # chest.hpp:59-66: withdrawn counts the full offer (the chest loses
        # it), deposited only what the chest took
        state = state.replace(
            agent_chest_deposited=state.agent_chest_deposited + to_agents(got_dep.clamp(min=0)),
            game_chest_deposited=state.game_chest_deposited
            + got_dep.clamp(min=0).sum(1).to(torch.int32),
            game_chest_withdrawn=state.game_chest_withdrawn
            + give_w.clamp(min=0).sum(1).to(torch.int32),
        )
    return state, is_winner & in_range & ok_v.gather(1, ch)
