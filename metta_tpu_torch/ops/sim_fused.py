"""The fused interaction span (kernel K2): CUDA kernel, plain version, step.

Counterpart of ``metta_tpu/ops/sim_fused.py`` (the Pallas TPU kernel inside
``build_fused_kernel``, launched by ``call_fused`` and wrapped by
``fused_step_full``). One kernel resolves the interaction span of a batched
step, decode to action consumption, for every env at once, byte-identical to
the torch ops of ``engine/step_batched.py:interaction_span``.

- :func:`supports_fused` is the JAX package's config gate, without the
  TPU's 128-env block rule: the CUDA kernel takes any E.
  :func:`span_fits` is the kernel's own limits (agents, resources,
  protocols, shared memory, the instantiated sections), a pure predicate:
  the env takes the kernel only where both hold. :func:`check_sizes`
  raises, by name, exactly where :func:`span_fits` is false.
- :func:`fused_span` is the kernel's wrapper. A CUDA tensor launches the
  kernel in ``csrc/sim_fused.cu`` (or raises); a CPU tensor takes
  :func:`fused_span_plain`. :func:`span_schedule` and :func:`span_grid`
  are the kernel's persistent schedule as pure functions.
- :func:`fused_step_full` is the whole batched step around the span.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from metta_tpu_torch.engine.compiler import ACT_CHANGE_VIBE, ACT_MOVE, ACT_NOOP, INT16_MAX
from metta_tpu_torch.engine.state import KIND_ASSEMBLER, KIND_CHEST
from metta_tpu_torch.engine.step_batched import (
    agent_grid_from_positions,
    batched_step,
    interaction_span,
)
from metta_tpu_torch.ops.build import check_tensor

# Launches of the CUDA kernel, counted by the wrapper where it launches.
launches = 0

# The span's plain torch version: one copy, shared with step_env_batched.
fused_span_plain = interaction_span

# Tables the kernel reads, packed as int32 in this order (csrc/sim_fused.cu:Tab).
TABLES = (
    "action_kind", "action_arg", "action_required", "action_consumed", "move_deltas",
    "attack_vibe_mask", "attack_consumed", "attack_defense", "attack_defense_mask",
    "attack_armor_w", "attack_weapon_w", "attack_vibe_bonus", "vibe_matches_resource",
    "attack_actor_delta", "attack_target_delta",
    "transfer_vibe_mask", "transfer_required", "transfer_actor_delta", "transfer_target_delta",
    "type_max_uses",
    "proto_type", "proto_key", "proto_min_agents", "proto_in", "proto_out", "proto_cooldown",
    "proto_nvibes", "proto_vibe_counts", "proto_rank", "proto_valid",
    "uproto_key", "uproto_min_agents", "uproto_in", "uproto_out", "uproto_cooldown",
    "uproto_nvibes", "uproto_vibe_counts",
    "agent_lims", "loot_ids", "proto_res",
    "chest_vibe_delta", "chest_vibe_has", "chest_lims",
)
# The chest phase's tables, in the pack only where the config has chests.
CHEST_TABLES = ("chest_vibe_delta", "chest_vibe_has", "chest_lims")

# Kernel inputs (csrc/sim_fused.cu:In): (state field or argument, dtype, shape key).
_IN = (
    ("actions", torch.int32, "EA"), ("rank", torch.int32, "EA"),
    ("agent_r", torch.int32, "EA"), ("agent_c", torch.int32, "EA"),
    ("agent_vibe", torch.int32, "EA"), ("agent_frozen", torch.int32, "EA"),
    ("agent_inv", torch.int32, "EAR"), ("agent_gained", torch.int32, "EAR"),
    ("agent_lost", torch.int32, "EAR"), ("step", torch.int32, "E"),
    ("agent_grid", torch.int32, "EHW"), ("static_kind", torch.int32, "EHW"),
    ("static_idx", torch.int32, "EHW"),
    ("asm_r", torch.int32, "EN"), ("asm_c", torch.int32, "EN"),
    ("asm_type", torch.int32, "EN"), ("asm_uses", torch.int32, "EN"),
    ("asm_cooldown_end", torch.int32, "EN"), ("asm_cooldown_duration", torch.int32, "EN"),
    ("asm_clipped", torch.bool, "EN"), ("asm_unclip_proto", torch.int32, "EN"),
    ("asm_valid", torch.bool, "EN"),
    ("chest_inv", torch.int32, "ECR"), ("chest_type", torch.int32, "EC"),
    ("chest_valid", torch.bool, "EC"),
)

# Kernel outputs (csrc/sim_fused.cu:Out), allocated by the wrapper.
_OUT = (
    ("agent_r", torch.int32, "EA"), ("agent_c", torch.int32, "EA"),
    ("agent_vibe", torch.int32, "EA"), ("agent_frozen", torch.int32, "EA"),
    ("agent_inv", torch.int32, "EAR"), ("agent_gained", torch.int32, "EAR"),
    ("agent_lost", torch.int32, "EAR"),
    ("asm_cooldown_duration", torch.int32, "EN"), ("asm_cooldown_end", torch.int32, "EN"),
    ("asm_uses", torch.int32, "EN"), ("asm_clipped", torch.bool, "EN"),
    ("asm_unclip_proto", torch.int32, "EN"),
    ("success", torch.bool, "EA"), ("executed", torch.int32, "EA"),
    ("chest_inv", torch.int32, "ECR"),
)
# Inputs and outputs of the chest phase: null pointers without chests.
_CHEST_IO = ("chest_inv", "chest_type", "chest_valid")


class _Static(ctypes.Structure):
    """csrc/sim_fused.cu:Static, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "A", "R", "V", "H", "W", "NACT", "NA", "NP", "NUP", "n_loot", "n_pres",
        "has_attack", "has_transfer", "has_swap", "has_asm", "track_gained", "any_consumed",
        "defense_any", "attack_freeze",
        "act_noop", "act_move", "act_change_vibe", "kind_asm",
        "NC", "NT", "has_chest", "kind_chest",
    )] + [("off", ctypes.c_int * len(TABLES))]


def span_work(state, acts, t):
    """What K2 must do for these inputs: (bytes, operations, parts in bytes).

    Each input byte the span needs is read once and each output byte written
    once, in the kernel's layout: the agents' actions, ranks, positions,
    vibes, freezes and inventories (and gained/lost where tracked), the
    step, the three grid cells at each mover's target, every station's
    cooldowns, uses, clip state and unclip protocol (they pass through to the
    new tensors), and type, validity and position of each bumped station; the
    table pack. Out: positions, vibes, freezes, inventories (gained/lost),
    success (1 byte) and executed action per agent, the station fields.
    Operations: the pair terms, A*A compares each (winner per target for
    attack, transfer and swap, four move rounds of occupancy and cell
    winner, the station winner), and A*R per agent per inventory phase."""
    E, A = acts.shape
    R, NA, H, W = t.num_resources, t.n_assembler_slots, t.height, t.width
    a = acts.long().clamp(0, t.n_actions - 1)
    act_ok = (acts >= 0) & (acts < t.n_actions)
    has_req = (state.agent_inv >= t.action_required[a]).all(-1)
    d = t.move_deltas[t.action_arg[a].long().clamp(0, 7)]
    r1, c1 = state.agent_r + d[..., 0], state.agent_c + d[..., 1]
    movers = (act_ok & (state.agent_frozen == 0) & has_req & (t.action_kind[a] == ACT_MOVE)
              & (r1 >= 0) & (r1 < H) & (c1 >= 0) & (c1 < W))
    flat = (r1.clamp(0, H - 1) * W + c1.clamp(0, W - 1)).long()
    kind = state.static_kind.reshape(E, -1).gather(1, flat)
    sidx = state.static_idx.reshape(E, -1).gather(1, flat).long().clamp(0, NA - 1)
    bumped = torch.zeros((E, NA + 1), dtype=torch.bool, device=acts.device)
    bumped.scatter_(1, torch.where(movers & (kind == KIND_ASSEMBLER), sidx, NA), True)
    gl = 8 * E * A * R if t.track_gained else 0
    parts = {
        "agents in": 24 * E * A + 4 * E * A * R + gl + 4 * E,
        "target cells": 12 * int(movers.sum()),
        "stations in": 17 * E * NA + 13 * int(bumped[:, :NA].sum()),
        "tables": 4 * pack_ints(t),
        "agents out": 21 * E * A + 4 * E * A * R + gl,
        "stations out": 17 * E * NA,
    }
    if t.has_chests:
        # every chest's inventory passes through; each bumped chest's type
        # and validity are read
        NC = t.n_chest_slots
        chests = torch.zeros((E, NC + 1), dtype=torch.bool, device=acts.device)
        chests.scatter_(1, torch.where(movers & (kind == KIND_CHEST),
                                       sidx.clamp(0, NC - 1), NC), True)
        parts["chests in"] = 4 * E * NC * R + 5 * int(chests[:, :NC].sum())
        parts["chests out"] = 4 * E * NC * R
    pair_terms = 3 + 4 * 2 + 1 + t.has_chests
    ops = E * A * A * pair_terms + E * A * R * (5 + t.has_chests)
    return sum(parts.values()), ops, parts


def supports_fused(tables) -> bool:
    """Config gate of the fused span (``metta_tpu/ops/sim_fused.py:47-59``):
    singleton inventory limits, no bump handlers, no partial-usage
    assemblers, no chest-stat accounting, at most 32 agents (one warp)."""
    return bool(
        tables.inv_vector_ok
        and not tables.has_bump_handlers
        and not tables.any_allow_partial
        and not tables.track_chest_stats
        and tables.num_agents <= 32
    )


def _host(v):
    return (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.int32)


def chest_lims(tables):
    """[NT, R] per-chest-type limit rows (singleton groups), clipped to
    0..65535 (``metta_tpu/ops/sim_fused.py:92-96``)."""
    cls = _host(tables.chest_type_inv_class)
    base, group = _host(tables.inv_group_base)[cls], _host(tables.inv_res_group)[cls]
    return np.clip(np.take_along_axis(base, group, axis=1), 0, INT16_MAX).astype(np.int32)


def _pack_arrays(tables):
    """Every table of :data:`TABLES` as flat host int32, the chest tables
    empty where the config has no chests."""
    out = []
    for name in TABLES:
        if name in CHEST_TABLES and not tables.has_chests:
            x = np.zeros(0, np.int32)
        else:
            x = chest_lims(tables) if name == "chest_lims" else _host(getattr(tables, name))
        out.append(x.reshape(-1))
    return out


def pack_ints(tables) -> int:
    """Ints of the table pack (:func:`table_pack`), without building it."""
    return sum(x.size for x in _pack_arrays(tables)) + 1


def table_pack(tables, device):
    """(int32 tensor of every table in :data:`TABLES` order, offsets)."""
    parts = _pack_arrays(tables)
    offs = np.concatenate([[0], np.cumsum([x.size for x in parts])[:-1]]).tolist()
    pack = torch.as_tensor(np.concatenate(parts + [np.zeros(1, np.int32)]), device=device)
    return pack, offs


def _statics(tables, offs):
    st = _Static(
        tables.num_agents, tables.num_resources, tables.num_vibes, tables.height,
        tables.width, tables.n_actions, tables.n_assembler_slots,
        tables.n_protocols, tables.n_unclip_protocols,
        len(tables.loot_ids), len(tables.proto_res),
        tables.has_attack, tables.has_transfer, tables.has_swap, tables.has_assemblers,
        tables.track_gained, tables.any_action_consumed, tables.attack_defense_any,
        tables.attack_freeze, ACT_NOOP, ACT_MOVE, ACT_CHANGE_VIBE, KIND_ASSEMBLER,
        tables.n_chest_slots, int(tables.chest_vibe_delta.shape[0]), tables.has_chests,
        KIND_CHEST,
    )
    st.off[:] = offs
    return st


# Sizes the kernel takes (csrc/sim_fused.cu: kMaxA, kMaxR, kMaxNP, kMaxWarps):
# a lane per agent, resource loops unrolled to MAX_RESOURCES, a lane per
# protocol in the pick, blocks of at most kMaxWarps envs (one warp each).
MAX_AGENTS = 32
MAX_RESOURCES = 16
MAX_PROTOCOLS = 32
# Envs (warps) a block of the launch may hold; WARPS is the production width.
ENVS_PER_BLOCK = (1, 2, 4, 8)
WARPS = 8
SMEM_LIMIT = 232_448          # shared memory a block can use on an H100 (bytes)


def check_envs_per_block(el):
    """``el`` if the kernel takes it (None: the production launch), else
    ValueError."""
    if el is not None and el not in ENVS_PER_BLOCK:
        raise ValueError(f"the kernel takes {ENVS_PER_BLOCK} envs a block, not {el}")
    return el


def span_smem_bytes(n_tab: int, A: int, R: int, track: bool, warps: int) -> int:
    """Shared memory a block of ``warps`` envs needs (mirrors
    ``csrc/sim_fused.cu:block_ints``): the table pack of ``n_tab`` ints, the
    limits at an odd row stride, and each warp's rows, positions, ranks,
    sums and station slot arrays, every region rounded up to 4 ints."""
    def round4(n):
        return (n + 3) & ~3
    rs = R | 1
    warp = round4((4 if track else 2) * A * rs) + 2 * 32 + 32 + 3 * 32 + 3 * 8
    return 4 * (round4(n_tab) + round4(A * rs) + warps * warp)


def size_faults(tables, n_tab=None, warps: int = WARPS):
    """What of the config is beyond the kernel, each named: its maxima of
    agents, resources and protocols, the shared memory that the table pack
    of ``n_tab`` ints (default :func:`pack_ints`) and ``warps`` envs' rows
    need, and a section set it has no instantiation of (the chest section
    is built only beside the assembler section). Empty where it fits."""
    n_tab = pack_ints(tables) if n_tab is None else n_tab
    faults = [f"{name} = {value} is beyond the fused kernel's {most}"
              for name, value, most in (("num_agents", tables.num_agents, MAX_AGENTS),
                                        ("num_resources", tables.num_resources, MAX_RESOURCES),
                                        ("n_protocols", tables.n_protocols, MAX_PROTOCOLS))
              if value > most]
    smem = span_smem_bytes(n_tab, tables.num_agents, tables.num_resources,
                           tables.track_gained, warps)
    if smem > SMEM_LIMIT:
        faults.append(f"the table pack ({4 * n_tab} B) and {warps} warps' rows need "
                      f"{smem} B of shared memory, beyond a block's {SMEM_LIMIT}")
    if tables.has_chests and not tables.has_assemblers:
        faults.append("chests without assemblers: the kernel's chest section is "
                      "instantiated only beside its assembler section")
    return faults


def span_fits(tables, n_tab=None, warps: int = WARPS) -> bool:
    """Whether the kernel takes the config (:func:`size_faults` is empty)."""
    return not size_faults(tables, n_tab, warps)


def check_sizes(tables, n_tab=None, warps: int = WARPS):
    """Raise ValueError, naming each size, where :func:`span_fits` is false."""
    faults = size_faults(tables, n_tab, warps)
    if faults:
        raise ValueError("; ".join(faults))


def span_grid(E: int, warps: int, sms: int, per_sm: int) -> int:
    """Blocks the kernel launches: a warp an env, no more blocks than the
    card holds at once (``sms`` x ``per_sm``)."""
    return min(-(-E // warps), sms * per_sm)


def span_schedule(E: int, blocks: int, warps: int):
    """The envs each warp of a grid of ``blocks`` blocks takes, in order
    (mirrors ``csrc/sim_fused.cu:sim_fused_kernel``): warp w of the grid
    (block b, warp k: w = b x ``warps`` + k) takes envs w, w + nw, ... with
    nw = ``warps`` x ``blocks``."""
    nw = warps * blocks
    return [list(range(w, E, nw)) for w in range(nw)]


_lib = None


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("sim_fused")
        lib.sim_fused_launch.restype = ctypes.c_int
        lib.sim_fused_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Static),   # ins outs statics
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # tab n_tab E warps
            ctypes.c_void_p,                                             # stream
        ]
        lib.sim_fused_shape.restype = ctypes.c_int
        lib.sim_fused_shape.argtypes = [ctypes.POINTER(_Static), ctypes.c_int, ctypes.c_int,
                                        *[ctypes.POINTER(ctypes.c_int)] * 3]
        _lib = lib
    return _lib


def _pack_of(tables, dev):
    """The table pack and statics on ``dev``, cached on ``tables``. The flags
    that set the statics are in the key: a copy of the tables with other
    flags (``scripts/ablate_fused.py``) gets its own."""
    key = (str(dev), tables.track_gained, tables.has_attack, tables.has_transfer,
           tables.has_swap, tables.has_assemblers, tables.has_chests)
    cache = tables.__dict__.setdefault("_sim_fused_pack", {})
    if key not in cache:
        pack, offs = table_pack(tables, dev)
        if pack.data_ptr() % 16:
            raise ValueError("the table pack must be 16-byte aligned")   # the kernel's int4 loads
        cache[key] = (pack, _statics(tables, offs))
    return cache[key]


def launch_shape(tables, envs_per_block=None):
    """The kernel's launch shape for ``tables`` on the current card: {smem
    bytes a block, blocks an SM holds, SMs} (needs the card)."""
    warps = check_envs_per_block(envs_per_block) or WARPS
    pack, st = _pack_of(tables, torch.device("cuda", torch.cuda.current_device()))
    vals = [ctypes.c_int() for _ in range(3)]
    err = _library().sim_fused_shape(ctypes.byref(st), pack.numel(), warps,
                                     *[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"sim_fused_shape failed: CUDA error {err}")
    return dict(zip(("smem", "per_sm", "sms"), (v.value for v in vals)))


def launch_fused_span(state, actions, rank, tables, envs_per_block=None) -> dict:
    """Launch the CUDA kernel once on the current stream: {output name:
    tensor} in :data:`_OUT` order, the agent grid not rebuilt.

    ``actions`` and ``rank`` are int32 [E, A] and every state field the
    kernel reads has its engine dtype and shape, a contiguous layout and the
    actions' CUDA device; anything else raises, as do configs outside
    :func:`supports_fused` or beyond the kernel (:func:`check_sizes`), and a
    block width the kernel does not take. ``envs_per_block`` (None:
    :data:`WARPS`) sets the envs a block holds at once. The chest phase's
    inputs and output are passed only where the config has chests."""
    global launches
    warps = check_envs_per_block(envs_per_block) or WARPS
    if not supports_fused(tables):
        raise ValueError("config outside supports_fused: the fused span cannot run it")
    if tables.per_env:
        raise ValueError("the fused span reads one task's tables, not a task set's per-env view")
    dev = actions.device
    if dev.type != "cuda":
        raise ValueError(f"actions must be a CUDA tensor, got {dev}")
    pack, st = _pack_of(tables, dev)
    check_sizes(tables, pack.numel(), warps)
    E, A = actions.shape
    R, NC = tables.num_resources, tables.n_chest_slots
    shapes = {"E": (E,), "EA": (E, A), "EAR": (E, A, R),
              "EHW": (E, tables.height, tables.width), "EN": (E, tables.n_assembler_slots),
              "EC": (E, NC), "ECR": (E, NC, R)}
    args = {"actions": actions, "rank": rank}
    ins = []
    for name, dtype, shape in _IN:
        if name in _CHEST_IO and not tables.has_chests:
            ins.append(None)
            continue
        x = args[name] if name in args else getattr(state, name)
        check_tensor(name, x, dtype, shapes[shape], dev)
        ins.append(x)
    outs = [None if name in _CHEST_IO and not tables.has_chests
            else torch.empty(shapes[shape], dtype=dtype, device=dev)
            for name, dtype, shape in _OUT]
    if E > 0:
        def ptrs(xs):
            return (ctypes.c_void_p * len(xs))(*[0 if x is None else x.data_ptr() for x in xs])
        ptrs_in, ptrs_out = ptrs(ins), ptrs(outs)
        with torch.cuda.device(dev):
            err = _library().sim_fused_launch(
                ptrs_in, ptrs_out, ctypes.byref(st), pack.data_ptr(), pack.numel(), E, warps,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"sim_fused kernel launch failed: CUDA error {err}")
        launches += 1
    return {n: x for (n, _, _), x in zip(_OUT, outs) if x is not None}


def fused_span(state, actions, rank, tables, envs_per_block=None):
    """The interaction span (see :func:`fused_span_plain` for the contract):
    the CUDA kernel for CUDA tensors (:func:`launch_fused_span`, then the
    agent grid rebuilt from the new positions), the plain version for CPU
    tensors."""
    if actions.device.type == "cpu":
        return fused_span_plain(state, actions, rank, tables)
    new = launch_fused_span(state, actions, rank, tables, envs_per_block)
    success, executed = new.pop("success"), new.pop("executed")
    if not tables.track_gained:
        del new["agent_gained"], new["agent_lost"]
    state = state.replace(**new)
    state = state.replace(agent_grid=agent_grid_from_positions(
        tables, state.agent_r, state.agent_c))
    return state, success, executed


def span_mismatches(a, b):
    """Names of the outputs where two span results (state, success,
    executed) differ in dtype, shape or any byte."""
    (sa, *ra), (sb, *rb) = a, b
    pairs = [(f.name, getattr(sa, f.name), getattr(sb, f.name))
             for f in dataclasses.fields(sa)]
    pairs += [("success", ra[0], rb[0]), ("executed", ra[1], rb[1])]
    return [name for name, x, y in pairs
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y)]


def fused_step_full(state, actions, tables, perm=None, generator=None, clip_draws=None):
    """The batched step through the fused span (``metta_tpu/ops/sim_fused.py:
    fused_step_full``): step + 1, the rank from ``perm`` or ``generator``,
    :func:`fused_span`, then motion stats, regen and the clipper (its draws
    ``clip_draws`` or from ``generator``), stat rewards and episode end.
    Equal byte for byte to ``step_env_batched`` with the same draws.
    Returns (new_state, rewards_at_obs)."""
    return batched_step(state, actions.to(torch.int32), tables, fused_span, perm, generator,
                        clip_draws)
