"""Config → dense-array compiler, the port's own copy.

Copied from ``metta_tpu/engine/compiler.py`` (numpy only) so the port imports
nothing of the JAX package; tests hold the two outputs equal field by field.
It replaces the reference's Python→C++ conversion
(``mettagrid/config/mettagrid_c_config.py:30-577``): the pydantic
:class:`GameConfig` plus a built :class:`GameMap` are compiled into

1. a :class:`CompiledConfig` of numpy lookup tables (shared by every env
   instance; ``engine/tables.py`` moves them to the device), and
2. the raw per-env initial arrays (``init``) baked from the map.

All name→id mappings follow the reference exactly: resource ids are
positional in ``resource_names``; vibe ids positional in the change_vibe vibe
list; type ids are ``sorted(objects)`` 1-based with 0 reserved for agents; tag
ids are sorted tag names.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any

import numpy as np

from metta_tpu_torch.config.id_map import num_inventory_tokens_needed
from metta_tpu_torch.config.mettagrid_config import (
    ORIENTATION_DELTAS,
    ORIENTATION_NAMES,
    AgentConfig,
    AssemblerConfig,
    ChestConfig,
    GameConfig,
    InventoryConfig,
    ProtocolConfig,
    WallConfig,
)
from metta_tpu_torch.map_builder.map_builder import GameMap

logger = logging.getLogger(__name__)

INT16_MAX = 65535  # InventoryQuantity is uint16 in the reference (types.hpp)

# Action kinds in the flattened action table.
ACT_NOOP = 0
ACT_MOVE = 1
ACT_CHANGE_VIBE = 2

# Stat-reward sources (see engine/rewards.py). The compiler parses each
# stat-reward key into (source, resource index); unknown keys map to SRC_ZERO
# with a warning (reference supports arbitrary string stats — we compile the
# reward-relevant subset; full stats remain host-side, SURVEY §7.3 item 3).
SRC_ZERO = 0
SRC_INV_AMOUNT = 1           # <r>.amount
SRC_GAINED = 2               # <r>.gained
SRC_LOST = 3                 # <r>.lost
SRC_CHEST_AMOUNT = 4         # chest.<r>.amount (game stat; sum over chests)
SRC_CHEST_DEPOSITED = 5      # chest.<r>.deposited (game stat)
SRC_CHEST_WITHDRAWN = 6      # chest.<r>.withdrawn (game stat)
SRC_CHEST_DEPOSITED_BY_AGENT = 7  # chest.<r>.deposited_by_agent (agent stat)
SRC_ASM_CREATED = 8          # assembler.<r>.created (game stat)
SRC_ALIGNED = 9              # aligned.<type> (live collective member count)
SRC_COLL_DEPOSITED = 10      # collective.<r>.deposited (collective stat)
SRC_COLL_WITHDRAWN = 11      # collective.<r>.withdrawn (collective stat)
N_STAT_SOURCES = 12

TEAM_NAMES = {0: "red", 1: "blue", 2: "green", 3: "yellow", 4: "purple", 5: "orange"}


def _team_group_name(team_id: int) -> str:
    return TEAM_NAMES.get(team_id, f"team_{team_id}")


@dataclasses.dataclass(frozen=True)
class CompiledConfig:
    """Dense lookup tables compiled from a GameConfig (+ map geometry).

    numpy arrays here are host constants; ``engine/tables.py`` moves them to
    the device once.
    """

    # sizes (static Python ints → static shapes under jit)
    num_agents: int
    num_resources: int
    num_vibes: int
    height: int
    width: int
    n_actions: int
    n_assembler_slots: int   # NA (padded, ≥1)
    n_chest_slots: int       # NC (padded, ≥1)
    n_collectives: int       # NL (padded, ≥1)
    n_object_types: int      # NT (0 = agent)
    n_protocols: int         # P (padded, ≥1)
    n_unclip_protocols: int  # UP (padded, ≥1)
    n_stat_slots: int        # S: max stat-reward entries per agent
    max_tags: int
    obs_width: int
    obs_height: int
    num_obs_tokens: int
    token_value_base: int
    num_inv_tokens: int
    max_steps: int
    episode_truncates: bool
    inventory_regen_interval: int
    n_inventory_classes: int
    max_tokens_per_cell: int
    n_global_token_slots: int
    chest_search_distance: int  # max over assembler types (per-type in table)

    # --- names (host-side metadata, not used in the jitted step) ---
    resource_names: list
    vibe_names: list
    action_names: list
    object_type_names: list  # index 0 = "agent"
    group_names: list        # per team id present
    feature_ids: dict        # name -> id
    feature_normalizations: dict  # id -> normalization

    # --- actions ---
    action_kind: np.ndarray      # [n_actions] int32
    action_arg: np.ndarray       # [n_actions] int32
    action_required: np.ndarray  # [n_actions, R] int32
    action_consumed: np.ndarray  # [n_actions, R] int32
    move_deltas: np.ndarray      # [8, 2] int32 (dr, dc)

    # --- attack (attack.hpp) ---
    attack_vibe_mask: np.ndarray     # [V] bool — vibes that trigger attack on move
    attack_required: np.ndarray      # [R] int32
    attack_consumed: np.ndarray      # [R] int32
    attack_defense: np.ndarray       # [R] int32
    attack_defense_mask: np.ndarray  # [R] bool (items present in the config map)
    attack_defense_any: bool
    attack_armor_w: np.ndarray       # [R] int32
    attack_weapon_w: np.ndarray      # [R] int32
    attack_vibe_bonus: np.ndarray    # [V] int32
    vibe_matches_resource: np.ndarray  # [V, R] bool (vibe name == resource name)
    attack_actor_delta: np.ndarray   # [R] int32
    attack_target_delta: np.ndarray  # [R] int32
    attack_loot_ids: np.ndarray      # [n_loot] int32, config order (spillover order matters)
    attack_freeze: int

    # --- transfer (transfer.hpp) ---
    transfer_vibe_mask: np.ndarray    # [V] bool
    transfer_required: np.ndarray     # [R] int32
    transfer_actor_delta: np.ndarray  # [V, R] int32
    transfer_target_delta: np.ndarray  # [V, R] int32

    # --- inventory classes (inventory.hpp shared limits) ---
    inv_res_group: np.ndarray   # [C, R] int32: limit-group id of each resource
    inv_group_base: np.ndarray  # [C, R] int32: base limit per group id
    inv_group_mod: np.ndarray   # [C, R, R] int32: modifiers[g, m]
    inv_class_has_mods: np.ndarray  # [C] bool

    # --- per-agent tables ---
    agent_group: np.ndarray          # [A] int32 (team id)
    agent_inv_class: np.ndarray      # [A] int32
    agent_freeze_duration: np.ndarray  # [A] int32
    agent_initial_vibe: np.ndarray   # [A] int32
    agent_initial_inv: np.ndarray    # [A, R] int32
    agent_regen: np.ndarray          # [A, V, R] int32 (vibe-row with fallback baked in)
    agent_has_regen: np.ndarray      # [A] bool
    agent_damage_enabled: np.ndarray  # [A] bool
    agent_damage_threshold: np.ndarray  # [A, R] int32
    agent_damage_thresh_mask: np.ndarray  # [A, R] bool
    agent_damage_res_min: np.ndarray  # [A, R] int32
    agent_damage_res_mask: np.ndarray  # [A, R] bool
    agent_tags: np.ndarray           # [A, max_tags] int32 (-1 pad)
    agent_collective: np.ndarray     # [A] int32 (-1 none)
    coll_aligned_init: np.ndarray    # [NL, NT] int32 initial member counts
    # stat rewards compiled to (src, idx, weight, max) tuples per slot
    stat_src: np.ndarray    # [A, S] int32
    stat_idx: np.ndarray    # [A, S] int32
    stat_w: np.ndarray      # [A, S] f32
    stat_max: np.ndarray    # [A, S] f32 (+inf when uncapped)
    goal_token_mask: np.ndarray  # [A, R] bool — goal tokens per rewarding resource

    # --- object types (index 0 = agent; walls/assemblers/chests from objects) ---
    type_kind: np.ndarray   # [NT] int32 KIND_*
    type_tags: np.ndarray   # [NT, max_tags] int32 (-1 pad)
    type_vibe: np.ndarray   # [NT] int32
    # assembler-type extras (indexed by type id; zeros for non-assemblers)
    type_allow_partial: np.ndarray   # [NT] bool
    type_max_uses: np.ndarray        # [NT] int32
    type_chest_search: np.ndarray    # [NT] int32
    type_clip_immune: np.ndarray     # [NT] bool
    type_start_clipped: np.ndarray   # [NT] bool

    # --- chest-type vibe transfers ---
    chest_vibe_delta: np.ndarray  # [NT, V, R] int32
    chest_vibe_has: np.ndarray    # [NT, V] bool
    chest_type_inv_class: np.ndarray  # [NT] int32
    chest_initial_inv: np.ndarray     # [NT, R] int32

    # --- protocols (flattened over all assembler types) ---
    proto_type: np.ndarray        # [P] int32 (owning assembler type id)
    proto_key: np.ndarray         # [P, 8] int32 (sorted-asc vibe vector, 0-padded front)
    proto_min_agents: np.ndarray  # [P] int32
    proto_in: np.ndarray          # [P, R] int32
    proto_out: np.ndarray         # [P, R] int32
    proto_cooldown: np.ndarray    # [P] int32
    proto_nvibes: np.ndarray      # [P] int32
    proto_vibe_counts: np.ndarray  # [P, V] int32
    proto_rank: np.ndarray        # [P] int32 selection priority (higher = first)
    proto_valid: np.ndarray       # [P] bool

    # --- unclip protocols (clipper) ---
    uproto_key: np.ndarray        # [UP, 8] int32
    uproto_min_agents: np.ndarray  # [UP] int32
    uproto_in: np.ndarray         # [UP, R] int32
    uproto_out: np.ndarray        # [UP, R] int32
    uproto_cooldown: np.ndarray   # [UP] int32
    uproto_nvibes: np.ndarray     # [UP] int32
    uproto_vibe_counts: np.ndarray  # [UP, V] int32
    uproto_valid: np.ndarray      # [UP] bool

    # --- clipper ---
    clipper_enabled: bool
    clip_period: int
    clipper_infection_w: np.ndarray  # [NA, NA] int32 (precomputed weights)

    # --- AOE sources (core/aoe_helper.hpp, wired per GameConfig.aoe_sources) ---
    aoe_src_r: np.ndarray     # [NS] int32 source positions (map instances)
    aoe_src_c: np.ndarray     # [NS] int32
    aoe_radius: np.ndarray    # [NS] int32 Chebyshev radius
    aoe_deltas: np.ndarray    # [NS, R] int32 per-tick resource deltas
    aoe_align: np.ndarray     # [NS] int32 (0 any, 1 same_collective, 2 different)
    aoe_tags: np.ndarray      # [NS, max_tags] int32 target tag filter (-1 pad)
    aoe_src_coll: np.ndarray  # [NS] int32 source collective (-1 unaligned)
    aoe_valid: np.ndarray     # [NS] bool

    # --- activation handlers fired on move-into-agent bumps
    # (actions/activation_handler.hpp; stored as canonical-JSON strings so the
    # handler chain is static/hashable — trace-time specialization) ---
    on_bump_handlers: list

    # --- collectives ---
    coll_inv_class: np.ndarray   # [NL] int32
    coll_initial_inv: np.ndarray  # [NL, R] int32

    # --- observations ---
    global_episode_completion: bool
    global_last_action: bool
    global_last_reward: bool
    global_compass: bool
    global_goal: bool
    protocol_details_obs: bool
    scan_dr: np.ndarray  # [S_obs] int32 center-out window row offsets
    scan_dc: np.ndarray  # [S_obs] int32
    feat_id: dict        # feature name -> id (uint8 values)
    inv_feature_ids: np.ndarray       # [R, num_inv_tokens] int32
    proto_input_feature: np.ndarray   # [R] int32
    proto_output_feature: np.ndarray  # [R] int32


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _res_vec(mapping: dict[str, int], name_to_id: dict[str, int], R: int, dtype=np.int32) -> np.ndarray:
    out = np.zeros((R,), dtype=dtype)
    for name, amount in mapping.items():
        if name not in name_to_id:
            raise ValueError(f"Unknown resource name: {name!r}")
        out[name_to_id[name]] = amount
    return out


def center_out_scan_order(height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Window offsets in increasing-Manhattan-distance order.

    Parity: ``systems/packed_coordinate.hpp:74-140`` (ObservationPattern).
    For each distance d, rows dr from -d..d, and for each dr the column
    offsets -dc then +dc. Offsets outside the window are skipped.
    """
    row_min, row_max = -(height // 2), height // 2
    col_min, col_max = -(width // 2), width // 2
    out: list[tuple[int, int]] = []
    max_d = (height // 2) + (width // 2)
    for d in range(0, max_d + 1):
        for dr in range(-d, d + 1):
            dc_abs = d - abs(dr)
            cols = [0] if dc_abs == 0 else [-dc_abs, dc_abs]
            for dc in cols:
                if row_min <= dr <= row_max and col_min <= dc <= col_max:
                    out.append((dr, dc))
    assert len(out) == height * width
    drs = np.array([p[0] for p in out], dtype=np.int32)
    dcs = np.array([p[1] for p in out], dtype=np.int32)
    return drs, dcs


def _protocol_key_vec(vibe_ids: list[int]) -> np.ndarray:
    """Sorted-ascending vibe vector, front-padded with zeros to length 8.

    Equivalent to the reference's uint64 GroupVibe pack
    (``assembler.hpp:326-331``): fold of sorted vibes, 8 bits each. Comparing
    the padded vectors equals comparing the packed integers because empty
    slots and vibe-0 agents both contribute 0.
    """
    if len(vibe_ids) > 8:
        raise ValueError("A protocol cannot require more than 8 vibes")
    vec = np.zeros((8,), dtype=np.int32)
    s = sorted(vibe_ids)
    if s:
        vec[8 - len(s):] = s
    return vec


class _InventoryClassTable:
    """Accumulates distinct inventory configurations into class ids."""

    def __init__(self, resource_names: list[str]):
        self.resource_names = resource_names
        self.name_to_id = {n: i for i, n in enumerate(resource_names)}
        self.classes: list[tuple] = []  # canonical keys
        self.res_group: list[np.ndarray] = []
        self.group_base: list[np.ndarray] = []
        self.group_mod: list[np.ndarray] = []

    def add(self, inv_cfg: InventoryConfig) -> int:
        R = len(self.resource_names)
        res_group = np.full((R,), -1, dtype=np.int32)
        group_base = np.full((R,), INT16_MAX, dtype=np.int32)
        group_mod = np.zeros((R, R), dtype=np.int32)
        g = 0
        for lim in inv_cfg.limits.values():
            ids = [self.name_to_id[n] for n in lim.resources if n in self.name_to_id]
            if not ids:
                continue
            for rid in ids:
                res_group[rid] = g
            group_base[g] = lim.limit
            for mod_name, bonus in lim.modifiers.items():
                if mod_name in self.name_to_id:
                    group_mod[g, self.name_to_id[mod_name]] = bonus
            g += 1
        # Default per-resource groups for unconfigured resources (parity:
        # mettagrid_c_config.py default limit_defs).
        for rid in range(R):
            if res_group[rid] < 0:
                res_group[rid] = g
                group_base[g] = min(inv_cfg.default_limit, INT16_MAX)
                g += 1

        key = (res_group.tobytes(), group_base.tobytes(), group_mod.tobytes())
        for i, existing in enumerate(self.classes):
            if existing == key:
                return i
        self.classes.append(key)
        self.res_group.append(res_group)
        self.group_base.append(group_base)
        self.group_mod.append(group_mod)
        return len(self.classes) - 1

    def group_mod_any(self) -> bool:
        return any((gm != 0).any() for gm in self.group_mod)

    def max_base_limit_per_resource(self) -> np.ndarray:
        """Tightest static inventory-value bound per resource across all
        classes (valid when no limit modifiers exist)."""
        R = len(self.resource_names)
        out = np.zeros((R,), np.int64)
        if not self.classes:
            return np.full((R,), INT16_MAX, np.int64)
        for res_group, group_base in zip(self.res_group, self.group_base):
            for rid in range(R):
                out[rid] = max(out[rid], int(group_base[res_group[rid]]))
        return np.minimum(out, INT16_MAX)

    def as_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        C = max(len(self.classes), 1)
        R = len(self.resource_names)
        res_group = np.zeros((C, R), dtype=np.int32)
        group_base = np.full((C, R), INT16_MAX, dtype=np.int32)
        group_mod = np.zeros((C, R, R), dtype=np.int32)
        for i in range(len(self.classes)):
            res_group[i] = self.res_group[i]
            group_base[i] = self.group_base[i]
            group_mod[i] = self.group_mod[i]
        has_mods = (group_mod != 0).any(axis=(1, 2))
        return res_group, group_base, group_mod, has_mods


_STAT_PATTERNS = [
    (re.compile(r"^(?P<r>[^.]+)\.amount$"), SRC_INV_AMOUNT),
    (re.compile(r"^(?P<r>[^.]+)\.gained$"), SRC_GAINED),
    (re.compile(r"^(?P<r>[^.]+)\.lost$"), SRC_LOST),
    (re.compile(r"^chest\.(?P<r>[^.]+)\.amount$"), SRC_CHEST_AMOUNT),
    (re.compile(r"^chest\.(?P<r>[^.]+)\.deposited$"), SRC_CHEST_DEPOSITED),
    (re.compile(r"^chest\.(?P<r>[^.]+)\.withdrawn$"), SRC_CHEST_WITHDRAWN),
    (re.compile(r"^chest\.(?P<r>[^.]+)\.deposited_by_agent$"), SRC_CHEST_DEPOSITED_BY_AGENT),
    (re.compile(r"^assembler\.(?P<r>[^.]+)\.created$"), SRC_ASM_CREATED),
    (re.compile(r"^collective\.(?P<r>[^.]+)\.deposited$"), SRC_COLL_DEPOSITED),
    (re.compile(r"^collective\.(?P<r>[^.]+)\.withdrawn$"), SRC_COLL_WITHDRAWN),
]

_ALIGNED_PATTERN = re.compile(r"^aligned\.(?P<t>[^.]+)$")


def _parse_stat_key(key: str, name_to_id: dict[str, int],
                    type_name_to_id: dict[str, int] | None = None) -> tuple[int, int]:
    for pattern, src in _STAT_PATTERNS:
        m = pattern.match(key)
        if m and m.group("r") in name_to_id:
            return src, name_to_id[m.group("r")]
    m = _ALIGNED_PATTERN.match(key)
    if m and type_name_to_id and m.group("t") in type_name_to_id:
        # live collective member count by object type (collective.hpp:52,
        # agent.cpp:116): idx indexes the TYPE table, not resources
        return SRC_ALIGNED, type_name_to_id[m.group("t")]
    logger.warning("stat reward key %r is not engine-compiled; it will read 0", key)
    return SRC_ZERO, 0


# ---------------------------------------------------------------------------
# main compile
# ---------------------------------------------------------------------------


def compile_game(game: GameConfig, game_map: GameMap) -> tuple[CompiledConfig, dict[str, Any]]:
    """Compile a GameConfig + built map into dense tables + raw init arrays.

    Returns (compiled_config, init) where ``init`` is a dict of numpy arrays
    consumed by ``metta_tpu_torch.engine.step.make_initial_state``.
    """
    from metta_tpu_torch.engine.state import KIND_ASSEMBLER, KIND_CHEST, KIND_WALL

    R = len(game.resource_names)
    name_to_id = {n: i for i, n in enumerate(game.resource_names)}
    vibes = game.actions.change_vibe.vibes
    V = len(vibes)
    vibe_to_id = {v.name: i for i, v in enumerate(vibes)}
    H, W = game_map.height, game_map.width

    # --- object type ids: 0 = agent; sorted object keys 1-based (parity) ---
    type_names_sorted = sorted(game.objects.keys())
    type_id_by_name = {n: i + 1 for i, n in enumerate(type_names_sorted)}
    NT = 1 + len(type_names_sorted)
    object_type_names = ["agent"] + type_names_sorted
    type_name_to_id = {n: i for i, n in enumerate(object_type_names)}

    # --- tags ---
    all_tags: set[str] = set()
    for obj in game.objects.values():
        all_tags.update(obj.tags)
    agents_list = list(game.agents)
    if not agents_list:
        agents_list = [game.agent.model_copy(deep=True) for _ in range(game.num_agents)]
    for a in agents_list:
        all_tags.update(a.tags)
    sorted_tags = sorted(all_tags)
    if len(sorted_tags) > 256:
        raise ValueError(f"Too many unique tags ({len(sorted_tags)}); max 256")
    tag_to_id = {t: i for i, t in enumerate(sorted_tags)}
    max_tags = max([1] + [len(o.tags) for o in game.objects.values()] + [len(a.tags) for a in agents_list])

    # --- feature ids ---
    id_map = game.id_map()
    feature_ids = id_map.feature_ids()
    feature_norms = {f.id: f.normalization for f in id_map.features()}
    base = game.obs.token_value_base
    n_inv_tokens = num_inventory_tokens_needed(INT16_MAX, base)
    inv_feature_ids = np.zeros((R, n_inv_tokens), dtype=np.int32)
    for r, rn in enumerate(game.resource_names):
        inv_feature_ids[r, 0] = feature_ids[f"inv:{rn}"]
        for p in range(1, n_inv_tokens):
            inv_feature_ids[r, p] = feature_ids[f"inv:{rn}:p{p}"]
    proto_input_feature = np.zeros((R,), dtype=np.int32)
    proto_output_feature = np.zeros((R,), dtype=np.int32)
    if game.protocol_details_obs:
        for r, rn in enumerate(game.resource_names):
            proto_input_feature[r] = feature_ids[f"protocol_input:{rn}"]
            proto_output_feature[r] = feature_ids[f"protocol_output:{rn}"]

    # --- actions: flattened variant table ---
    acts = game.actions
    action_names: list[str] = []
    action_kind: list[int] = []
    action_arg: list[int] = []
    action_required: list[np.ndarray] = []
    action_consumed: list[np.ndarray] = []

    def _handler_vectors(cfg) -> tuple[np.ndarray, np.ndarray]:
        if not cfg.enabled:
            return np.zeros((R,), np.int32), np.zeros((R,), np.int32)
        consumed = _res_vec(cfg.consumed_resources, name_to_id, R)
        required_src = cfg.required_resources or cfg.consumed_resources
        required = _res_vec(required_src, name_to_id, R)
        return required, consumed

    noop_req, noop_con = _handler_vectors(acts.noop)
    if acts.noop.enabled:
        action_names.append("noop")
        action_kind.append(ACT_NOOP)
        action_arg.append(0)
        action_required.append(noop_req)
        action_consumed.append(noop_con)
    move_req, move_con = _handler_vectors(acts.move)
    if acts.move.enabled:
        dir_id = {n: i for i, n in enumerate(ORIENTATION_NAMES)}
        for d in acts.move.allowed_directions:
            action_names.append(f"move_{d}")
            action_kind.append(ACT_MOVE)
            action_arg.append(dir_id[d])
            action_required.append(move_req)
            action_consumed.append(move_con)
    cv_req, cv_con = _handler_vectors(acts.change_vibe)
    if acts.change_vibe.enabled:
        for i, v in enumerate(acts.change_vibe.vibes):
            action_names.append(f"change_vibe_{v.name}")
            action_kind.append(ACT_CHANGE_VIBE)
            action_arg.append(i)
            action_required.append(cv_req)
            action_consumed.append(cv_con)
    n_actions = len(action_names)
    if n_actions == 0:
        raise ValueError("No actions enabled")

    # --- attack tables ---
    atk = acts.attack
    attack_req, attack_con = _handler_vectors(atk)
    attack_vibe_mask = np.zeros((V,), dtype=bool)
    for vn in atk.vibes:
        if vn not in vibe_to_id:
            raise ValueError(f"Unknown vibe name {vn!r} in attack.vibes")
        attack_vibe_mask[vibe_to_id[vn]] = True
    attack_vibe_bonus = np.zeros((V,), dtype=np.int32)
    for vn, b in atk.vibe_bonus.items():
        attack_vibe_bonus[vibe_to_id[vn]] = b
    vibe_matches_resource = np.zeros((V, R), dtype=bool)
    for v_id, v in enumerate(vibes):
        if v_id == 0:
            continue  # vibe 0 never matches (attack.hpp:161-167)
        if v.name in name_to_id:
            vibe_matches_resource[v_id, name_to_id[v.name]] = True

    # --- transfer tables ---
    tr = acts.transfer
    transfer_required = (
        _res_vec(tr.required_resources, name_to_id, R) if tr.enabled else np.zeros((R,), np.int32)
    )
    transfer_vibe_mask = np.zeros((V,), dtype=bool)
    transfer_actor_delta = np.zeros((V, R), dtype=np.int32)
    transfer_target_delta = np.zeros((V, R), dtype=np.int32)
    if tr.enabled:
        seen = set()
        for vt in tr.vibe_transfers:
            if vt.vibe not in vibe_to_id:
                raise ValueError(f"Unknown vibe name {vt.vibe!r} in transfer.vibe_transfers")
            if vt.vibe in seen:
                raise ValueError(f"Duplicate vibe {vt.vibe!r} in transfer.vibe_transfers")
            seen.add(vt.vibe)
            v_id = vibe_to_id[vt.vibe]
            transfer_vibe_mask[v_id] = True
            transfer_actor_delta[v_id] = _res_vec(vt.actor, name_to_id, R)
            transfer_target_delta[v_id] = _res_vec(vt.target, name_to_id, R)
        # Attack wins if a vibe is registered for both (move.hpp checks attack first).
        transfer_vibe_mask &= ~attack_vibe_mask

    # --- inventory classes & per-team agent compile ---
    inv_table = _InventoryClassTable(game.resource_names)

    # Group agents by team; first agent in team is the template (parity).
    team_of_agent: dict[int, int] = {}
    teams: dict[int, AgentConfig] = {}
    for idx, a in enumerate(agents_list):
        team_of_agent[idx] = a.team_id
        if a.team_id not in teams:
            teams[a.team_id] = a
    team_ids = sorted(teams)
    group_names = [_team_group_name(t) for t in team_ids]

    class _TeamCompiled:
        pass

    team_compiled: dict[int, Any] = {}
    n_stat_slots = 1
    for t in team_ids:
        tc = _TeamCompiled()
        a = teams[t]
        tc.inv_class = inv_table.add(a.inventory)
        tc.freeze_duration = a.freeze_duration
        tc.initial_vibe = a.initial_vibe
        tc.initial_inv = _res_vec(a.inventory.initial, name_to_id, R)
        tc.tags = [tag_to_id[tg] for tg in a.tags]
        # stat rewards: inventory rewards become <r>.amount stats (parity).
        stat_rewards: dict[str, float] = dict(a.rewards.stats)
        stat_max: dict[str, float] = dict(a.rewards.stats_max)
        for rn, wgt in a.rewards.inventory.items():
            if rn not in name_to_id:
                raise ValueError(f"Inventory reward {rn!r} not in resource_names")
            skey = f"{rn}.amount"
            if skey in stat_rewards:
                raise ValueError(f"Stat reward {skey} already exists")
            stat_rewards[skey] = wgt
        for rn, mx in a.rewards.inventory_max.items():
            stat_max[f"{rn}.amount"] = mx
        tc.stat_entries = []
        for key, wgt in stat_rewards.items():
            src, ridx = _parse_stat_key(key, name_to_id, type_name_to_id)
            mx = stat_max.get(key, np.inf)
            tc.stat_entries.append((src, ridx, float(wgt), float(mx)))
        n_stat_slots = max(n_stat_slots, len(tc.stat_entries))
        # goal tokens: one per rewarding resource prefix (mettagrid_c.cpp:363-395)
        tc.goal_resources = set()
        for key in stat_rewards:
            prefix = key.split(".", 1)[0]
            if prefix in name_to_id:
                tc.goal_resources.add(name_to_id[prefix])
        # regen: [V, R] with fallback rows baked in
        regen = np.zeros((V, R), dtype=np.int32)
        regen_map = {vibe_to_id[vn]: _res_vec(res, name_to_id, R) for vn, res in a.inventory.regen_amounts.items()}
        default_row = regen_map.get(0, np.zeros((R,), np.int32))
        for v_id in range(V):
            regen[v_id] = regen_map.get(v_id, default_row)
        tc.regen = regen
        tc.has_regen = bool(a.inventory.regen_amounts)
        # damage
        dmg = a.damage
        tc.damage_enabled = bool(dmg and dmg.threshold and dmg.resources)
        tc.damage_threshold = _res_vec(dmg.threshold if dmg else {}, name_to_id, R)
        tc.damage_thresh_mask = np.zeros((R,), dtype=bool)
        tc.damage_res_min = _res_vec(dmg.resources if dmg else {}, name_to_id, R)
        tc.damage_res_mask = np.zeros((R,), dtype=bool)
        if dmg:
            for rn in dmg.threshold:
                tc.damage_thresh_mask[name_to_id[rn]] = True
            for rn in dmg.resources:
                tc.damage_res_mask[name_to_id[rn]] = True
        team_compiled[t] = tc

    # --- chest types / assembler types / walls from objects ---
    chest_vibe_delta = np.zeros((NT, V, R), dtype=np.int32)
    chest_vibe_has = np.zeros((NT, V), dtype=bool)
    chest_type_inv_class = np.zeros((NT,), dtype=np.int32)
    chest_initial_inv = np.zeros((NT, R), dtype=np.int32)
    type_kind = np.zeros((NT,), dtype=np.int32)
    type_tags = np.full((NT, max_tags), -1, dtype=np.int32)
    type_vibe = np.zeros((NT,), dtype=np.int32)
    type_allow_partial = np.zeros((NT,), dtype=bool)
    type_max_uses = np.zeros((NT,), dtype=np.int32)
    type_chest_search = np.zeros((NT,), dtype=np.int32)
    type_clip_immune = np.zeros((NT,), dtype=bool)
    type_start_clipped = np.zeros((NT,), dtype=bool)

    proto_rows: list[dict] = []

    for obj_name, obj in game.objects.items():
        t_id = type_id_by_name[obj_name]
        for k, tg in enumerate(obj.tags[:max_tags]):
            type_tags[t_id, k] = tag_to_id[tg]
        type_vibe[t_id] = obj.vibe
        if isinstance(obj, WallConfig):
            type_kind[t_id] = KIND_WALL
        elif isinstance(obj, AssemblerConfig):
            type_kind[t_id] = KIND_ASSEMBLER
            type_allow_partial[t_id] = obj.allow_partial_usage
            type_max_uses[t_id] = obj.max_uses
            type_chest_search[t_id] = obj.chest_search_distance
            type_clip_immune[t_id] = obj.clip_immune
            type_start_clipped[t_id] = obj.start_clipped
            # Protocols: reversed config order (parity: mettagrid_c_config.py
            # iterates reversed(protocols)); grouped by key; within a key sorted
            # by min_agents desc, insertion order as tie-break.
            seen_keys: list[tuple] = []
            group_insertion: dict[bytes, int] = {}
            for ins_idx, p in enumerate(reversed(obj.protocols)):
                for vn in p.vibes:
                    if vn not in vibe_to_id:
                        raise ValueError(f"Unknown vibe {vn!r} in assembler {obj_name!r}")
                v_ids = sorted(vibe_to_id[vn] for vn in p.vibes)
                sig = (tuple(v_ids), p.min_agents)
                if sig in seen_keys:
                    raise ValueError(
                        f"Duplicate protocol (vibes={p.vibes}, min_agents={p.min_agents}) in {obj_name!r}"
                    )
                seen_keys.append(sig)
                key_vec = _protocol_key_vec(v_ids)
                vibe_counts = np.zeros((V,), dtype=np.int32)
                for v_id in v_ids:
                    vibe_counts[v_id] += 1
                proto_rows.append(dict(
                    type=t_id, key=key_vec, min_agents=p.min_agents,
                    inputs=_res_vec(p.input_resources, name_to_id, R),
                    outputs=_res_vec(p.output_resources, name_to_id, R),
                    cooldown=p.cooldown, nvibes=len(v_ids), vibe_counts=vibe_counts,
                    insertion=ins_idx,
                ))
        elif isinstance(obj, ChestConfig):
            type_kind[t_id] = KIND_CHEST
            chest_type_inv_class[t_id] = inv_table.add(obj.inventory)
            chest_initial_inv[t_id] = _res_vec(obj.inventory.initial, name_to_id, R)
            for vn, deltas in obj.vibe_transfers.items():
                if vn not in vibe_to_id:
                    raise ValueError(f"Unknown vibe {vn!r} in chest {obj_name!r}")
                v_id = vibe_to_id[vn]
                chest_vibe_has[t_id, v_id] = True
                chest_vibe_delta[t_id, v_id] = _res_vec(deltas, name_to_id, R)
        else:
            raise ValueError(f"Unknown object config type for {obj_name!r}")

    # selection rank: higher wins. min_agents dominant, insertion order breaks ties
    # (earlier insertion = higher rank).
    P = max(len(proto_rows), 1)
    max_ins = max([r["insertion"] for r in proto_rows], default=0) + 1
    proto_type = np.zeros((P,), np.int32)
    proto_key = np.zeros((P, 8), np.int32)
    proto_min_agents = np.zeros((P,), np.int32)
    proto_in = np.zeros((P, R), np.int32)
    proto_out = np.zeros((P, R), np.int32)
    proto_cooldown = np.zeros((P,), np.int32)
    proto_nvibes = np.zeros((P,), np.int32)
    proto_vibe_counts = np.zeros((P, V), np.int32)
    proto_rank = np.zeros((P,), np.int32)
    proto_valid = np.zeros((P,), bool)
    for i, row in enumerate(proto_rows):
        proto_type[i] = row["type"]
        proto_key[i] = row["key"]
        proto_min_agents[i] = row["min_agents"]
        proto_in[i] = row["inputs"]
        proto_out[i] = row["outputs"]
        proto_cooldown[i] = row["cooldown"]
        proto_nvibes[i] = row["nvibes"]
        proto_vibe_counts[i] = row["vibe_counts"]
        proto_rank[i] = row["min_agents"] * max_ins + (max_ins - 1 - row["insertion"])
        proto_valid[i] = True

    # --- unclip protocols ---
    uprotos: list[ProtocolConfig] = game.clipper.unclipping_protocols if game.clipper else []
    UP = max(len(uprotos), 1)
    uproto_key = np.zeros((UP, 8), np.int32)
    uproto_min_agents = np.zeros((UP,), np.int32)
    uproto_in = np.zeros((UP, R), np.int32)
    uproto_out = np.zeros((UP, R), np.int32)
    uproto_cooldown = np.zeros((UP,), np.int32)
    uproto_nvibes = np.zeros((UP,), np.int32)
    uproto_vibe_counts = np.zeros((UP, V), np.int32)
    uproto_valid = np.zeros((UP,), bool)
    for i, p in enumerate(uprotos):
        v_ids = sorted(vibe_to_id[vn] for vn in p.vibes)
        uproto_key[i] = _protocol_key_vec(v_ids)
        uproto_min_agents[i] = p.min_agents
        uproto_in[i] = _res_vec(p.input_resources, name_to_id, R)
        uproto_out[i] = _res_vec(p.output_resources, name_to_id, R)
        uproto_cooldown[i] = p.cooldown
        uproto_nvibes[i] = len(v_ids)
        for v_id in v_ids:
            uproto_vibe_counts[i, v_id] += 1
        uproto_valid[i] = True

    # --- collectives ---
    NL = max(len(game.collectives), 1)
    coll_inv_class = np.zeros((NL,), np.int32)
    coll_initial_inv = np.zeros((NL, R), np.int32)
    coll_name_to_id: dict[str, int] = {}
    for i, c in enumerate(game.collectives):
        coll_name_to_id[c.name] = i
        coll_inv_class[i] = inv_table.add(c.inventory)
        coll_initial_inv[i] = _res_vec(c.inventory.initial, name_to_id, R)

    # ------------------------------------------------------------------
    # map bake: scan grid, place agents/walls/assemblers/chests
    # ------------------------------------------------------------------
    grid = game_map.grid
    static_kind = np.zeros((H, W), np.int32)
    static_idx = np.zeros((H, W), np.int32)
    static_type = np.zeros((H, W), np.int32)
    agent_rows: list[tuple[int, int, int]] = []  # (r, c, team)
    asm_list: list[tuple[int, int, int]] = []    # (r, c, type_id)
    chest_list: list[tuple[int, int, int]] = []

    group_name_to_team = {_team_group_name(t): t for t in team_ids}

    for r in range(H):
        for c in range(W):
            cell = str(grid[r, c])
            if cell in ("empty", ".", " ", ""):
                continue
            if cell.startswith("agent.") or cell == "agent":
                suffix = cell.split(".", 1)[1] if "." in cell else "agent"
                if suffix in ("agent", "default"):
                    team = 0
                elif suffix.startswith("team_"):
                    team = int(suffix[5:])
                elif suffix in group_name_to_team:
                    team = group_name_to_team[suffix]
                else:
                    raise ValueError(f"Unknown agent group in map cell {cell!r}")
                if team not in team_compiled:
                    raise ValueError(f"Map requests agents of team {team} but no config exists")
                agent_rows.append((r, c, team))
                continue
            # objects are keyed by map_name
            matched = None
            for obj_name, obj in game.objects.items():
                if (obj.map_name or obj_name) == cell or obj_name == cell:
                    matched = (obj_name, obj)
                    break
            if matched is None:
                raise ValueError(f"Unknown object type in map: {cell!r}")
            obj_name, obj = matched
            t_id = type_id_by_name[obj_name]
            static_type[r, c] = t_id
            if isinstance(obj, WallConfig):
                static_kind[r, c] = KIND_WALL
                static_idx[r, c] = 0
            elif isinstance(obj, AssemblerConfig):
                static_kind[r, c] = KIND_ASSEMBLER
                static_idx[r, c] = len(asm_list)
                asm_list.append((r, c, t_id))
            elif isinstance(obj, ChestConfig):
                static_kind[r, c] = KIND_CHEST
                static_idx[r, c] = len(chest_list)
                chest_list.append((r, c, t_id))

    A = game.num_agents
    if len(agent_rows) != A:
        raise ValueError(f"Map has {len(agent_rows)} agents but num_agents={A}")

    # per-agent arrays
    agent_group = np.zeros((A,), np.int32)
    agent_inv_class = np.zeros((A,), np.int32)
    agent_freeze_duration = np.zeros((A,), np.int32)
    agent_initial_vibe = np.zeros((A,), np.int32)
    agent_initial_inv = np.zeros((A, R), np.int32)
    agent_regen = np.zeros((A, V, R), np.int32)
    agent_has_regen = np.zeros((A,), bool)
    agent_damage_enabled = np.zeros((A,), bool)
    agent_damage_threshold = np.zeros((A, R), np.int32)
    agent_damage_thresh_mask = np.zeros((A, R), bool)
    agent_damage_res_min = np.zeros((A, R), np.int32)
    agent_damage_res_mask = np.zeros((A, R), bool)
    agent_tags = np.full((A, max_tags), -1, np.int32)
    agent_collective = np.full((A,), -1, np.int32)
    stat_src = np.zeros((A, n_stat_slots), np.int32)
    stat_idx = np.zeros((A, n_stat_slots), np.int32)
    stat_w = np.zeros((A, n_stat_slots), np.float32)
    stat_max_arr = np.full((A, n_stat_slots), np.inf, np.float32)
    goal_token_mask = np.zeros((A, R), bool)
    init_agent_r = np.zeros((A,), np.int32)
    init_agent_c = np.zeros((A,), np.int32)
    agent_grid = np.zeros((H, W), np.int32)

    for a_id, (r, c, team) in enumerate(agent_rows):
        tc = team_compiled[team]
        init_agent_r[a_id] = r
        init_agent_c[a_id] = c
        agent_grid[r, c] = a_id + 1
        agent_group[a_id] = team
        agent_inv_class[a_id] = tc.inv_class
        agent_freeze_duration[a_id] = tc.freeze_duration
        agent_initial_vibe[a_id] = tc.initial_vibe
        agent_initial_inv[a_id] = tc.initial_inv
        agent_regen[a_id] = tc.regen
        agent_has_regen[a_id] = tc.has_regen
        agent_damage_enabled[a_id] = tc.damage_enabled
        agent_damage_threshold[a_id] = tc.damage_threshold
        agent_damage_thresh_mask[a_id] = tc.damage_thresh_mask
        agent_damage_res_min[a_id] = tc.damage_res_min
        agent_damage_res_mask[a_id] = tc.damage_res_mask
        for k, tg in enumerate(tc.tags[:max_tags]):
            agent_tags[a_id, k] = tg
        for s, (src, ridx, wgt, mx) in enumerate(tc.stat_entries):
            stat_src[a_id, s] = src
            stat_idx[a_id, s] = ridx
            stat_w[a_id, s] = wgt
            stat_max_arr[a_id, s] = mx
        for ridx in tc.goal_resources:
            goal_token_mask[a_id, ridx] = True
        # collective membership from tags
        for tg_name in teams[team].tags:
            if tg_name.startswith("collective:"):
                cname = tg_name.split(":", 1)[1]
                if cname in coll_name_to_id:
                    agent_collective[a_id] = coll_name_to_id[cname]

    NA = max(len(asm_list), 1)
    NC = max(len(chest_list), 1)
    asm_r = np.zeros((NA,), np.int32)
    asm_c = np.zeros((NA,), np.int32)
    asm_type = np.zeros((NA,), np.int32)
    asm_valid = np.zeros((NA,), bool)
    for i, (r, c, t_id) in enumerate(asm_list):
        asm_r[i], asm_c[i], asm_type[i] = r, c, t_id
        asm_valid[i] = True
    chest_r = np.zeros((NC,), np.int32)
    chest_c = np.zeros((NC,), np.int32)
    chest_type_arr = np.zeros((NC,), np.int32)
    chest_valid = np.zeros((NC,), bool)
    init_chest_inv = np.zeros((NC, R), np.int32)
    for i, (r, c, t_id) in enumerate(chest_list):
        chest_r[i], chest_c[i], chest_type_arr[i] = r, c, t_id
        chest_valid[i] = True
        init_chest_inv[i] = chest_initial_inv[t_id]

    # --- clipper precompute (clipper.hpp:46-168) ---
    clipper_enabled = game.clipper is not None
    clip_period = game.clipper.clip_period if game.clipper else 0
    clipper_w = np.zeros((NA, NA), np.int32)
    if clipper_enabled and asm_list:
        length_scale = game.clipper.length_scale
        eligible = [i for i in range(len(asm_list)) if not type_clip_immune[asm_type[i]]]
        if length_scale <= 0 and eligible:
            sparsity = (W * H) // len(eligible)
            root, root_next = 1, 10
            for _ in range(10):
                if root_next == root or root == 0:
                    break
                root = root_next
                root_next = (sparsity + root * root + (2 * root - 2)) // (2 * root)
            length_scale = max(root // 2, 1)
        cutoff = game.clipper.scaled_cutoff_distance
        for i in eligible:
            for j in eligible:
                if i == j:
                    continue
                dist = max(abs(int(asm_r[i]) - int(asm_r[j])), abs(int(asm_c[i]) - int(asm_c[j])))
                scaled = dist // max(length_scale, 1)
                if scaled <= cutoff:
                    clipper_w[i, j] = 1 << (cutoff - scaled)

    # --- initial collective member counts by type (collective.hpp:47-56:
    # agents join via their team's collective:<name> tag; static objects via
    # their type config's tags) ---
    coll_aligned_init = np.zeros((NL, NT), np.int32)
    for a_id in range(A):
        cl = agent_collective[a_id]
        if cl >= 0:
            coll_aligned_init[cl, 0] += 1          # type 0 = "agent"
    type_collective = np.full((NT,), -1, np.int32)
    for obj_name, obj in game.objects.items():
        for tg_name in obj.tags:
            if tg_name.startswith("collective:"):
                cname = tg_name.split(":", 1)[1]
                if cname in coll_name_to_id:
                    type_collective[type_id_by_name[obj_name]] = coll_name_to_id[cname]
    for (_r, _c, t_id) in asm_list:
        if type_collective[t_id] >= 0:
            coll_aligned_init[type_collective[t_id], t_id] += 1
    for (_r, _c, t_id) in chest_list:
        if type_collective[t_id] >= 0:
            coll_aligned_init[type_collective[t_id], t_id] += 1

    # --- AOE sources: every map instance of each configured object type
    # becomes a registered source (aoe_helper.hpp register_source) ---
    aoe_entries: list[tuple[int, int, "object"]] = []  # (r, c, src_cfg)
    for src in game.aoe_sources:
        if src.object not in type_id_by_name:
            raise ValueError(f"aoe_sources references unknown object {src.object!r}")
        t_id = type_id_by_name[src.object]
        for r in range(H):
            for c in range(W):
                if static_type[r, c] == t_id and static_kind[r, c] != 0:
                    aoe_entries.append((r, c, (src, t_id)))
    NS = max(len(aoe_entries), 1)
    aoe_src_r = np.zeros((NS,), np.int32)
    aoe_src_c = np.zeros((NS,), np.int32)
    aoe_radius = np.zeros((NS,), np.int32)
    aoe_deltas = np.zeros((NS, R), np.int32)
    aoe_align = np.zeros((NS,), np.int32)
    aoe_tags = np.full((NS, max_tags), -1, np.int32)
    aoe_src_coll = np.full((NS,), -1, np.int32)
    aoe_valid = np.zeros((NS,), bool)
    _align_code = {"any": 0, "same_collective": 1, "different_collective": 2}
    for i, (r, c, (src, t_id)) in enumerate(aoe_entries):
        aoe_src_r[i], aoe_src_c[i] = r, c
        aoe_radius[i] = src.aoe.radius
        for d in src.aoe.deltas:
            if not (0 <= d.resource_id < R):
                raise ValueError(f"AOE delta resource_id {d.resource_id} out of range")
            aoe_deltas[i, d.resource_id] += d.delta
        aoe_align[i] = _align_code[src.aoe.alignment_filter]
        tag_ids = list(src.aoe.target_tag_ids)
        for tname in src.target_tags:
            if tname not in tag_to_id:
                raise ValueError(f"AOE target tag {tname!r} not present in config")
            tag_ids.append(tag_to_id[tname])
        for k, tg in enumerate(tag_ids[:max_tags]):
            aoe_tags[i, k] = tg
        aoe_src_coll[i] = type_collective[t_id]
        aoe_valid[i] = True

    # --- on-bump activation handlers: frozen to canonical JSON (static) ---
    on_bump_handlers = [
        h.model_dump_json() for h in game.on_bump_handlers
    ]

    scan_dr, scan_dc = center_out_scan_order(game.obs.height, game.obs.width)

    # worst-case tokens a single cell can emit (static bound for the renderer).
    # Protocol tokens are emitted only for the selected protocol's *nonzero*
    # inputs/outputs, so the assembler bound is the max nonzero count over all
    # protocols, not 2R (K sizes the renderer's per-cell planes — keep tight).
    #
    # Inventory tokens: `inv:<r>:pN` power tokens only appear while
    # value // base^N > 0, and inventory values are clamped to the class
    # limits — so the per-resource token count follows from the tightest
    # provable value bound, not from uint16 range. Feature *ids* keep the
    # full n_inv_tokens layout (the IdMap compatibility contract); only the
    # renderer's per-cell plane count shrinks. Limit modifiers make limits
    # dynamic → fall back to the uint16 bound.
    if inv_table.group_mod_any():
        res_value_bound = np.full((R,), INT16_MAX, np.int64)
    else:
        res_value_bound = inv_table.max_base_limit_per_resource()
    # initial inventories are not re-clamped against class limits at reset
    res_value_bound = np.maximum(res_value_bound, agent_initial_inv.max(axis=0))
    if chest_initial_inv.size:
        res_value_bound = np.maximum(res_value_bound, chest_initial_inv.max(axis=0))
    sum_inv_tokens = int(sum(
        num_inventory_tokens_needed(int(v), base) for v in res_value_bound
    ))
    k_agent = 3 + sum_inv_tokens + max_tags
    k_wall = 1 + max_tags
    if game.protocol_details_obs and (P > 0 or UP > 0):
        nnz = [int((row != 0).sum()) for row in proto_in] + [
            int((row != 0).sum()) for row in uproto_in
        ]
        nnz_out = [int((row != 0).sum()) for row in proto_out] + [
            int((row != 0).sum()) for row in uproto_out
        ]
        max_proto_tokens = max(
            (i + o for i, o in zip(nnz, nnz_out)), default=0
        )
    else:
        max_proto_tokens = 0
    k_asm = 3 + max_proto_tokens + max_tags + 1
    k_chest = 1 + sum_inv_tokens + max_tags
    max_tokens_per_cell = max(k_agent, k_wall, k_asm, k_chest)

    n_global = (
        int(game.global_obs.episode_completion_pct)
        + int(game.global_obs.last_action)
        + int(game.global_obs.last_reward)
        + (R if game.global_obs.goal_obs else 0)
        + int(game.global_obs.compass)
    )

    compiled = CompiledConfig(
        num_agents=A, num_resources=R, num_vibes=V, height=H, width=W,
        n_actions=n_actions, n_assembler_slots=NA, n_chest_slots=NC,
        n_collectives=NL, n_object_types=NT, n_protocols=P,
        n_unclip_protocols=UP, n_stat_slots=n_stat_slots, max_tags=max_tags,
        obs_width=game.obs.width, obs_height=game.obs.height,
        num_obs_tokens=game.obs.num_tokens, token_value_base=base,
        num_inv_tokens=n_inv_tokens, max_steps=game.max_steps,
        episode_truncates=game.episode_truncates,
        inventory_regen_interval=game.inventory_regen_interval,
        n_inventory_classes=max(len(inv_table.classes), 1),
        max_tokens_per_cell=max_tokens_per_cell,
        n_global_token_slots=max(n_global, 1),
        chest_search_distance=int(type_chest_search.max()),
        resource_names=list(game.resource_names),
        vibe_names=[v.name for v in vibes],
        action_names=action_names,
        object_type_names=object_type_names,
        group_names=group_names,
        feature_ids=feature_ids,
        feature_normalizations=feature_norms,
        action_kind=np.array(action_kind, np.int32),
        action_arg=np.array(action_arg, np.int32),
        action_required=np.stack(action_required).astype(np.int32),
        action_consumed=np.stack(action_consumed).astype(np.int32),
        move_deltas=np.array(ORIENTATION_DELTAS, np.int32),
        attack_vibe_mask=attack_vibe_mask,
        attack_required=attack_req, attack_consumed=attack_con,
        attack_defense=_res_vec(atk.defense_resources, name_to_id, R),
        attack_defense_mask=np.isin(
            np.arange(R), [name_to_id[n] for n in atk.defense_resources]
        ),
        attack_defense_any=bool(atk.defense_resources),
        attack_armor_w=_res_vec(atk.armor_resources, name_to_id, R),
        attack_weapon_w=_res_vec(atk.weapon_resources, name_to_id, R),
        attack_vibe_bonus=attack_vibe_bonus,
        vibe_matches_resource=vibe_matches_resource,
        attack_actor_delta=_res_vec(atk.success.actor_inv_delta, name_to_id, R),
        attack_target_delta=_res_vec(atk.success.target_inv_delta, name_to_id, R),
        attack_loot_ids=np.array([name_to_id[n] for n in atk.success.loot], np.int32),
        attack_freeze=atk.success.freeze,
        transfer_vibe_mask=transfer_vibe_mask,
        transfer_required=transfer_required,
        transfer_actor_delta=transfer_actor_delta,
        transfer_target_delta=transfer_target_delta,
        inv_res_group=inv_table.as_arrays()[0],
        inv_group_base=inv_table.as_arrays()[1],
        inv_group_mod=inv_table.as_arrays()[2],
        inv_class_has_mods=inv_table.as_arrays()[3],
        agent_group=agent_group, agent_inv_class=agent_inv_class,
        agent_freeze_duration=agent_freeze_duration,
        agent_initial_vibe=agent_initial_vibe,
        agent_initial_inv=agent_initial_inv,
        agent_regen=agent_regen, agent_has_regen=agent_has_regen,
        agent_damage_enabled=agent_damage_enabled,
        agent_damage_threshold=agent_damage_threshold,
        agent_damage_thresh_mask=agent_damage_thresh_mask,
        agent_damage_res_min=agent_damage_res_min,
        agent_damage_res_mask=agent_damage_res_mask,
        agent_tags=agent_tags, agent_collective=agent_collective,
        stat_src=stat_src, stat_idx=stat_idx, stat_w=stat_w, stat_max=stat_max_arr,
        goal_token_mask=goal_token_mask,
        type_kind=type_kind, type_tags=type_tags, type_vibe=type_vibe,
        type_allow_partial=type_allow_partial, type_max_uses=type_max_uses,
        type_chest_search=type_chest_search, type_clip_immune=type_clip_immune,
        type_start_clipped=type_start_clipped,
        chest_vibe_delta=chest_vibe_delta, chest_vibe_has=chest_vibe_has,
        chest_type_inv_class=chest_type_inv_class, chest_initial_inv=chest_initial_inv,
        proto_type=proto_type, proto_key=proto_key,
        proto_min_agents=proto_min_agents, proto_in=proto_in, proto_out=proto_out,
        proto_cooldown=proto_cooldown, proto_nvibes=proto_nvibes,
        proto_vibe_counts=proto_vibe_counts, proto_rank=proto_rank, proto_valid=proto_valid,
        uproto_key=uproto_key, uproto_min_agents=uproto_min_agents,
        uproto_in=uproto_in, uproto_out=uproto_out, uproto_cooldown=uproto_cooldown,
        uproto_nvibes=uproto_nvibes, uproto_vibe_counts=uproto_vibe_counts,
        uproto_valid=uproto_valid,
        clipper_enabled=clipper_enabled, clip_period=clip_period,
        clipper_infection_w=clipper_w,
        aoe_src_r=aoe_src_r, aoe_src_c=aoe_src_c, aoe_radius=aoe_radius,
        aoe_deltas=aoe_deltas, aoe_align=aoe_align, aoe_tags=aoe_tags,
        aoe_src_coll=aoe_src_coll, aoe_valid=aoe_valid,
        on_bump_handlers=on_bump_handlers,
        coll_inv_class=coll_inv_class, coll_initial_inv=coll_initial_inv,
        coll_aligned_init=coll_aligned_init,
        global_episode_completion=game.global_obs.episode_completion_pct,
        global_last_action=game.global_obs.last_action,
        global_last_reward=game.global_obs.last_reward,
        global_compass=game.global_obs.compass,
        global_goal=game.global_obs.goal_obs,
        protocol_details_obs=game.protocol_details_obs,
        scan_dr=scan_dr, scan_dc=scan_dc,
        feat_id=feature_ids,
        inv_feature_ids=inv_feature_ids,
        proto_input_feature=proto_input_feature,
        proto_output_feature=proto_output_feature,
    )

    init = dict(
        agent_r=init_agent_r, agent_c=init_agent_c,
        agent_grid=agent_grid,
        static_kind=static_kind, static_idx=static_idx, static_type=static_type,
        asm_r=asm_r, asm_c=asm_c, asm_type=asm_type, asm_valid=asm_valid,
        asm_start_clipped=type_start_clipped[asm_type] & asm_valid
        & ~type_clip_immune[asm_type],
        chest_r=chest_r, chest_c=chest_c, chest_type=chest_type_arr,
        chest_valid=chest_valid, chest_inv=init_chest_inv,
    )
    return compiled, init
