"""Device-side view of a CompiledConfig.

Counterpart of ``metta_tpu/engine/tables.py``. ``Tables`` mirrors every field
of :class:`CompiledConfig`, with numpy arrays moved to one ``torch.device``.
Python ints and bools stay plain: they are the statics that switch whole
subsystems of the step on or off (the JAX package specializes its trace on
them; here they are ordinary branches).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metta_tpu_torch.engine import compiler as _C
from metta_tpu_torch.engine.compiler import CompiledConfig
from metta_tpu_torch.engine.state import KIND_ASSEMBLER, KIND_CHEST, KIND_WALL


class Tables:
    """CompiledConfig with arrays on ``device``. Attribute-compatible.

    ``track_stats=False`` drops the gained/lost/chest stat accumulators when
    no compiled stat reward reads them (training envs turn them off; eval envs
    keep them).
    """

    def __init__(self, cfg: CompiledConfig, track_stats: bool = True,
                 device="cpu"):
        self._cfg = cfg
        self.device = torch.device(device)

        used_srcs = set(np.unique(cfg.stat_src))
        self.track_gained = track_stats or bool(
            used_srcs & {_C.SRC_GAINED, _C.SRC_LOST}
        )
        self.track_chest_stats = track_stats or bool(
            used_srcs & {
                _C.SRC_CHEST_DEPOSITED, _C.SRC_CHEST_WITHDRAWN,
                _C.SRC_CHEST_DEPOSITED_BY_AGENT, _C.SRC_ASM_CREATED,
            }
        )
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if isinstance(v, np.ndarray):
                v = torch.as_tensor(v, device=self.device)
            setattr(self, f.name, v)
        # [C, R]: is resource r a limit modifier for any group of class c?
        self.inv_is_modifier = torch.as_tensor(
            (cfg.inv_group_mod != 0).any(axis=1), device=self.device
        )

        # --- statics (switch whole subsystems) ---
        self.has_assemblers = bool(np.any(cfg.type_kind == 3))
        self.has_chests = bool(np.any(cfg.type_kind == 4))
        self.has_attack = bool(cfg.attack_vibe_mask.any())
        self.has_transfer = bool(cfg.transfer_vibe_mask.any())
        self.has_damage = bool(cfg.agent_damage_enabled.any())
        self.has_regen = cfg.inventory_regen_interval > 0 and bool(
            cfg.agent_has_regen.any()
        )
        self.has_mods = bool(cfg.inv_class_has_mods.any())
        self.has_swap = self.has_attack or bool(
            (cfg.agent_freeze_duration != 0).any()
        )
        self.loot_ids = tuple(int(r) for r in cfg.attack_loot_ids)
        self.any_attack_delta = bool(
            (cfg.attack_actor_delta != 0).any() or (cfg.attack_target_delta != 0).any()
        )
        self.any_attack_consumed = bool((cfg.attack_consumed != 0).any())
        self.any_action_consumed = bool((cfg.action_consumed != 0).any())
        self.any_allow_partial = bool(cfg.type_allow_partial.any())
        self.any_stat_aligned = bool((cfg.stat_src == _C.SRC_ALIGNED).any())
        self.has_aoe = bool(cfg.aoe_valid.any())
        self.has_bump_handlers = bool(len(cfg.on_bump_handlers))
        used_r = (
            (np.abs(cfg.proto_in).sum(0) + np.abs(cfg.proto_out).sum(0)
             + np.abs(cfg.uproto_in).sum(0) + np.abs(cfg.uproto_out).sum(0)) > 0
        )
        self.proto_res = tuple(int(i) for i in np.flatnonzero(used_r)) or (0,)

        # Fast-path gate: multi-resource inventory updates are exactly
        # order-independent when every limit group is a single resource and
        # there are no limit modifiers.
        singleton = True
        for c in range(cfg.inv_res_group.shape[0]):
            groups, counts = np.unique(cfg.inv_res_group[c], return_counts=True)
            if (counts > 1).any():
                singleton = False
        self.inv_vector_ok = singleton and not bool(cfg.inv_group_mod.any())

        # --- derived tables of the port ---
        # [A, R] per-resource limits of every agent (singleton groups;
        # step_batched.py:_row_limits_all in the JAX package)
        cls = cfg.agent_inv_class
        lims = np.take_along_axis(
            cfg.inv_group_base[cls], cfg.inv_res_group[cls], axis=1
        )
        self.agent_lims = torch.as_tensor(
            np.clip(lims, 0, _C.INT16_MAX).astype(np.int32), device=self.device
        )
        # [S, 2] center-out window offsets (dr, dc) for the obs render
        self.obs_scan = torch.as_tensor(
            np.stack([cfg.scan_dr, cfg.scan_dc], axis=1).astype(np.int32),
            device=self.device,
        )
        self.obs_static_bg = None

    @property
    def inv_tables(self):
        """(res_group, group_base, group_mod) triple for inventory ops."""
        return (self.inv_res_group, self.inv_group_base, self.inv_group_mod)


def static_block_grid(tables, static_kind, static_idx, static_type):
    """Block id of each immobile object (wall/assembler/chest), 0 elsewhere.

    Grids [..., H, W] int32 -> [..., H, W] int32."""
    A = tables.num_agents
    off_wall = 1 + A
    off_asm = off_wall + tables.n_object_types
    off_chest = off_asm + tables.n_assembler_slots
    zero = torch.zeros_like(static_kind)
    return torch.where(
        static_kind == KIND_WALL, off_wall + static_type,
        torch.where(
            static_kind == KIND_ASSEMBLER, off_asm + static_idx,
            torch.where(static_kind == KIND_CHEST, off_chest + static_idx, zero),
        ),
    ).to(torch.int32)


def attach_static_block_grid(tables, template_state):
    """Precompute the static block grid [H, W] for the obs prep once per map:
    static objects never move mid-episode. ``template_state`` is a batch of
    one env."""
    tables.obs_static_bg = static_block_grid(
        tables, template_state.static_kind[0], template_state.static_idx[0],
        template_state.static_type[0],
    )
    return tables
