"""Device-side view of a CompiledConfig.

Counterpart of ``metta_tpu/engine/tables.py``. ``Tables`` mirrors every field
of :class:`CompiledConfig`, with numpy arrays moved to one ``torch.device``.
Python ints and bools stay plain: they are the statics that switch whole
subsystems of the step on or off (the JAX package specializes its trace on
them; here they are ordinary branches).

A task set (``engine/taskset.py``) stacks the leaves of K ``Tables`` along a
leading task axis (:func:`stack_tables`, the JAX package's
``_stack_pytrees`` with its compatibility check). The JAX step ``vmap``s over
per-env tables, so any leaf may differ between tasks; here
:func:`tables_at` with an [E] ``task_id`` gives a view whose leaves that
differ across the set hold one row per env ([E, ...], named in
``per_env``), while the leaves every task shares stay shared. The step reads
every leaf through :meth:`Tables.take` (a row lookup) or
:meth:`Tables.bcast` (an elementwise operand), which serve both.
"""

from __future__ import annotations

import copy
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
    keep them). ``obs_renderer`` picks the render of the sequential step and
    of reset (``engine/obs.py:render_observations``): ``"mm"`` (default) and
    ``"ref"`` the torch-ops renderer, ``"pl"`` kernel K5; it is a plain
    attribute, ``"mm"`` when built and set after construction by the caller
    that wants another renderer.
    """

    # leaves holding one row per env (a task set's view, see tables_at)
    per_env = frozenset()

    def __init__(self, cfg: CompiledConfig, track_stats: bool = True,
                 device="cpu"):
        self._cfg = cfg
        self.device = torch.device(device)
        self.obs_renderer = "mm"

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
        # every tensor leaf, derived ones included (the JAX pytree's children)
        self.array_names = tuple(
            f.name for f in dataclasses.fields(cfg) if isinstance(getattr(cfg, f.name), np.ndarray)
        ) + ("inv_is_modifier", "agent_lims", "obs_scan")
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

    def take(self, name: str, idx):
        """Rows ``leaf[idx]`` of leaf ``name`` for an index tensor ``idx``
        [E, ...]; a per-env leaf [E, N, ...] gives each env its own rows."""
        x = getattr(self, name)
        if name not in self.per_env:
            return x[idx]
        e = torch.arange(x.shape[0], device=x.device).view((-1,) + (1,) * (idx.dim() - 1))
        return x[e, idx]

    def bcast(self, name: str, ndim: int):
        """Leaf ``name`` as an elementwise operand of [E, ...] tensors of
        ``ndim`` dims: a shared leaf as it is (it broadcasts from the right),
        a per-env leaf [E, *tail] as [E, 1, ..., 1, *tail]."""
        x = getattr(self, name)
        if name not in self.per_env:
            return x
        return x.view((x.shape[0],) + (1,) * (ndim - x.dim()) + tuple(x.shape[1:]))


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
    if "obs_static_bg" not in tables.array_names:
        tables.array_names += ("obs_static_bg",)
    return tables


# attributes that are neither leaves nor statics of a task set
_NOT_STATIC = ("device", "array_names", "per_env", "varying", "row0")


def _statics(tables) -> dict:
    """The non-tensor attributes that must agree across a task set (the JAX
    pytree's aux data: every non-array field and every derived gate)."""
    return {k: v for k, v in vars(tables).items()
            if not k.startswith("_") and k not in _NOT_STATIC and k not in tables.array_names}


def check_compatible(tables, ref, i: int):
    """Raise ValueError unless ``tables`` shares statics, leaves and leaf
    shapes with ``ref`` (``metta_tpu/engine/taskset.py:build_task_set``)."""
    if (_statics(tables) != _statics(ref) or tables.array_names != ref.array_names
            or any(getattr(tables, n).shape != getattr(ref, n).shape for n in ref.array_names)):
        raise ValueError(
            f"task {i} is not shape/static-compatible with task 0 — "
            "a task set must share map size, agent count, action space, "
            "obs geometry, and subsystem usage (values may differ)"
        )


def _refresh(stacked):
    """Recompute which leaves differ across the set, and the task-0 view that
    holds the shared ones."""
    stacked.varying = frozenset(
        n for n in stacked.array_names
        if not bool((getattr(stacked, n) == getattr(stacked, n)[:1]).all())
    )
    stacked.row0 = tables_at(stacked, 0)
    return stacked


def stack_tables(tables_list):
    """K compatible ``Tables`` -> one ``Tables`` whose leaves are stacked
    [K, ...] (statics from task 0); raises ValueError for a task whose
    statics or leaf shapes differ from task 0's."""
    t0 = tables_list[0]
    for i, t in enumerate(tables_list[1:], 1):
        check_compatible(t, t0, i)
    stacked = _copy(t0)
    for n in t0.array_names:
        setattr(stacked, n, torch.stack([getattr(t, n) for t in tables_list]))
    return _refresh(stacked)


def put_task(stacked, slot: int, tables):
    """Replace task ``slot`` of a stacked set by ``tables`` (data only)."""
    check_compatible(tables, stacked.row0, slot)
    for n in stacked.array_names:
        getattr(stacked, n)[slot] = getattr(tables, n)
    return _refresh(stacked)


def tables_at(stacked, task_id):
    """The tables of one task (``task_id`` an int: every leaf at that row),
    or the per-env view of a batch (``task_id`` [E] int tensor: the leaves
    that differ across the set at each env's task, [E, ...], named in
    ``per_env``; the shared leaves as task 0 has them)."""
    if isinstance(task_id, int):
        view = _copy(stacked)
        for n in stacked.array_names:
            setattr(view, n, getattr(stacked, n)[task_id])
        view.varying = view.row0 = None
        view.per_env = frozenset()
        return view
    view = _copy(stacked.row0)
    idx = task_id.long()
    for n in stacked.varying:
        setattr(view, n, getattr(stacked, n)[idx])
    view.per_env = stacked.varying
    return view


def _copy(tables):
    """A shallow copy without the caches kernels keep on a ``Tables``."""
    view = copy.copy(tables)
    for k in [k for k in vars(view) if k.startswith("_") and k != "_cfg"]:
        delattr(view, k)
    return view
