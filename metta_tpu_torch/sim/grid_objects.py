"""Host-side grid-object inspection.

Counterpart of ``metta_tpu/sim/grid_objects.py`` (reference
``MettaGrid::grid_objects``, ``bindings/mettagrid_c.cpp:754-918``): a dict
of object id -> properties, used by replays, renderers and debugging. Walls,
assemblers and chests take ids from their position in the static map;
agents follow. Location is (col, row) for mettascope compatibility.

The state is one env's host copy, a dict of numpy arrays by ``EnvState``
field (``MettaGridEnv.env_state(e)``, or :func:`host_env` for the fields
named here in one transfer).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from metta_tpu_torch.engine.compiler import CompiledConfig
from metta_tpu_torch.engine.state import KIND_ASSEMBLER, KIND_CHEST
from metta_tpu_torch.utils.transfer import to_host

# the EnvState fields that grid_objects reads
GRID_FIELDS = (
    "static_kind", "static_type", "static_idx", "step", "asm_type", "asm_cooldown_end",
    "asm_cooldown_duration", "asm_clipped", "asm_uses", "chest_inv", "agent_r", "agent_c",
    "agent_frozen", "agent_vibe", "agent_current_stat_reward", "agent_steps_without_motion",
    "agent_inv",
)


def host_env(env_state, e: int = 0, names=GRID_FIELDS, **extra) -> dict:
    """Env ``e``'s fields ``names`` of a batched ``EnvState``, and the
    ``extra`` tensors as they are, on the host in one transfer."""
    return to_host({**{n: getattr(env_state, n)[e] for n in names}, **extra})


def grid_objects(
    state: dict, compiled: CompiledConfig, ignore_types: Optional[list[str]] = None
) -> dict[int, dict[str, Any]]:
    """state: one env's host state, {field: numpy array}."""
    ignore = set(ignore_types or [])
    out: dict[int, dict[str, Any]] = {}

    static_kind = state["static_kind"]
    static_type = state["static_type"]
    static_idx = state["static_idx"]
    H, W = static_kind.shape
    type_names = compiled.object_type_names

    def base(type_name: str, r: int, c: int) -> dict:
        return {
            "type_name": type_name,
            "location": (int(c), int(r)),
            "r": int(r),
            "c": int(c),
        }

    for r in range(H):
        for c in range(W):
            kind = static_kind[r, c]
            if kind == 0:
                continue
            tname = type_names[static_type[r, c]]
            if tname in ignore:
                continue
            # position-derived id: stable across calls regardless of which
            # types are enumerated (replay streams key on object identity)
            obj_id = int(r) * W + int(c) + 1
            obj = base(tname, r, c)
            obj["id"] = obj_id
            if kind == KIND_ASSEMBLER:
                i = static_idx[r, c]
                t = int(state["asm_type"][i])
                obj["cooldown_remaining"] = int(
                    max(state["asm_cooldown_end"][i] - state["step"], 0))
                obj["cooldown_duration"] = int(state["asm_cooldown_duration"][i])
                obj["is_clipped"] = bool(state["asm_clipped"][i])
                obj["is_clip_immune"] = bool(compiled.type_clip_immune[t])
                obj["uses_count"] = int(state["asm_uses"][i])
                obj["max_uses"] = int(compiled.type_max_uses[t])
                obj["allow_partial_usage"] = bool(compiled.type_allow_partial[t])
            elif kind == KIND_CHEST:
                i = static_idx[r, c]
                inv = state["chest_inv"][i]
                obj["inventory"] = {int(j): int(v) for j, v in enumerate(inv) if v > 0}
            out[obj_id] = obj

    for a in range(compiled.num_agents):
        obj_id = H * W + a + 1
        obj = base("agent", state["agent_r"][a], state["agent_c"][a])
        obj["id"] = obj_id
        obj["agent_id"] = a
        obj["group_id"] = int(compiled.agent_group[a])
        obj["group_name"] = compiled.group_names[
            sorted(set(compiled.agent_group.tolist())).index(int(compiled.agent_group[a]))
        ] if compiled.group_names else "red"
        frozen = int(state["agent_frozen"][a])
        obj["is_frozen"] = frozen != 0
        obj["freeze_remaining"] = frozen
        obj["freeze_duration"] = int(compiled.agent_freeze_duration[a])
        obj["vibe"] = int(state["agent_vibe"][a])
        obj["current_stat_reward"] = float(state["agent_current_stat_reward"][a])
        obj["steps_without_motion"] = int(state["agent_steps_without_motion"][a])
        inv = state["agent_inv"][a]
        obj["inventory"] = {int(j): int(v) for j, v in enumerate(inv) if v > 0}
        out[obj_id] = obj

    return out
