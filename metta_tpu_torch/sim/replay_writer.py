"""Replay writing (mettascope-compatible ``.json.z``).

Counterpart of ``metta_tpu/sim/replay_writer.py`` (reference
``mettagrid/simulator/replay_log_writer.py``): the version-3 replay format,
a header (action, item and type names, map size, config) and per-object key
sequences ``[[step, value], ...]`` with change compression, zlib- or
gzip-compressed JSON. The layout is the JAX package's: the first logged
step is the state after the first action, static objects are written only at
step 0, and ``mg_config`` is ``env_cfg.model_dump(mode="json")``.

``EpisodeReplay.log_step`` takes the batched device state and brings env
``e``'s fields, the actions, the action successes and the rewards to the
host in one transfer (:func:`grid_objects.host_env`).
"""

from __future__ import annotations

import gzip
import json
import uuid
import zlib
from pathlib import Path
from typing import Any

import numpy as np

from metta_tpu_torch.sim.grid_objects import grid_objects, host_env

STATIC_OBJECT_TYPES = frozenset({"wall"})


def _format_object(obj: dict, actions, action_success, rewards, total_rewards) -> dict:
    out = {
        "id": obj["id"],
        "type_name": obj["type_name"],
        "location": obj["location"],
        "orientation": 0,
        "inventory": list(obj.get("inventory", {}).items()),
        "inventory_max": 0,
        "color": 0,
    }
    if "agent_id" in obj:
        a = obj["agent_id"]
        out["agent_id"] = a
        out["vision_size"] = 11
        out["action_id"] = int(actions[a])
        out["action_param"] = 0
        out["action_success"] = bool(action_success[a])
        out["current_reward"] = float(rewards[a])
        out["total_reward"] = float(total_rewards[a])
        out["freeze_remaining"] = obj.get("freeze_remaining", 0)
        out["is_frozen"] = obj.get("is_frozen", False)
        out["freeze_duration"] = obj.get("freeze_duration", 0)
        out["group_id"] = obj.get("group_id", 0)
        out["vibe_id"] = obj.get("vibe", 0)
        out["vibe"] = obj.get("vibe", 0)
    if "cooldown_remaining" in obj:
        out["cooldown_remaining"] = obj["cooldown_remaining"]
        out["cooldown_duration"] = obj.get("cooldown_duration", 0)
        out["is_clipped"] = obj.get("is_clipped", False)
        out["uses_count"] = obj.get("uses_count", 0)
        out["max_uses"] = obj.get("max_uses", 0)
    return out


class EpisodeReplay:
    """Accumulates one episode's replay (version 3)."""

    def __init__(self, env, env_cfg=None):
        compiled = env.compiled
        self.env = env
        self.compiled = compiled
        self.step = 0
        self.objects: list[dict[str, Any]] = []
        self._id_to_index: dict[int, int] = {}
        self.total_rewards = np.zeros(compiled.num_agents)
        self._compress = zlib.compress
        self.replay_data = {
            "version": 3,
            "action_names": list(compiled.action_names),
            "item_names": list(compiled.resource_names),
            "type_names": list(compiled.object_type_names),
            "map_size": [compiled.width, compiled.height],
            "num_agents": compiled.num_agents,
            "max_steps": compiled.max_steps,
            "mg_config": env_cfg.model_dump(mode="json") if env_cfg is not None else {},
            "objects": self.objects,
        }

    def set_compression(self, compression: str):
        if compression == "zlib":
            self._compress = zlib.compress
        elif compression == "gzip":
            self._compress = gzip.compress
        else:
            raise ValueError(f"unknown compression {compression!r}")

    def log_step(self, state, actions, action_success, rewards, e: int = 0):
        """state: the batched ``EnvState``; records env ``e``. ``actions``,
        ``action_success`` and ``rewards`` are env ``e``'s [A] tensors on
        the state's device."""
        host = host_env(state, e, _actions=actions, _success=action_success, _rewards=rewards)
        actions, action_success = host.pop("_actions"), host.pop("_success")
        rewards = host.pop("_rewards")
        self.total_rewards += rewards
        ignore = [] if self.step == 0 else list(STATIC_OBJECT_TYPES)
        objs = grid_objects(host, self.compiled, ignore_types=ignore)
        for obj_id, obj in objs.items():
            idx = self._id_to_index.get(obj_id)
            if idx is None:
                idx = len(self.objects)
                self._id_to_index[obj_id] = idx
                self.objects.append({})
            update = _format_object(obj, actions, action_success, rewards, self.total_rewards)
            self._merge(self.objects[idx], self.step, update)
        self.step += 1

    def _merge(self, grid_object: dict, step: int, update: dict):
        for key, value in update.items():
            if key not in grid_object:
                if step == 0:
                    grid_object[key] = [[step, value]]
                else:
                    grid_object[key] = [[0, 0], [step, value]]
            elif grid_object[key][-1][1] != value:
                grid_object[key].append([step, value])
        for key in grid_object:
            if key not in update and grid_object[key][-1][1] != 0:
                grid_object[key].append([step, 0])

    def get_replay_data(self) -> dict:
        self.replay_data["max_steps"] = self.step
        for grid_object in self.objects:
            for key, changes in list(grid_object.items()):
                if isinstance(changes, list) and len(changes) == 1 and len(changes[0]) == 2:
                    grid_object[key] = changes[0][1]
        return self.replay_data

    def write_replay(self, path: str | Path):
        data = json.dumps(self.get_replay_data(), default=_json_default).encode()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_bytes(self._compress(data))


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


class ReplayLogWriter:
    """Writes one ``.json.z`` per episode into a directory."""

    def __init__(self, replay_dir: str):
        self.replay_dir = Path(replay_dir)
        self.replay_dir.mkdir(parents=True, exist_ok=True)
        self._paths: list[str] = []

    def new_episode(self, env, env_cfg=None) -> EpisodeReplay:
        return EpisodeReplay(env, env_cfg)

    def finish_episode(self, replay: EpisodeReplay) -> str:
        path = self.replay_dir / f"{uuid.uuid4()}.json.z"
        replay.write_replay(path)
        self._paths.append(str(path))
        return str(path)

    def get_written_replay_paths(self) -> list[str]:
        return list(self._paths)
