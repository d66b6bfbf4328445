"""Procedural map variants for CoGames missions, the port's own copy of
``metta_tpu/cogames/procedural.py``.

Parity: reference ``cogames/cogs_vs_clips/procedural.py:550-645`` — variants
that reach into a mission's MapGen node and mutate the generator config
(seed pinning, hub knobs, arena composition) without touching the game rules.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

from metta_tpu_torch.cogames.mission import Mission, MissionVariant
from metta_tpu_torch.config.mettagrid_config import MettaGridConfig
from metta_tpu_torch.mapgen.mapgen import MapGen
from metta_tpu_torch.mapgen.scenes_arena import MachinaArena
from metta_tpu_torch.mapgen.scenes_structures import BaseHub


class EnvNodeVariant(MissionVariant, ABC):
    """Variant that modifies one node of the env's map-builder config tree."""

    @abstractmethod
    def extract_node(self, env: MettaGridConfig): ...

    @abstractmethod
    def modify_node(self, node) -> None: ...

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        self.modify_node(self.extract_node(env))


class MapGenVariant(EnvNodeVariant):
    def extract_node(self, env: MettaGridConfig):
        mb = env.game.map_builder
        if not isinstance(mb, MapGen.Config):
            raise TypeError("MapGenVariant needs a MapGen.Config builder")
        return mb


class MapSeedVariant(MapGenVariant):
    """Pin the MapGen seed for deterministic generation (procedural.py:572)."""

    name: str = "map_seed"
    description: str = "Set MapGen seed for deterministic map generation."
    seed: int

    def modify_node(self, node) -> None:
        node.seed = int(self.seed)


class BaseHubVariant(EnvNodeVariant):
    """Mutate the mission's BaseHub scene — directly, or inside a
    MachinaArena composition (procedural.py:591-617)."""

    name: str = "base_hub"
    description: str = "Override home-base hub knobs."
    updates: Dict[str, Any]

    def compat(self, mission: Mission) -> bool:
        try:
            self.extract_node(mission.make_env())
            return True
        except TypeError:
            return False

    def extract_node(self, env: MettaGridConfig):
        mb = env.game.map_builder
        if isinstance(mb, MapGen.Config):
            inst = mb.instance
            if isinstance(inst, BaseHub.Config):
                return inst
            if isinstance(inst, MachinaArena.Config):
                if inst.hub is None:
                    inst.hub = BaseHub.Config(
                        corner_bundle="extractors", cross_bundle="none",
                        cross_distance=7,
                    )
                return inst.hub
        raise TypeError("BaseHubVariant needs a BaseHub or MachinaArena scene")

    def modify_node(self, node) -> None:
        for k, v in self.updates.items():
            setattr(node, k, v)


class MachinaArenaVariant(EnvNodeVariant):
    """Mutate the MachinaArena composition knobs (procedural.py:620-631)."""

    name: str = "machina_arena"
    description: str = "Override procedural-arena composition knobs."
    updates: Dict[str, Any]

    def compat(self, mission: Mission) -> bool:
        env = mission.make_env()
        mb = env.game.map_builder
        return isinstance(mb, MapGen.Config) and isinstance(
            mb.instance, MachinaArena.Config
        )

    def extract_node(self, env: MettaGridConfig):
        mb = env.game.map_builder
        assert isinstance(mb, MapGen.Config)
        assert isinstance(mb.instance, MachinaArena.Config)
        return mb.instance

    def modify_node(self, node) -> None:
        for k, v in self.updates.items():
            setattr(node, k, v)
