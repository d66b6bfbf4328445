"""Cogs-vs-Clips station configs.

Parity: reference ``packages/cogames/src/cogames/cogs_vs_clips/stations.py``
(240 LoC) — the CvC resource economy's station generators with
efficiency/synergy/max_uses knobs and the exact output formulas:
charger 50·eff% energy (partial-usage), carbon 2·eff% per use (25 uses),
oxygen fixed 10 with 10000/eff cooldown (5 uses, partial), germanium fixed 2
with 20000/eff cooldown + 50 synergy (5 uses), silicon 15·eff% for 20 energy
(10 uses), chest vibe-keyed deposits/withdrawals, assembler heart protocols
(first 10 + 5 per extra heart-vibe participant) + gear recipes.

The port's own copy of ``metta_tpu/cogames/stations.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

from pydantic import Field

from metta_tpu_torch.config.base import Config
from metta_tpu_torch.config.mettagrid_config import (
    AssemblerConfig,
    ChestConfig,
    InventoryConfig,
    ProtocolConfig,
    WallConfig,
)
from metta_tpu_torch.config.vibes import VIBE_BY_NAME

RESOURCES = [
    "energy",
    "carbon",
    "oxygen",
    "germanium",
    "silicon",
    "heart",
    "decoder",
    "modulator",
    "resonator",
    "scrambler",
]

GEAR_RECIPES = [
    ("carbon", "decoder"),
    ("oxygen", "modulator"),
    ("germanium", "scrambler"),
    ("silicon", "resonator"),
]


def _sym(name: str) -> str:
    v = VIBE_BY_NAME.get(name)
    return v.symbol if v is not None else "?"


class CvCStationConfig(Config):
    start_clipped: bool = Field(default=False)
    clip_immune: bool = Field(default=False)

    def station_cfg(self):
        raise NotImplementedError


class CvCWallConfig(CvCStationConfig):
    def station_cfg(self) -> WallConfig:
        return WallConfig(name="wall", render_symbol=_sym("wall"))


class ExtractorConfig(CvCStationConfig):
    """Base extractor: efficiency scales output or cooldown; synergy scales
    output with additional participating agents."""

    efficiency: int = Field(ge=1, le=500, default=100)
    synergy: int = Field(default=0)
    max_uses: int = Field(default=0)

    def _protocols(self, output_of, cooldown: int = 0,
                   inputs: Optional[Dict[str, int]] = None):
        return [
            ProtocolConfig(
                min_agents=(extra + 1) if extra >= 1 else 0,
                input_resources=dict(inputs or {}),
                output_resources=output_of(extra),
                cooldown=cooldown,
            )
            for extra in range(4)
        ]


class ChargerConfig(ExtractorConfig):
    max_uses: int = 0

    def station_cfg(self) -> AssemblerConfig:
        output = 50 * self.efficiency // 100
        return AssemblerConfig(
            name="charger", render_symbol=_sym("charger"),
            allow_partial_usage=True, max_uses=self.max_uses,
            protocols=self._protocols(
                lambda extra: {"energy": output * (100 + extra * self.synergy) // 100},
                cooldown=10,
            ),
            start_clipped=self.start_clipped, clip_immune=self.clip_immune,
        )


class CarbonExtractorConfig(ExtractorConfig):
    """Time consuming but easy to mine."""

    max_uses: int = Field(default=25)

    def station_cfg(self) -> AssemblerConfig:
        output = 2 * self.efficiency // 100
        return AssemblerConfig(
            name="carbon_extractor", render_symbol=_sym("carbon_a"),
            max_uses=self.max_uses,
            protocols=self._protocols(
                lambda extra: {"carbon": output * (100 + extra * self.synergy) // 100},
            ),
            start_clipped=self.start_clipped, clip_immune=self.clip_immune,
        )


class OxygenExtractorConfig(ExtractorConfig):
    """Accumulates over time (efficiency shortens the cooldown)."""

    max_uses: int = Field(default=5)

    def station_cfg(self) -> AssemblerConfig:
        return AssemblerConfig(
            name="oxygen_extractor", render_symbol=_sym("oxygen_a"),
            max_uses=self.max_uses, allow_partial_usage=True,
            protocols=self._protocols(
                lambda extra: {"oxygen": 10 * (100 + extra * self.synergy) // 100},
                cooldown=int(10_000 / self.efficiency),
            ),
            start_clipped=self.start_clipped, clip_immune=self.clip_immune,
        )


class GermaniumExtractorConfig(ExtractorConfig):
    """Rare, regenerates slowly; more cogs extract more."""

    max_uses: int = Field(default=5)
    synergy: int = 50

    def station_cfg(self) -> AssemblerConfig:
        return AssemblerConfig(
            name="germanium_extractor", render_symbol=_sym("germanium_a"),
            max_uses=self.max_uses,
            protocols=self._protocols(
                lambda extra: {"germanium": 2 * (100 + extra * self.synergy) // 100},
                cooldown=int(20_000 / self.efficiency),
            ),
            start_clipped=self.start_clipped, clip_immune=self.clip_immune,
        )


class SiliconExtractorConfig(ExtractorConfig):
    """Bulky and energy intensive."""

    max_uses: int = Field(default=10)

    def station_cfg(self) -> AssemblerConfig:
        output = 15 * self.efficiency // 100
        return AssemblerConfig(
            name="silicon_extractor", render_symbol=_sym("silicon_a"),
            max_uses=self.max_uses,
            protocols=self._protocols(
                lambda extra: {"silicon": output * (100 + extra * self.synergy) // 100},
                inputs={"energy": 20},
            ),
            start_clipped=self.start_clipped, clip_immune=self.clip_immune,
        )


class CvCChestConfig(CvCStationConfig):
    initial_inventory: Dict[str, int] = Field(default_factory=dict)

    def station_cfg(self) -> ChestConfig:
        return ChestConfig(
            name="chest", render_symbol=_sym("chest"),
            vibe_transfers={
                "default": {"heart": 255, "carbon": 255, "oxygen": 255,
                            "germanium": 255, "silicon": 255},
                "heart_a": {"heart": 0},
                "heart_b": {"heart": 1},
                "carbon_a": {"carbon": -10},
                "carbon_b": {"carbon": 10},
                "oxygen_a": {"oxygen": -10},
                "oxygen_b": {"oxygen": 10},
                "germanium_a": {"germanium": -1},
                "germanium_b": {"germanium": 1},
                "silicon_a": {"silicon": -25},
                "silicon_b": {"silicon": 25},
            },
            inventory=InventoryConfig(initial=dict(self.initial_inventory)),
        )


class CvCAssemblerConfig(CvCStationConfig):
    first_heart_cost: int = Field(default=10)
    additional_heart_cost: int = Field(default=5)

    def station_cfg(self) -> AssemblerConfig:
        heart_protos = [
            ProtocolConfig(
                vibes=["heart_a"] * (i + 1),
                input_resources={
                    "carbon": self.first_heart_cost + self.additional_heart_cost * i,
                    "oxygen": self.first_heart_cost + self.additional_heart_cost * i,
                    "germanium": max(
                        1, (self.first_heart_cost + self.additional_heart_cost * i) // 5),
                    "silicon": 3 * (self.first_heart_cost + self.additional_heart_cost * i),
                },
                output_resources={"heart": i + 1},
            )
            for i in range(4)
        ]
        gear_protos = [
            ProtocolConfig(
                vibes=["gear", f"{res}_a"],
                input_resources={res: 1},
                output_resources={tool: 1},
            )
            for res, tool in GEAR_RECIPES
        ]
        return AssemblerConfig(
            name="assembler", render_symbol=_sym("assembler"),
            clip_immune=True,
            protocols=heart_protos + gear_protos,
        )
