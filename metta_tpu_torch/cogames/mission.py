"""Cogs-vs-Clips mission framework.

Parity: reference ``cogames/cogs_vs_clips/mission.py`` (Mission / Site /
MissionVariant) — a Mission owns the CvC economy knobs (station configs,
energy/cargo capacities, clip period) and produces a full MettaGridConfig;
variants mutate the mission and/or the produced env in sequence.

The port's own copy of ``metta_tpu/cogames/mission.py``.
"""

from __future__ import annotations

from abc import ABC
from typing import List, Optional

from pydantic import Field

from metta_tpu_torch.config.base import Config
from metta_tpu_torch.config import vibes as vibes_mod
from metta_tpu_torch.config.mettagrid_config import (
    ActionsConfig,
    AgentConfig,
    AgentRewards,
    ChangeVibeActionConfig,
    ClipperConfig,
    GameConfig,
    GlobalObsConfig,
    InventoryConfig,
    MettaGridConfig,
    MoveActionConfig,
    NoopActionConfig,
    ProtocolConfig,
    ResourceLimitsConfig,
    TransferActionConfig,
    VibeTransfer,
)
from metta_tpu_torch.cogames.stations import (
    RESOURCES,
    CarbonExtractorConfig,
    ChargerConfig,
    CvCAssemblerConfig,
    CvCChestConfig,
    CvCWallConfig,
    GermaniumExtractorConfig,
    OxygenExtractorConfig,
    SiliconExtractorConfig,
)

MAP_MISSION_DELIMITER = "."


class MissionVariant(Config, ABC):
    """A composable mission modifier (mission.py:42-80)."""

    name: str
    description: str = Field(default="")

    def modify_mission(self, mission: "Mission") -> None:
        pass

    def modify_env(self, mission: "Mission", env: MettaGridConfig) -> None:
        pass

    def compat(self, mission: "Mission") -> bool:
        return True

    def apply(self, mission: "Mission") -> "Mission":
        mission = mission.model_copy(deep=True)
        mission.variants.append(self)
        self.modify_mission(mission)
        return mission

    def as_mission(self, name: str, description: str, site: "Site") -> "Mission":
        return Mission(name=name, description=description, site=site,
                       variants=[self])


class NumCogsVariant(MissionVariant):
    name: str = "num_cogs"
    description: str = "Set the number of cogs for the mission."
    num_cogs: int

    def modify_mission(self, mission: "Mission") -> None:
        if not (mission.site.min_cogs <= self.num_cogs <= mission.site.max_cogs):
            raise ValueError(
                f"Invalid number of cogs for {mission.site.name}: "
                f"{self.num_cogs}; must be within "
                f"[{mission.site.min_cogs}, {mission.site.max_cogs}]"
            )
        mission.num_cogs = self.num_cogs


class Site(Config):
    name: str
    description: str
    map_builder: object
    min_cogs: int = Field(default=1, ge=1)
    max_cogs: int = Field(default=1000, ge=1)


class Mission(Config):
    """Mission configuration for Cogs vs Clips (mission.py:108-260)."""

    name: str
    description: str
    site: Site
    num_cogs: Optional[int] = None
    variants: List[MissionVariant] = Field(default_factory=list)

    carbon_extractor: CarbonExtractorConfig = Field(default_factory=CarbonExtractorConfig)
    oxygen_extractor: OxygenExtractorConfig = Field(default_factory=OxygenExtractorConfig)
    germanium_extractor: GermaniumExtractorConfig = Field(default_factory=GermaniumExtractorConfig)
    silicon_extractor: SiliconExtractorConfig = Field(default_factory=SiliconExtractorConfig)
    charger: ChargerConfig = Field(default_factory=ChargerConfig)
    chest: CvCChestConfig = Field(default_factory=CvCChestConfig)
    wall: CvCWallConfig = Field(default_factory=CvCWallConfig)
    assembler: CvCAssemblerConfig = Field(default_factory=CvCAssemblerConfig)

    clip_period: int = Field(default=0)
    cargo_capacity: int = Field(default=100)
    energy_capacity: int = Field(default=100)
    energy_regen_amount: int = Field(default=1)
    inventory_regen_interval: int = Field(default=1)
    gear_capacity: int = Field(default=5)
    move_energy_cost: int = Field(default=2)
    heart_capacity: int = Field(default=1)
    enable_vibe_change: bool = Field(default=True)
    vibes: Optional[list] = Field(default=None)
    compass_enabled: bool = Field(default=True)
    max_steps: int = Field(default=1000)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        for variant in self.variants:
            variant.modify_mission(self)

    def with_variants(self, variants: List[MissionVariant]) -> "Mission":
        mission = self
        for v in variants:
            mission = v.apply(mission)
        return mission

    def full_name(self) -> str:
        return f"{self.site.name}{MAP_MISSION_DELIMITER}{self.name}"

    @staticmethod
    def _set_spawn_counts(node, n: int) -> None:
        """Recursively align BaseHub-style spawn pads with num_cogs (the
        reference maps carry spawn markers; our scenes parameterize count)."""
        if node is None or not hasattr(node, "__dict__") and not hasattr(node, "model_fields"):
            return
        if hasattr(node, "spawn_count"):
            node.spawn_count = n
        for attr in ("instance", "scene"):
            child = getattr(node, attr, None)
            if child is not None:
                Mission._set_spawn_counts(child, n)
        for spec in getattr(node, "children", []) or []:
            Mission._set_spawn_counts(getattr(spec, "scene", None), n)

    def make_env(self) -> MettaGridConfig:
        num_cogs = self.num_cogs if self.num_cogs is not None else self.site.min_cogs
        vibe_list = (self.vibes if self.vibes is not None
                     else list(vibes_mod.VIBES))
        map_builder = self.site.map_builder.model_copy(deep=True)
        self._set_spawn_counts(map_builder, num_cogs)
        game = GameConfig(
            map_builder=map_builder,
            num_agents=num_cogs,
            max_steps=self.max_steps,
            resource_names=list(RESOURCES),
            global_obs=GlobalObsConfig(compass=self.compass_enabled,
                                       goal_obs=True),
            actions=ActionsConfig(
                move=MoveActionConfig(
                    consumed_resources={"energy": self.move_energy_cost}),
                noop=NoopActionConfig(),
                change_vibe=ChangeVibeActionConfig(
                    vibes=[] if not self.enable_vibe_change else vibe_list),
                transfer=TransferActionConfig(
                    enabled=True,
                    vibe_transfers=[VibeTransfer(
                        vibe="charger", target={"energy": 20},
                        actor={"energy": -20})],
                ),
            ),
            agent=AgentConfig(
                inventory=InventoryConfig(
                    limits={
                        "heart": ResourceLimitsConfig(
                            limit=self.heart_capacity, resources=["heart"]),
                        "energy": ResourceLimitsConfig(
                            limit=self.energy_capacity, resources=["energy"]),
                        "cargo": ResourceLimitsConfig(
                            limit=self.cargo_capacity,
                            resources=["carbon", "oxygen", "germanium", "silicon"]),
                        "gear": ResourceLimitsConfig(
                            limit=self.gear_capacity,
                            resources=["scrambler", "modulator", "decoder",
                                       "resonator"]),
                    },
                    initial={"energy": self.energy_capacity},
                    regen_amounts={"default": {"energy": self.energy_regen_amount}},
                ),
                rewards=AgentRewards(
                    stats={"chest.heart.deposited_by_agent": 1.0}),
                diversity_tracked_resources=[
                    "energy", "carbon", "oxygen", "germanium", "silicon", "heart"],
            ),
            inventory_regen_interval=self.inventory_regen_interval,
            clipper=ClipperConfig(
                unclipping_protocols=[
                    ProtocolConfig(input_resources={"decoder": 1}, cooldown=1),
                    ProtocolConfig(input_resources={"modulator": 1}, cooldown=1),
                    ProtocolConfig(input_resources={"scrambler": 1}, cooldown=1),
                    ProtocolConfig(input_resources={"resonator": 1}, cooldown=1),
                ],
                clip_period=self.clip_period,
            ),
            objects={
                "wall": self.wall.station_cfg(),
                "assembler": self.assembler.station_cfg(),
                "chest": self.chest.station_cfg(),
                "charger": self.charger.station_cfg(),
                "carbon_extractor": self.carbon_extractor.station_cfg(),
                "oxygen_extractor": self.oxygen_extractor.station_cfg(),
                "germanium_extractor": self.germanium_extractor.station_cfg(),
                "silicon_extractor": self.silicon_extractor.station_cfg(),
                # resource-specific chests for diagnostic missions (simplified
                # default-vibe transfers so restricted vibe sets still work) —
                # parity: cogs_vs_clips/mission.py:244-266
                **{
                    f"chest_{res}": self.chest.station_cfg().model_copy(
                        update={
                            "map_name": f"chest_{res}",
                            "vibe_transfers": {"default": {res: 255}},
                        }
                    )
                    for res in ("carbon", "oxygen", "germanium", "silicon")
                },
                # start-clipped extractor variants with unique map_names for
                # maps that explicitly place clipped stations — parity:
                # cogs_vs_clips/mission.py:268-283
                **{
                    f"clipped_{res}_extractor": getattr(self, f"{res}_extractor")
                    .model_copy(update={"start_clipped": True})
                    .station_cfg()
                    .model_copy(update={"map_name": f"clipped_{res}_extractor"})
                    for res in ("carbon", "oxygen", "germanium", "silicon")
                },
            },
        )
        env = MettaGridConfig(label=self.full_name(), game=game)
        for variant in self.variants:
            variant.modify_env(self, env)
        return env
