"""Cogs-vs-Clips mission variants.

Parity: reference ``cogames/cogs_vs_clips/variants.py`` (759 LoC) — the
catalog of composable mission modifiers used by the missions/evals layers.

The port's own copy of ``metta_tpu/cogames/variants.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from metta_tpu_torch.config.mettagrid_config import (
    AssemblerConfig,
    ChestConfig,
    MettaGridConfig,
    ProtocolConfig,
    ResourceLimitsConfig,
)
from metta_tpu_torch.cogames.mission import Mission, MissionVariant


class MinedOutVariant(MissionVariant):
    name: str = "mined_out"
    description: str = "All resources are depleted. You must be efficient to survive."

    def modify_mission(self, mission: Mission) -> None:
        mission.carbon_extractor.max_uses = 2
        mission.oxygen_extractor.max_uses = 2
        mission.silicon_extractor.max_uses = 2


class DarkSideVariant(MissionVariant):
    name: str = "dark_side"
    description: str = "You're on the dark side of the asteroid. You recharge slower."

    def modify_mission(self, mission: Mission) -> None:
        mission.energy_regen_amount = 0


class LonelyHeartVariant(MissionVariant):
    name: str = "lonely_heart"
    description: str = "Making hearts for one agent is easy."

    def modify_mission(self, mission: Mission) -> None:
        mission.assembler.first_heart_cost = 1
        mission.assembler.additional_heart_cost = 0
        mission.heart_capacity = max(mission.heart_capacity, 255)

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        simplified = {"carbon": 1, "oxygen": 1, "germanium": 1, "silicon": 1,
                      "energy": 1}
        assembler = env.game.objects["assembler"]
        for i, proto in enumerate(assembler.protocols):
            if proto.output_resources.get("heart", 0) == 0:
                continue
            p = proto.model_copy(deep=True)
            p.input_resources = dict(simplified)
            assembler.protocols[i] = p
        germanium = env.game.objects["germanium_extractor"]
        germanium.max_uses = 0
        new_protos = []
        for proto in germanium.protocols:
            p = proto.model_copy(deep=True)
            out = dict(p.output_resources)
            out["germanium"] = max(out.get("germanium", 0), 1)
            p.output_resources = out
            p.cooldown = max(p.cooldown, 1)
            new_protos.append(p)
        germanium.protocols = new_protos


class SuperChargedVariant(MissionVariant):
    name: str = "super_charged"
    description: str = "The sun is shining on you. You recharge faster."

    def modify_mission(self, mission: Mission) -> None:
        mission.energy_regen_amount += 2


class RoughTerrainVariant(MissionVariant):
    name: str = "rough_terrain"
    description: str = "The terrain is rough. Moving is more energy intensive."

    def modify_mission(self, mission: Mission) -> None:
        mission.move_energy_cost += 2


class SolarFlareVariant(MissionVariant):
    name: str = "solar_flare"
    description: str = "Chargers have been damaged by the solar flare."

    def modify_mission(self, mission: Mission) -> None:
        mission.charger.efficiency = max(1, mission.charger.efficiency - 50)


class TrainingVariant(MissionVariant):
    name: str = "training"
    description: str = ("Training-friendly: max cargo, fast extractors, chest "
                        "only deposits hearts.")

    def modify_mission(self, mission: Mission) -> None:
        mission.cargo_capacity = 255

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        for name in ("carbon_extractor", "oxygen_extractor",
                     "germanium_extractor", "silicon_extractor"):
            ex = env.game.objects.get(name)
            if isinstance(ex, AssemblerConfig):
                ex.protocols = [
                    p.model_copy(update={"cooldown": 5}) for p in ex.protocols
                ]
        chest = env.game.objects.get("chest")
        if isinstance(chest, ChestConfig):
            chest.vibe_transfers = {
                "heart_b": {"heart": 1},
                "carbon_a": {"carbon": -10}, "carbon_b": {"carbon": 10},
                "oxygen_a": {"oxygen": -10}, "oxygen_b": {"oxygen": 10},
                "germanium_a": {"germanium": -1}, "germanium_b": {"germanium": 1},
                "silicon_a": {"silicon": -25}, "silicon_b": {"silicon": 25},
            }


class PackRatVariant(MissionVariant):
    name: str = "pack_rat"
    description: str = "Raise heart, cargo, energy, and gear caps to 255."

    def modify_mission(self, mission: Mission) -> None:
        mission.heart_capacity = max(mission.heart_capacity, 255)
        mission.energy_capacity = max(mission.energy_capacity, 255)
        mission.cargo_capacity = max(mission.cargo_capacity, 255)
        mission.gear_capacity = max(mission.gear_capacity, 255)


class EnergizedVariant(MissionVariant):
    name: str = "energized"
    description: str = "Max energy and full regen so agents never run dry."

    def modify_mission(self, mission: Mission) -> None:
        mission.energy_capacity = max(mission.energy_capacity, 255)
        mission.energy_regen_amount = mission.energy_capacity


class ResourceBottleneckVariant(MissionVariant):
    name: str = "resource_bottleneck"
    description: str = "A resource is the limiting factor."
    resource: Union[Sequence[str], str] = ("oxygen", "germanium", "silicon",
                                           "carbon")

    def modify_mission(self, mission: Mission) -> None:
        names = [self.resource] if isinstance(self.resource, str) else list(self.resource)
        for resource in names:
            if resource in {"carbon", "oxygen", "germanium", "silicon"}:
                attr = f"{resource}_extractor"
            elif resource == "energy":
                attr = "charger"
            else:
                raise ValueError(f"Unsupported bottleneck resource: {resource}")
            station = getattr(mission, attr)
            station.efficiency = max(1, int(station.efficiency) - 50)


class SingleToolUnclipVariant(MissionVariant):
    name: str = "single_tool_unclip"
    description: str = "Only one tool is available: the decoder."
    resource: str = "carbon"

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        assembler = env.game.objects.get("assembler")
        if isinstance(assembler, AssemblerConfig):
            assembler.protocols = [ProtocolConfig(
                vibes=[], input_resources={self.resource: 1},
                output_resources={"decoder": 1})]


class CompassVariant(MissionVariant):
    name: str = "compass"
    description: str = "Enable the compass observation."

    def modify_mission(self, mission: Mission) -> None:
        mission.compass_enabled = True


class HeartChorusVariant(MissionVariant):
    name: str = "heart_chorus"
    description: str = "Heart-centric reward shaping with gentle resource bonuses."

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        rewards = dict(env.game.agent.rewards.stats)
        rewards.update({
            "assembler.heart.created": 1.0,
            "chest.heart.deposited_by_agent": 1.0,
            "chest.heart.withdrawn_by_agent": -1.0,
            "inventory.diversity.ge.2": 0.17,
            "inventory.diversity.ge.3": 0.18,
            "inventory.diversity.ge.4": 0.60,
            "inventory.diversity.ge.5": 0.97,
        })
        env.game.agent.rewards.stats = rewards


class TinyHeartProtocolsVariant(MissionVariant):
    name: str = "tiny_heart_protocols"
    description: str = "Prepend low-cost heart assembler protocols."
    carbon_cost: int = 2
    oxygen_cost: int = 2
    germanium_cost: int = 1
    silicon_cost: int = 3
    energy_cost: int = 2

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        assembler = env.game.objects["assembler"]
        tiny_inputs = {
            "carbon": self.carbon_cost, "oxygen": self.oxygen_cost,
            "germanium": self.germanium_cost, "silicon": self.silicon_cost,
            "energy": self.energy_cost,
        }
        tiny = [
            ProtocolConfig(vibes=[vibe] * (i + 1),
                           input_resources=tiny_inputs,
                           output_resources={"heart": i + 1})
            for vibe in ("heart_a", "red-heart")
            for i in range(4)
        ]
        keys = {(tuple(p.vibes), p.min_agents) for p in tiny}
        existing = [p for p in assembler.protocols
                    if (tuple(p.vibes), p.min_agents) not in keys]
        assembler.protocols = [*tiny, *existing]


class VibeCheckMin2Variant(MissionVariant):
    name: str = "vibe_check_min_2"
    description: str = "Require at least 2 heart vibes to craft a heart."
    min_vibes: int = 2

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        assembler = env.game.objects["assembler"]
        kept: List[ProtocolConfig] = []
        for proto in assembler.protocols:
            if proto.output_resources.get("heart", 0) == 0:
                kept.append(proto)
            elif (len(proto.vibes) >= self.min_vibes
                  and all(v == "heart_a" for v in proto.vibes)):
                kept.append(proto)
        assembler.protocols = kept


class Small50Variant(MissionVariant):
    name: str = "small_50"
    description: str = "Set map size to 50x50 for quick runs."

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        mb = env.game.map_builder
        if hasattr(mb, "width") and hasattr(mb, "height"):
            env.game.map_builder = mb.model_copy(
                update={"width": 50, "height": 50})


class InventoryHeartTuneVariant(MissionVariant):
    name: str = "inventory_heart_tune"
    description: str = "Start agents with N hearts worth of inputs."
    hearts: int = 1
    heart_capacity: Optional[int] = None

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        hearts = max(0, int(self.hearts))
        if hearts == 0 and self.heart_capacity is None:
            return
        cost = mission.assembler.first_heart_cost
        per_heart = {"carbon": cost, "oxygen": cost,
                     "germanium": max(cost // 10, 1), "silicon": 3 * cost,
                     "energy": 0}
        agent = env.game.agent
        if hearts > 0:
            agent.inventory.initial = dict(agent.inventory.initial)
            for rn, amt in per_heart.items():
                cur = int(agent.inventory.initial.get(rn, 0))
                cap = agent.inventory.get_limit(rn)
                agent.inventory.initial[rn] = min(cap, cur + amt * hearts)
        if self.heart_capacity is not None:
            lim = agent.inventory.limits.get("heart")
            if lim is None:
                lim = ResourceLimitsConfig(limit=self.heart_capacity,
                                           resources=["heart"])
            lim.limit = max(int(lim.limit), int(self.heart_capacity))
            agent.inventory.limits["heart"] = lim


class ChestHeartTuneVariant(MissionVariant):
    name: str = "chest_heart_tune"
    description: str = "Seed the chest with N hearts worth of inputs."
    hearts: int = 2

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        hearts = max(0, int(self.hearts))
        if hearts == 0:
            return
        cost = mission.assembler.first_heart_cost
        per_heart = {"carbon": cost, "oxygen": cost,
                     "germanium": max(cost // 10, 1), "silicon": 3 * cost}
        chest = env.game.objects["chest"]
        start = dict(chest.inventory.initial)
        for k, v in per_heart.items():
            start[k] = start.get(k, 0) + v * hearts
        chest.inventory.initial = start


class ExtractorHeartTuneVariant(MissionVariant):
    name: str = "extractor_heart_tune"
    description: str = "Tune extractor uses for N hearts of production."
    hearts: int = 1

    def modify_mission(self, mission: Mission) -> None:
        hearts = max(0, int(self.hearts))
        if hearts == 0:
            return
        cost = mission.assembler.first_heart_cost
        one = {"carbon": cost, "oxygen": cost,
               "germanium": max(cost // 10, 1), "silicon": 3 * cost}
        carbon_per_use = max(1, 4 * mission.carbon_extractor.efficiency // 100)
        mission.carbon_extractor.max_uses = -(-one["carbon"] * hearts // carbon_per_use)
        mission.oxygen_extractor.max_uses = -(-one["oxygen"] * hearts // 20)
        silicon_per_use = max(1, int(25 * mission.silicon_extractor.efficiency // 100))
        silicon_uses = -(-one["silicon"] * hearts // silicon_per_use)
        mission.silicon_extractor.max_uses = max(1, silicon_uses * 10)
        mission.germanium_extractor.efficiency = int(one["germanium"] * hearts)


class CyclicalUnclipVariant(MissionVariant):
    name: str = "cyclical_unclip"
    description: str = "Unclip recipes are cyclical across resource families."

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        if env.game.clipper is not None:
            env.game.clipper.unclipping_protocols = [
                ProtocolConfig(input_resources={"scrambler": 1}, cooldown=1),
                ProtocolConfig(input_resources={"resonator": 1}, cooldown=1),
                ProtocolConfig(input_resources={"modulator": 1}, cooldown=1),
                ProtocolConfig(input_resources={"decoder": 1}, cooldown=1),
            ]


class ClipHubStationsVariant(MissionVariant):
    name: str = "clip_hub_stations"
    description: str = "Clip the specified base stations (by name)."
    clip: List[str] = ["carbon_extractor", "oxygen_extractor",
                       "germanium_extractor", "silicon_extractor", "charger"]

    def modify_mission(self, mission: Mission) -> None:
        for station_name in self.clip:
            station = getattr(mission, station_name, None)
            if station is not None:
                station.start_clipped = True


class ClipPeriodOnVariant(MissionVariant):
    name: str = "clip_period_on"
    description: str = "Enable global clipping with a small clip period."
    clip_period: int = 50

    def modify_mission(self, mission: Mission) -> None:
        mission.clip_period = self.clip_period


class AssemblerDrawsFromChestsVariant(MissionVariant):
    name: str = "assembler_draws_from_chests"
    description: str = "Assembler can consume inputs from nearby chests."
    distance: int = 2

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        assembler = env.game.objects["assembler"]
        if isinstance(assembler, AssemblerConfig):
            assembler.chest_search_distance = self.distance


class SharedRewardsVariant(MissionVariant):
    name: str = "shared_rewards"
    description: str = "Reward the whole team for chest deposits."

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        rewards = dict(env.game.agent.rewards.stats)
        rewards.pop("chest.heart.deposited_by_agent", None)
        rewards["chest.heart.deposited"] = 1.0
        env.game.agent.rewards.stats = rewards


class BalancedCornersVariant(MissionVariant):
    name: str = "balanced_corners"
    description: str = "Place one extractor of each type in the hub corners."

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        # mapgen-level concern; kept as a marker for map builders that read it
        pass


VARIANTS = {
    v.model_fields["name"].default: v
    for v in (
        MinedOutVariant, DarkSideVariant, LonelyHeartVariant,
        SuperChargedVariant, RoughTerrainVariant, SolarFlareVariant,
        TrainingVariant, PackRatVariant, EnergizedVariant,
        ResourceBottleneckVariant, SingleToolUnclipVariant, CompassVariant,
        HeartChorusVariant, TinyHeartProtocolsVariant, VibeCheckMin2Variant,
        Small50Variant, InventoryHeartTuneVariant, ChestHeartTuneVariant,
        ExtractorHeartTuneVariant, CyclicalUnclipVariant,
        ClipHubStationsVariant, ClipPeriodOnVariant,
        AssemblerDrawsFromChestsVariant, SharedRewardsVariant,
        BalancedCornersVariant,
    )
}
