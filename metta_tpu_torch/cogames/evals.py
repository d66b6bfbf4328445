"""Cogs-vs-Clips evaluation mission suites.

Parity: reference ``cogames/cogs_vs_clips/evals/`` — diagnostic missions
(single-skill probes: navigate-and-deposit, seeded assembly, single-missing-
resource extraction, unclip drills) and a spanning set over sites × variant
stresses. Diagnostic maps here are small BaseHub arenas with the probe's
inventory seeding / assembler tuning applied as env modifiers.

The port's own copy of ``metta_tpu/cogames/evals.py``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional

from pydantic import Field

from metta_tpu_torch.cogames.mission import Mission, MissionVariant, Site
from metta_tpu_torch.cogames.sites import EVALS, HELLO_WORLD, TRAINING_FACILITY
from metta_tpu_torch.cogames.variants import (
    ClipHubStationsVariant,
    ClipPeriodOnVariant,
    CyclicalUnclipVariant,
    DarkSideVariant,
    EnergizedVariant,
    ExtractorHeartTuneVariant,
    InventoryHeartTuneVariant,
    LonelyHeartVariant,
    PackRatVariant,
    ResourceBottleneckVariant,
    RoughTerrainVariant,
    SingleToolUnclipVariant,
    SuperChargedVariant,
    VibeCheckMin2Variant,
)

RESOURCE_NAMES = ("carbon", "oxygen", "germanium", "silicon")


class _SeedInventoryVariant(MissionVariant):
    """Give every agent a starting inventory (diagnostic seeding)."""

    name: str = "seed_inventory"
    seed: Dict[str, int] = Field(default_factory=dict)

    def modify_env(self, mission: Mission, env) -> None:
        initial = dict(env.game.agent.inventory.initial)
        for rn, amt in self.seed.items():
            cap = env.game.agent.inventory.get_limit(rn)
            initial[rn] = min(cap, initial.get(rn, 0) + amt)
        env.game.agent.inventory.initial = initial


class _MaxStepsVariant(MissionVariant):
    name: str = "max_steps"
    steps: int = 250

    def modify_mission(self, mission: Mission) -> None:
        mission.max_steps = self.steps


def _diagnostic(name: str, description: str,
                seed: Optional[Dict[str, int]] = None,
                max_steps: int = 250, num_cogs: int = 1,
                extra: Optional[List[MissionVariant]] = None) -> Mission:
    variants: List[MissionVariant] = [_MaxStepsVariant(steps=max_steps)]
    if seed:
        # seeding hearts needs headroom in the heart cap
        if "heart" in seed:
            variants.append(PackRatVariant())
        variants.append(_SeedInventoryVariant(seed=seed))
    variants.extend(extra or [])
    return Mission(name=name, description=description, site=EVALS,
                   num_cogs=num_cogs, variants=variants)


ASSEMBLY_SEED = {"carbon": 2, "oxygen": 2, "germanium": 1, "silicon": 3}


@lru_cache(maxsize=1)
def get_diagnostic_missions() -> List[Mission]:
    missions = [
        _diagnostic("diagnostic_chest_navigation1",
                    "Navigate to the chest and deposit a heart.",
                    seed={"heart": 1}),
        _diagnostic("diagnostic_chest_navigation2",
                    "Navigate through obstacles to deposit a heart.",
                    seed={"heart": 1}),
        _diagnostic("diagnostic_chest_deposit_near",
                    "Deposit a carried heart into a nearby chest.",
                    seed={"heart": 1}),
        _diagnostic("diagnostic_chest_deposit_search",
                    "Find the chest outside the initial FOV and deposit.",
                    seed={"heart": 1}),
        _diagnostic("diagnostic_assemble_seeded_near",
                    "Agents pre-seeded; chorus HEART near the assembler.",
                    seed=ASSEMBLY_SEED, max_steps=50,
                    extra=[LonelyHeartVariant()]),
        _diagnostic("diagnostic_assemble_seeded_search",
                    "Agents pre-seeded; locate the assembler and chorus.",
                    seed=ASSEMBLY_SEED, max_steps=150,
                    extra=[LonelyHeartVariant()]),
        _diagnostic("diagnostic_unclip_drill",
                    "Unclip the base stations with a single tool.",
                    seed={"carbon": 2}, max_steps=200,
                    extra=[ClipHubStationsVariant(),
                           SingleToolUnclipVariant()]),
    ]
    # one single-missing-resource probe per resource
    for rn in RESOURCE_NAMES:
        seed = {k: v for k, v in ASSEMBLY_SEED.items() if k != rn}
        missions.append(_diagnostic(
            f"diagnostic_extract_missing_{rn}",
            f"All inputs but {rn} are seeded; extract it and assemble.",
            seed=seed, max_steps=130, extra=[LonelyHeartVariant()],
        ))
    return missions


@lru_cache(maxsize=1)
def get_spanning_missions() -> List[Mission]:
    """Spanning stress set over sites × variant combinations
    (evals/spanning_evals.py)."""
    combos = [
        ("span_base", []),
        ("span_dark_side", [DarkSideVariant()]),
        ("span_super_charged", [SuperChargedVariant()]),
        ("span_rough_terrain", [RoughTerrainVariant()]),
        ("span_energized", [EnergizedVariant()]),
        ("span_bottleneck_oxygen", [ResourceBottleneckVariant(resource="oxygen")]),
        ("span_bottleneck_germanium",
         [ResourceBottleneckVariant(resource="germanium")]),
        ("span_vibe_check", [VibeCheckMin2Variant()]),
        ("span_clipped", [ClipPeriodOnVariant(), ClipHubStationsVariant()]),
        ("span_cyclical_unclip", [ClipPeriodOnVariant(), CyclicalUnclipVariant()]),
        ("span_pack_rat_tuned", [PackRatVariant(),
                                 ExtractorHeartTuneVariant(hearts=5)]),
        ("span_seeded_hearts", [InventoryHeartTuneVariant(hearts=2)]),
    ]
    missions = []
    for name, variants in combos:
        missions.append(Mission(
            name=name,
            description=f"Spanning eval: {name[5:].replace('_', ' ')}.",
            site=TRAINING_FACILITY,
            variants=list(variants),
        ))
    missions.append(Mission(
        name="span_open_world",
        description="Spanning eval: open-world hello world.",
        site=HELLO_WORLD,
        num_cogs=4,
    ))
    return missions


def get_eval_missions() -> List[Mission]:
    return [*get_diagnostic_missions(), *get_spanning_missions()]
