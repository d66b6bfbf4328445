"""Cogs-vs-Clips mission catalog + tutorial.

Parity: reference ``cogames/cogs_vs_clips/missions.py`` (core catalog) +
``tutorial_missions.py`` — the named missions a player/trainer selects from.

The port's own copy of ``metta_tpu/cogames/catalog.py``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

from metta_tpu_torch.cogames.mission import Mission, MissionVariant
from metta_tpu_torch.cogames.sites import HELLO_WORLD, MACHINA_1, TRAINING_FACILITY
from metta_tpu_torch.cogames.variants import (
    AssemblerDrawsFromChestsVariant,
    BalancedCornersVariant,
    ClipHubStationsVariant,
    ClipPeriodOnVariant,
    ExtractorHeartTuneVariant,
    HeartChorusVariant,
    InventoryHeartTuneVariant,
    LonelyHeartVariant,
    PackRatVariant,
    SharedRewardsVariant,
    VibeCheckMin2Variant,
)

# --- tutorial (tutorial_missions.py) ---------------------------------------


class TutorialVariant(MissionVariant):
    name: str = "tutorial_mode"
    description: str = "High energy regen for learning."

    def modify_mission(self, mission: Mission) -> None:
        mission.energy_regen_amount = 1

    def modify_env(self, mission: Mission, env) -> None:
        env.game.max_steps = max(env.game.max_steps, 1000)


TutorialMission = Mission(
    name="tutorial",
    description="Learn the basics of CoGames: Gather, Craft, and Deposit.",
    site=TRAINING_FACILITY,
    variants=[TutorialVariant()],
)

# --- training facility ------------------------------------------------------

HarvestMission = Mission(
    name="harvest",
    description="Collect resources, assemble hearts, and deposit them in "
                "the chest. Make sure to stay charged!",
    site=TRAINING_FACILITY,
    variants=[ExtractorHeartTuneVariant(hearts=10), PackRatVariant(),
              LonelyHeartVariant()],
)

VibeCheckMission = Mission(
    name="vibe_check",
    description="Modulate the group vibe to assemble HEARTs.",
    site=TRAINING_FACILITY,
    num_cogs=4,
    variants=[VibeCheckMin2Variant(), ExtractorHeartTuneVariant(hearts=10)],
)

RepairMission = Mission(
    name="repair",
    description="Repair disabled stations to restore their functionality.",
    site=TRAINING_FACILITY,
    num_cogs=2,
    variants=[
        InventoryHeartTuneVariant(hearts=1),
        ExtractorHeartTuneVariant(hearts=10),
        LonelyHeartVariant(),
        ClipPeriodOnVariant(),
        ClipHubStationsVariant(),
    ],
)

EasyHeartsTrainingMission = Mission(
    name="easy_hearts_training_facility",
    description="Simplified heart crafting with generous caps.",
    site=TRAINING_FACILITY,
    variants=[LonelyHeartVariant(), HeartChorusVariant(), PackRatVariant()],
)

EasyHeartsHelloWorldMission = Mission(
    name="easy_hearts_hello_world",
    description="Simplified heart crafting with generous caps, big map.",
    site=HELLO_WORLD,
    variants=[LonelyHeartVariant(), HeartChorusVariant(), PackRatVariant()],
)

# --- hello world / machina --------------------------------------------------

HelloWorldOpenWorldMission = Mission(
    name="open_world",
    description="Collect resources and assemble HEARTs.",
    site=HELLO_WORLD,
)

HelloWorldUnclipMission = Mission(
    name="hello_world_unclip",
    description="Stabilize clipped extractors across the sector.",
    site=HELLO_WORLD,
    num_cogs=4,
    variants=[ClipPeriodOnVariant(), InventoryHeartTuneVariant(hearts=1),
              ClipHubStationsVariant()],
)

Machina1OpenWorldMission = Mission(
    name="open_world",
    description="Collect resources and assemble HEARTs.",
    site=MACHINA_1,
)

Machina1OpenWorldWithChestsMission = Mission(
    name="open_world_with_chests",
    description="Assembler can draw inputs from nearby chests.",
    site=MACHINA_1,
    variants=[AssemblerDrawsFromChestsVariant()],
)

Machina1BalancedCornersMission = Mission(
    name="balanced_corners",
    description="Balanced corner distances for fair spawns.",
    site=MACHINA_1,
    variants=[BalancedCornersVariant()],
)

Machina1SharedRewardsMission = Mission(
    name="open_world_shared_rewards",
    description="Deposited-heart rewards are shared among all agents.",
    site=MACHINA_1,
    variants=[SharedRewardsVariant()],
)

_CORE_MISSIONS: List[Mission] = [
    TutorialMission,
    HarvestMission,
    VibeCheckMission,
    RepairMission,
    EasyHeartsTrainingMission,
    EasyHeartsHelloWorldMission,
    HelloWorldUnclipMission,
    HelloWorldOpenWorldMission,
    Machina1OpenWorldMission,
    Machina1OpenWorldWithChestsMission,
    Machina1BalancedCornersMission,
    Machina1SharedRewardsMission,
]


def get_core_missions() -> List[Mission]:
    return list(_CORE_MISSIONS)


@lru_cache(maxsize=1)
def get_missions() -> List[Mission]:
    from metta_tpu_torch.cogames.evals import get_eval_missions

    return [*_CORE_MISSIONS, *get_eval_missions()]


def get_mission(full_name: str) -> Mission:
    """Look up ``site.mission`` (or bare mission name, first match)."""
    for m in get_missions():
        if m.full_name() == full_name or m.name == full_name:
            return m
    raise KeyError(f"unknown mission: {full_name}; "
                   f"known: {[m.full_name() for m in get_missions()]}")
