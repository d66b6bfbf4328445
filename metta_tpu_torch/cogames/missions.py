"""Cogs vs Clips missions.

Parity: reference ``packages/cogames/src/cogames/cogs_vs_clips/mission.py``
(42-143): the resource economy — carbon/oxygen/germanium/silicon extractors,
chargers, the assembler hub, hearts — built on the same engine primitives:
energy as an inventory resource (capacity 100 via limits, regen +1/step via
``inventory_regen_interval``), movement costing 2 energy via the move action's
consumed resources, and the clipper infection over stations.

The port's own copy of ``metta_tpu/cogames/missions.py``.
"""

from __future__ import annotations

from typing import Optional

from metta_tpu_torch.config.mettagrid_config import (
    ActionsConfig,
    AgentConfig,
    AgentRewards,
    AssemblerConfig,
    ChangeVibeActionConfig,
    ChestConfig,
    ClipperConfig,
    GameConfig,
    InventoryConfig,
    MettaGridConfig,
    MoveActionConfig,
    NoopActionConfig,
    ProtocolConfig,
    ResourceLimitsConfig,
    WallConfig,
)
from metta_tpu_torch.config.vibes import TRAINING_VIBES
from metta_tpu_torch.mapgen.mapgen import MapGen
from metta_tpu_torch.mapgen.scenes import Random

RESOURCES = ["energy", "carbon", "oxygen", "germanium", "silicon", "heart", "gear"]

ENERGY_CAPACITY = 100
ENERGY_REGEN = 1
MOVE_ENERGY_COST = 2


def _extractor(resource: str, cooldown: int = 10) -> AssemblerConfig:
    return AssemblerConfig(
        name=f"{resource}_extractor",
        render_symbol="⛏️",
        protocols=[
            ProtocolConfig(
                input_resources={"energy": 2},
                output_resources={resource: 1},
                cooldown=cooldown,
            )
        ],
    )


def _charger() -> AssemblerConfig:
    return AssemblerConfig(
        name="charger",
        render_symbol="🔋",
        protocols=[ProtocolConfig(output_resources={"energy": 20}, cooldown=5)],
    )


def _hub() -> AssemblerConfig:
    return AssemblerConfig(
        name="assembler",
        render_symbol="⭐",
        protocols=[
            ProtocolConfig(
                input_resources={"carbon": 1, "oxygen": 1, "germanium": 1, "silicon": 1},
                output_resources={"heart": 1},
                cooldown=10,
            )
        ],
    )


def make_mission(
    name: str = "basic",
    num_agents: int = 4,
    width: int = 32,
    height: int = 32,
    with_clipper: bool = False,
    max_steps: int = 1000,
) -> MettaGridConfig:
    """Build a mission config. Missions: basic, clipped, spanning."""
    objects = {
        "wall": WallConfig(render_symbol="⬛"),
        "assembler": _hub(),
        "charger": _charger(),
        "carbon_extractor": _extractor("carbon"),
        "oxygen_extractor": _extractor("oxygen"),
        "germanium_extractor": _extractor("germanium"),
        "silicon_extractor": _extractor("silicon"),
    }
    clipper = None
    if with_clipper:
        clipper = ClipperConfig(
            unclipping_protocols=[
                ProtocolConfig(input_resources={"gear": 1}, cooldown=0),
                ProtocolConfig(input_resources={"carbon": 2}, cooldown=0),
            ],
            clip_period=100,
        )
    game = GameConfig(
        num_agents=num_agents,
        max_steps=max_steps,
        resource_names=list(RESOURCES),
        objects=objects,
        inventory_regen_interval=1,
        clipper=clipper,
        actions=ActionsConfig(
            noop=NoopActionConfig(),
            move=MoveActionConfig(
                consumed_resources={"energy": MOVE_ENERGY_COST},
            ),
            change_vibe=ChangeVibeActionConfig(vibes=list(TRAINING_VIBES)),
        ),
        agent=AgentConfig(
            inventory=InventoryConfig(
                limits={
                    "energy": ResourceLimitsConfig(limit=ENERGY_CAPACITY, resources=["energy"]),
                },
                initial={"energy": ENERGY_CAPACITY},
                regen_amounts={"default": {"energy": ENERGY_REGEN}},
            ),
            rewards=AgentRewards(inventory={"heart": 1.0}),
        ),
        map_builder=MapGen.Config(
            num_agents=num_agents,
            width=width,
            height=height,
            border_width=1,
            instances=1,
            instance=Random.Config(
                agents=num_agents,
                objects={
                    "wall": 20,
                    "assembler": 1,
                    "charger": 2,
                    "carbon_extractor": 2,
                    "oxygen_extractor": 2,
                    "germanium_extractor": 2,
                    "silicon_extractor": 2,
                },
            ),
        ),
    )
    return MettaGridConfig(label=f"cogs_vs_clips.{name}", game=game)


MISSIONS = {
    "basic": lambda **kw: make_mission("basic", **kw),
    "clipped": lambda **kw: make_mission("clipped", with_clipper=True, **kw),
}
