"""Cogs-vs-Clips site definitions.

Parity: reference ``cogames/cogs_vs_clips/sites.py`` — the training facility
(BaseHub-centred 13x13), hello-world / machina arenas (procedural extractor
fields around a base hub), and the evals arena.

The port's own copy of ``metta_tpu/cogames/sites.py``.
"""

from __future__ import annotations

from metta_tpu_torch.cogames.mission import Site
from metta_tpu_torch.mapgen.mapgen import MapGen
from metta_tpu_torch.mapgen.scene import ChildSpec, SceneConfig
from metta_tpu_torch.mapgen.scenes import Random
from metta_tpu_torch.mapgen.scenes_structures import BaseHub, UniformExtractorScene
from metta_tpu_torch.mapgen.scenes_terrain import BiomeCaves


def _hub_scene(spawn_count: int = 4) -> SceneConfig:
    return BaseHub.Config(
        spawn_count=spawn_count,
        corner_objects=[
            "carbon_extractor", "oxygen_extractor",
            "germanium_extractor", "silicon_extractor",
        ],
        cross_bundle="none",
    )


def machina_arena(spawn_count: int = 20) -> SceneConfig:
    """Procedural arena: base biome + biome/dungeon zones + weighted building
    scatter + central base hub + connectivity (cogs_vs_clips/procedural.py
    MachinaArena; see mapgen/scenes_arena.py)."""
    from metta_tpu_torch.mapgen.scenes_arena import MachinaArena

    return MachinaArena.Config(spawn_count=spawn_count)


TRAINING_FACILITY = Site(
    name="training_facility",
    description="COG Training Facility: open base hub, no obstacles.",
    map_builder=MapGen.Config(width=13, height=13, instance=_hub_scene(4)),
    min_cogs=1,
    max_cogs=4,
)

HELLO_WORLD = Site(
    name="hello_world",
    description="Welcome to space.",
    map_builder=MapGen.Config(width=100, height=100,
                              instance=machina_arena(20)),
    min_cogs=1,
    max_cogs=20,
)

MACHINA_1 = Site(
    name="machina_1",
    description="Your first mission. Collect resources and assemble HEARTs.",
    map_builder=MapGen.Config(width=88, height=88,
                              instance=machina_arena(20)),
    min_cogs=1,
    max_cogs=20,
)

EVALS = Site(
    name="evals",
    description="Diagnostic evaluation arenas.",
    map_builder=MapGen.Config(
        width=21, height=21,
        instance=BaseHub.Config(
            spawn_count=4,
            corner_objects=["carbon_extractor", "oxygen_extractor",
                            "germanium_extractor", "silicon_extractor"],
            cross_bundle="none",
        ),
    ),
    min_cogs=1,
    max_cogs=8,
)

SITES = [TRAINING_FACILITY, HELLO_WORLD, MACHINA_1, EVALS]
