"""Cogs-vs-Clips site definitions.

The port's own copy of ``metta_tpu/cogames/sites.py`` (parity: reference
``cogames/cogs_vs_clips/sites.py``): the training facility (a BaseHub-centred
13x13) and the evals arena. The hello-world and machina arenas build their
maps with ``metta_tpu/mapgen/scenes_arena.py:MachinaArena`` and
``metta_tpu/mapgen/scenes_terrain.py:BiomeCaves``, which are not ported:
their sites keep the JAX package's names, sizes and cog counts, and building
their maps raises ``NotImplementedError`` naming those files.
"""

from __future__ import annotations

from typing import Optional

from metta_tpu_torch.cogames.mission import Site
from metta_tpu_torch.mapgen.mapgen import MapGen
from metta_tpu_torch.mapgen.scene import Area, Scene, SceneConfig
from metta_tpu_torch.mapgen.scenes_structures import BaseHub


class UnportedScene(Scene):
    """A scene whose builder is not ported: rendering it raises."""

    class Config(SceneConfig):
        source: str
        spawn_count: Optional[int] = None

    def _render(self, area: Area, rng) -> None:
        raise NotImplementedError(f"not ported yet: {self.config.source}")


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
    """The procedural arena of the hello-world and machina sites (JAX
    ``sites.py:machina_arena``), not ported."""
    return UnportedScene.Config(
        source="the procedural arena's map (metta_tpu/mapgen/scenes_arena.py:MachinaArena, "
               "metta_tpu/mapgen/scenes_terrain.py:BiomeCaves)",
        spawn_count=spawn_count,
    )


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
