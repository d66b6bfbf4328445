"""Procedural arena composition (MachinaArena), the port's own copy of
``metta_tpu/mapgen/scenes_arena.py``.

Parity: reference ``cogames/cogs_vs_clips/procedural.py:39-349``
(``MachinaArena``): a layered composite — base biome shell, autoscaled biome
and dungeon zones, weighted building scatter at a target coverage, a central
home-base hub with spawns, and a final connectivity pass. The reference
expresses the layers as a children-action tree over BSP layouts; this
implementation renders the same layer stack directly (zones as bounded
random rectangles), which is equivalent composition with our Scene API.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
from pydantic import Field

from metta_tpu_torch.mapgen.scene import Area, Scene, SceneConfig
from metta_tpu_torch.mapgen.scenes import Maze, MakeConnected
from metta_tpu_torch.mapgen.scenes_structures import (
    BaseHub,
    DistributionConfig,
    UniformExtractorScene,
)
from metta_tpu_torch.mapgen.scenes_terrain import (
    BiomeCaves,
    BiomeCity,
    BiomeDesert,
    BiomeForest,
    BiomePlains,
    RadialMaze,
)

_BIOMES = {
    "caves": BiomeCaves,
    "forest": BiomeForest,
    "desert": BiomeDesert,
    "city": BiomeCity,
    "plains": BiomePlains,
}

#: reference default layer weights (procedural.py:166-168, :183-185)
_BIOME_DEFAULTS = {"caves": 0.0, "forest": 1.0, "desert": 1.0, "city": 1.0,
                   "plains": 1.0}
_DUNGEON_DEFAULTS = {"maze": 1.0, "radial": 1.0}

#: reference default building mix (procedural.py:115-122)
_BUILDING_DEFAULTS = {
    "chest": 0.0,
    "charger": 0.6,
    "germanium_extractor": 0.5,
    "silicon_extractor": 0.3,
    "oxygen_extractor": 0.3,
    "carbon_extractor": 0.3,
}


def _autoscale_zone_counts(w: int, h: int, density: float) -> tuple[int, int]:
    """procedural.py:138-146: zone counts scale with map area."""
    area = max(1, w * h)
    biome_divisor = max(800, int(1600 / max(0.1, density)))
    dungeon_divisor = max(800, int(1500 / max(0.1, density)))
    biomes = max(3, min(48, area // biome_divisor))
    dungeons = max(3, min(48, area // dungeon_divisor))
    return int(biomes), int(dungeons)


class MachinaArena(Scene):
    """Layered procedural arena (see module docstring)."""

    class Config(SceneConfig):
        spawn_count: int = 4
        base_biome: str = "plains"
        base_biome_config: Dict[str, Any] = Field(default_factory=dict)

        building_coverage: float = 0.0175
        building_names: Optional[List[str]] = None
        building_weights: Optional[Dict[str, float]] = None

        hub: Optional[BaseHub.Config] = None

        biome_weights: Optional[Dict[str, float]] = None
        dungeon_weights: Optional[Dict[str, float]] = None
        biome_count: Optional[int] = None
        dungeon_count: Optional[int] = None
        density_scale: float = 0.9
        max_biome_zone_fraction: float = 0.27
        max_dungeon_zone_fraction: float = 0.2

        distribution: DistributionConfig = Field(default_factory=DistributionConfig)
        building_distributions: Optional[Dict[str, DistributionConfig]] = None

    def _zone_rects(self, H, W, count, max_frac, rng):
        max_w = max(10, int(min(W * max_frac, W // 2)))
        max_h = max(10, int(min(H * max_frac, H // 2)))
        rects = []
        for _ in range(count):
            zw = int(rng.integers(10, max(11, max_w + 1)))
            zh = int(rng.integers(10, max(11, max_h + 1)))
            zw, zh = min(zw, W), min(zh, H)
            r = int(rng.integers(0, max(1, H - zh + 1)))
            c = int(rng.integers(0, max(1, W - zw + 1)))
            rects.append((r, c, zh, zw))
        return rects

    def _render(self, area: Area, rng):
        cfg = self.config
        H, W = area.grid.shape
        if cfg.base_biome not in _BIOMES:
            raise ValueError(
                f"unknown base_biome {cfg.base_biome!r}; valid: {sorted(_BIOMES)}"
            )

        # 1. base biome shell
        base_cls = _BIOMES[cfg.base_biome]
        base_cls(base_cls.Config(**cfg.base_biome_config)).render(area, rng)

        # 2. zone counts (reference autoscale + the min-count-for-fraction rule)
        bc, dc = _autoscale_zone_counts(W, H, cfg.density_scale)
        if cfg.biome_count is not None:
            bc = cfg.biome_count
        if cfg.dungeon_count is not None:
            dc = cfg.dungeon_count

        def pick(weights, defaults):
            w = {**defaults, **(weights or {})}
            names = [k for k, v in w.items() if v > 0]
            p = np.array([w[k] for k in names], float)
            return names, p / p.sum()

        # biome zones: 60% of the zone budget gets filled (procedural.py:253)
        bnames, bp = pick(cfg.biome_weights, _BIOME_DEFAULTS)
        if bnames:
            for (r, c, zh, zw) in self._zone_rects(
                H, W, max(1, int(bc * 0.6)), cfg.max_biome_zone_fraction, rng
            ):
                cls = _BIOMES[bnames[int(rng.choice(len(bnames), p=bp))]]
                cls(cls.Config()).render(area.sub(r, c, zh, zw), rng)

        # dungeon zones: 50% of the budget (procedural.py:275)
        dnames, dp = pick(cfg.dungeon_weights, _DUNGEON_DEFAULTS)
        if dnames:
            for (r, c, zh, zw) in self._zone_rects(
                H, W, max(1, int(dc * 0.5)), cfg.max_dungeon_zone_fraction, rng
            ):
                kind = dnames[int(rng.choice(len(dnames), p=dp))]
                sub = area.sub(r, c, zh, zw)
                if kind == "radial":
                    RadialMaze(RadialMaze.Config(
                        arms=8, arm_width=1, clear_background=False,
                        outline_walls=False,
                    )).render(sub, rng)
                else:
                    Maze(Maze.Config()).render(sub, rng)

        # 3. weighted building scatter at the target coverage
        weights = dict(cfg.building_weights or {})
        if not weights:
            names = cfg.building_names or list(_BUILDING_DEFAULTS)
            weights = {n: _BUILDING_DEFAULTS.get(n, 1.0) for n in names}
        weights = {k: v for k, v in weights.items() if v > 0}
        UniformExtractorScene(UniformExtractorScene.Config(
            target_coverage=cfg.building_coverage,
            building_names=list(weights),
            building_weights=weights,
            clear_existing=False,
            distribution=cfg.distribution,
            building_distributions=cfg.building_distributions,
        )).render(area, rng)

        # 4. home-base hub with spawns (procedural.py:333-338)
        hub_cfg = cfg.hub or BaseHub.Config(
            corner_bundle="extractors", cross_bundle="none", cross_distance=7,
        )
        hub_cfg = hub_cfg.model_copy(update={"spawn_count": cfg.spawn_count})
        BaseHub(hub_cfg).render(area, rng)

        # 5. global connectivity
        MakeConnected(MakeConnected.Config()).render(area, rng)
