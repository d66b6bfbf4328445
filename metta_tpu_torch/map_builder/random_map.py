"""Random map builder.

Parity: reference ``mettagrid/map_builder/random_map.py``. Shuffles the
requested objects and agents into the interior of a (bordered) grid.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from metta_tpu_torch.map_builder.map_builder import GameMap, MapBuilder, MapBuilderConfig
from metta_tpu_torch.map_builder.utils import create_grid, draw_border


class RandomMapBuilderConfig(MapBuilderConfig["RandomMapBuilder"]):
    seed: Optional[int] = None
    width: int = 10
    height: int = 10
    objects: dict[str, int] = {}
    agents: Union[int, dict[str, int]] = 0
    border_width: int = 0
    border_object: str = "wall"


class RandomMapBuilder(MapBuilder):
    Config = RandomMapBuilderConfig

    def __init__(self, config: RandomMapBuilderConfig):
        super().__init__(config)
        self._rng = np.random.default_rng(config.seed)

    def build(self) -> GameMap:
        cfg = self.config
        if cfg.seed is not None:
            self._rng = np.random.default_rng(cfg.seed)

        grid = create_grid(cfg.height, cfg.width)
        draw_border(grid, cfg.border_width, cfg.border_object)

        bw = cfg.border_width
        inner_h = max(0, cfg.height - 2 * bw) if bw > 0 else cfg.height
        inner_w = max(0, cfg.width - 2 * bw) if bw > 0 else cfg.width
        inner_area = inner_h * inner_w
        if inner_area <= 0:
            return GameMap(grid)

        if isinstance(cfg.agents, int):
            agents = ["agent.agent"] * cfg.agents
        else:
            agents = [f"agent.{name}" for name, n in cfg.agents.items() for _ in range(n)]

        objects = dict(cfg.objects)
        total = sum(objects.values()) + len(agents)
        # Halve object counts until everything fits the interior.
        while total > inner_area:
            if all(c <= 1 for c in objects.values()) and len(agents) <= 1:
                break
            for name in objects:
                objects[name] = max(1, objects[name] // 2)
            total = sum(objects.values()) + len(agents)

        symbols: list[str] = []
        for name, count in objects.items():
            symbols.extend([name] * count)
        symbols.extend(agents)
        symbols.extend(["empty"] * (inner_area - len(symbols)))

        arr = np.array(symbols, dtype="<U50")
        self._rng.shuffle(arr)
        inner = arr.reshape(inner_h, inner_w)

        if bw > 0:
            grid[bw : bw + inner_h, bw : bw + inner_w] = inner
        else:
            grid = inner
        return GameMap(grid)
