"""MapGen: multi-instance scene composer.

Parity: reference ``mettagrid/mapgen/mapgen.py:18-434`` — tiles N instances of
an inner scene into a bordered grid (instance count auto-derived from
``num_agents`` / agents-per-instance when not given), the layout used by the
arena maps.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
from pydantic import Field

from metta_tpu_torch.map_builder.map_builder import GameMap, MapBuilder, MapBuilderConfig
from metta_tpu_torch.map_builder.utils import draw_border
from metta_tpu_torch.mapgen.scene import Area


class MapGenConfig(MapBuilderConfig["MapGen"]):
    width: int = 25
    height: int = 25
    instances: Optional[int] = None
    num_agents: Optional[int] = None
    border_width: int = 1
    instance_border_width: int = 1
    instance: Any = None  # SceneConfig
    seed: Optional[int] = None


class MapGen(MapBuilder):
    Config = MapGenConfig

    def __init__(self, config: MapGenConfig):
        super().__init__(config)

    def _agents_per_instance(self) -> int:
        inst = self.config.instance
        agents = getattr(inst, "agents", 1)
        if isinstance(agents, dict):
            return sum(agents.values())
        return max(int(agents), 1)

    def build(self) -> GameMap:
        cfg = self.config
        n = cfg.instances
        if n is None:
            if cfg.num_agents is not None:
                n = math.ceil(cfg.num_agents / self._agents_per_instance())
            else:
                n = 1
        cols = math.ceil(math.sqrt(n))
        rows = math.ceil(n / cols)
        ibw = cfg.instance_border_width
        bw = cfg.border_width
        total_w = cols * cfg.width + (cols - 1) * ibw + 2 * bw
        total_h = rows * cfg.height + (rows - 1) * ibw + 2 * bw
        grid = np.full((total_h, total_w), "empty", dtype="<U50")
        if bw > 0:
            draw_border(grid, bw, "wall")
        if ibw > 0:
            # instance separators
            for j in range(1, cols):
                x = bw + j * cfg.width + (j - 1) * ibw
                grid[:, x : x + ibw] = "wall"
            for i in range(1, rows):
                y = bw + i * cfg.height + (i - 1) * ibw
                grid[y : y + ibw, :] = "wall"
        rng = np.random.default_rng(cfg.seed)
        placed = 0
        for i in range(rows):
            for j in range(cols):
                if placed >= n:
                    break
                r0 = bw + i * (cfg.height + ibw)
                c0 = bw + j * (cfg.width + ibw)
                area = Area(grid, r0, c0, cfg.height, cfg.width)
                scene = cfg.instance.create()
                scene.render(area, rng)
                placed += 1

        # exact agent-count adjustment (instance tiling can over/under-shoot)
        if cfg.num_agents is not None:
            agent_mask = np.char.startswith(grid.astype(str), "agent")
            agent_cells = np.argwhere(agent_mask)
            excess = len(agent_cells) - cfg.num_agents
            if excess > 0:
                drop = rng.choice(len(agent_cells), size=excess, replace=False)
                for k in drop:
                    r, c = agent_cells[k]
                    grid[r, c] = "empty"
            elif excess < 0:
                empties = np.argwhere(grid == "empty")
                add = rng.choice(len(empties), size=-excess, replace=False)
                for k in add:
                    r, c = empties[k]
                    grid[r, c] = "agent.agent"
        return GameMap(grid)
