"""Mapgen scenes, the port's own copy of ``metta_tpu/mapgen/scenes.py``.

Only ``Random`` (reference ``mettagrid/mapgen/scenes/random.py``) is copied:
it is the scene the arena and combat maps use.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
from pydantic import Field

from metta_tpu_torch.mapgen.scene import Area, Scene, SceneConfig


class Random(Scene):
    """Scatter agents/objects uniformly into the area (scenes/random.py)."""

    class Config(SceneConfig):
        agents: Union[int, Dict[str, int]] = 0
        objects: Dict[str, int] = Field(default_factory=dict)

    def _render(self, area: Area, rng):
        grid = area.grid
        cells = np.argwhere(grid == "empty")
        symbols: list[str] = []
        if isinstance(self.config.agents, int):
            symbols += ["agent.agent"] * self.config.agents
        else:
            symbols += [f"agent.{g}" for g, n in self.config.agents.items() for _ in range(n)]
        for name, count in self.config.objects.items():
            symbols += [name] * count
        if not symbols:
            return
        if len(cells) < len(symbols):
            symbols = symbols[: len(cells)]
        idx = rng.choice(len(cells), size=len(symbols), replace=False)
        for sym, i in zip(symbols, idx):
            r, c = cells[i]
            grid[r, c] = sym
