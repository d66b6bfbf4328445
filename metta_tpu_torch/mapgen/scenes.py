"""Core mapgen scenes, the port's own copy of ``metta_tpu/mapgen/scenes.py``.

Parity subset of reference ``mettagrid/mapgen/scenes/`` (~40 scenes): the
load-bearing ones for the shipped maps — Random scatter, Maze (randomized
DFS), RoomGrid, BSP splits, and MakeConnected (flood-fill + corridor carving
so every open cell is reachable). More exotic scenes (WFC, ConvChain, biomes)
layer on the same Scene API.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

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


class Maze(Scene):
    """Randomized-DFS perfect maze with wall lattice (scenes/maze.py)."""

    class Config(SceneConfig):
        wall_object: str = "wall"

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        grid[:, :] = self.config.wall_object
        # cells at odd lattice points
        ch, cw = (H + 1) // 2, (W + 1) // 2
        visited = np.zeros((ch, cw), bool)
        stack = [(0, 0)]
        visited[0, 0] = True
        grid[0, 0] = "empty"
        while stack:
            r, c = stack[-1]
            neighbors = [
                (r + dr, c + dc)
                for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0))
                if 0 <= r + dr < ch and 0 <= c + dc < cw and not visited[r + dr, c + dc]
            ]
            if not neighbors:
                stack.pop()
                continue
            nr, nc = neighbors[rng.integers(len(neighbors))]
            visited[nr, nc] = True
            # carve the cell and the wall between
            grid[nr * 2, nc * 2] = "empty"
            grid[r + nr, c + nc] = "empty"
            stack.append((nr, nc))


class RoomGrid(Scene):
    """Split the area into a grid of rooms with border walls (scenes/room_grid.py)."""

    class Config(SceneConfig):
        rows: int = 2
        columns: int = 2
        border_width: int = 1
        border_object: str = "wall"

    def _render(self, area: Area, rng):
        cfg = self.config
        grid = area.grid
        H, W = grid.shape
        bw = cfg.border_width
        room_h = (H - bw * (cfg.rows - 1)) // cfg.rows
        room_w = (W - bw * (cfg.columns - 1)) // cfg.columns
        grid[:, :] = cfg.border_object
        for i in range(cfg.rows):
            for j in range(cfg.columns):
                r0 = i * (room_h + bw)
                c0 = j * (room_w + bw)
                grid[r0 : r0 + room_h, c0 : c0 + room_w] = "empty"
                self.make_area(area, r0, c0, room_h, room_w, tags=["room"])


class BSP(Scene):
    """Binary-space-partition rooms + connecting corridors (scenes/bsp.py)."""

    class Config(SceneConfig):
        min_room_size: int = 4
        depth: int = 3
        wall_object: str = "wall"

    def _render(self, area: Area, rng):
        cfg = self.config
        grid = area.grid
        H, W = grid.shape
        grid[:, :] = cfg.wall_object
        rooms: list[tuple[int, int, int, int]] = []

        def split(r, c, h, w, depth):
            if depth == 0 or (h < cfg.min_room_size * 2 + 1 and w < cfg.min_room_size * 2 + 1):
                rh = max(min(h - 2, int(rng.integers(cfg.min_room_size, max(h - 1, cfg.min_room_size + 1)))), 2)
                rw = max(min(w - 2, int(rng.integers(cfg.min_room_size, max(w - 1, cfg.min_room_size + 1)))), 2)
                r0 = r + int(rng.integers(0, max(h - rh, 1)))
                c0 = c + int(rng.integers(0, max(w - rw, 1)))
                grid[r0 : r0 + rh, c0 : c0 + rw] = "empty"
                rooms.append((r0, c0, rh, rw))
                self.make_area(area, r0 - area.r if False else r0, c0, rh, rw, tags=["room"])
                return
            if (h >= w and h >= cfg.min_room_size * 2 + 1) or w < cfg.min_room_size * 2 + 1:
                cut = int(rng.integers(cfg.min_room_size, h - cfg.min_room_size))
                split(r, c, cut, w, depth - 1)
                split(r + cut, c, h - cut, w, depth - 1)
            else:
                cut = int(rng.integers(cfg.min_room_size, w - cfg.min_room_size))
                split(r, c, h, cut, depth - 1)
                split(r, c + cut, h, w - cut, depth - 1)

        split(0, 0, H, W, cfg.depth)
        # connect consecutive room centers with L-corridors
        for (r1, c1, h1, w1), (r2, c2, h2, w2) in zip(rooms, rooms[1:]):
            y1, x1 = r1 + h1 // 2, c1 + w1 // 2
            y2, x2 = r2 + h2 // 2, c2 + w2 // 2
            grid[y1, min(x1, x2) : max(x1, x2) + 1] = "empty"
            grid[min(y1, y2) : max(y1, y2) + 1, x2] = "empty"


class MakeConnected(Scene):
    """Carve corridors until all open cells are mutually reachable
    (scenes/make_connected.py)."""

    class Config(SceneConfig):
        wall_object: str = "wall"

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        passable = grid != self.config.wall_object
        labels = np.full((H, W), -1, np.int32)
        n_comp = 0
        for r in range(H):
            for c in range(W):
                if passable[r, c] and labels[r, c] < 0:
                    # BFS flood fill
                    stack = [(r, c)]
                    labels[r, c] = n_comp
                    while stack:
                        y, x = stack.pop()
                        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                            ny, nx = y + dy, x + dx
                            if 0 <= ny < H and 0 <= nx < W and passable[ny, nx] and labels[ny, nx] < 0:
                                labels[ny, nx] = n_comp
                                stack.append((ny, nx))
                    n_comp += 1
        if n_comp <= 1:
            return
        # connect each component to component 0 via straight corridor between
        # nearest cell pairs (greedy)
        cells0 = np.argwhere(labels == 0)
        for comp in range(1, n_comp):
            cells = np.argwhere(labels == comp)
            # nearest pair by L1
            d = np.abs(cells[:, None, :] - cells0[None, :, :]).sum(-1)
            i, j = np.unravel_index(np.argmin(d), d.shape)
            (r1, c1), (r2, c2) = cells[i], cells0[j]
            for y in range(min(r1, r2), max(r1, r2) + 1):
                if grid[y, c1] == self.config.wall_object:
                    grid[y, c1] = "empty"
            for x in range(min(c1, c2), max(c1, c2) + 1):
                if grid[r2, x] == self.config.wall_object:
                    grid[r2, x] = "empty"


# the default ASCII legend (``metta_tpu/map_builder/ascii.py:DEFAULT_CHAR_TO_NAME``;
# the ASCII map builder itself is not ported)
DEFAULT_CHAR_TO_NAME: dict[str, str] = {
    ".": "empty",
    " ": "empty",
    "#": "wall",
    "@": "agent.agent",
    "A": "agent.agent",
    "_": "assembler",
    "c": "chest",
}


class InlineAscii(Scene):
    """Stamp an ASCII snippet into the area (scenes/inline_ascii.py)."""

    class Config(SceneConfig):
        data: str = ""
        char_to_map_name: Dict[str, str] = Field(default_factory=dict)

    def _render(self, area: Area, rng):
        legend = dict(DEFAULT_CHAR_TO_NAME)
        legend.update(self.config.char_to_map_name)
        lines = [ln for ln in self.config.data.splitlines() if ln]
        grid = area.grid
        for r, line in enumerate(lines[: grid.shape[0]]):
            for c, ch in enumerate(line[: grid.shape[1]]):
                grid[r, c] = legend.get(ch, "empty")
