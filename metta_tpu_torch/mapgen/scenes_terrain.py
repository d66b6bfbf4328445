"""Terrain / biome / layout scene library, the port's own copy of
``metta_tpu/mapgen/scenes_terrain.py``.

Behavioral parity with the reference scene set
(``mettagrid/mapgen/scenes/``): varied_terrain.py (373 LoC), radial_maze.py,
biome_caves/desert/forest/city/plains.py, dither.py, spiral.py, layout.py,
bounded_layout.py, nop.py, remove_agents.py, random_objects.py,
mean_distance.py, mirror.py, grid_altars.py. Implementations are original
(host-side numpy; map building is not a hot path), matching each scene's
generator semantics and config surface.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Literal, Optional, Tuple, Union

import numpy as np
from pydantic import Field

from metta_tpu_torch.mapgen.scene import Area, ChildSpec, Scene, SceneConfig


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def dither_edges(grid: np.ndarray, prob: float, depth: int,
                 rng: np.random.Generator) -> None:
    """Organic wall/empty noise near wall boundaries (scenes/dither.py).

    Flip probability decays linearly with BFS distance from the boundary;
    the outermost ``depth`` border band is left untouched.
    """
    if depth <= 0 or prob <= 0.0:
        return
    wall = grid == "wall"

    def grow(mask: np.ndarray) -> np.ndarray:
        out = mask.copy()
        out[:-1] |= mask[1:]
        out[1:] |= mask[:-1]
        out[:, :-1] |= mask[:, 1:]
        out[:, 1:] |= mask[:, :-1]
        out[:-1, :-1] |= mask[1:, 1:]
        out[:-1, 1:] |= mask[1:, :-1]
        out[1:, :-1] |= mask[:-1, 1:]
        out[1:, 1:] |= mask[:-1, :-1]
        return out

    boundary = (grow(wall) & ~wall) | (grow(~wall) & wall)
    dist = np.full(grid.shape, np.inf, np.float32)
    dist[boundary] = 0.0
    frontier = boundary
    seen = boundary.copy()
    for d in range(1, depth + 1):
        frontier = grow(frontier) & ~seen
        if not frontier.any():
            break
        dist[frontier] = d
        seen |= frontier

    band = dist <= depth
    band[:depth, :] = False
    band[-depth:, :] = False
    band[:, :depth] = False
    band[:, -depth:] = False
    if not band.any():
        return
    p = prob * (depth - np.maximum(dist, 1.0) + 1) / depth
    flips = (rng.random(grid.shape) < p) & band
    grid[flips & wall] = "empty"
    grid[flips & ~wall] = "wall"


def _empty_windows(occ: np.ndarray, h: int, w: int) -> np.ndarray:
    """Top-left coords of all fully-empty h×w windows of the occupancy mask."""
    H, W = occ.shape
    if H < h or W < w:
        return np.zeros((0, 2), np.int64)
    c = occ.astype(np.int32).cumsum(0).cumsum(1)
    cp = np.zeros((H + 1, W + 1), np.int32)
    cp[1:, 1:] = c
    sums = cp[h:, w:] - cp[:-h, w:] - cp[h:, :-w] + cp[:-h, :-w]
    return np.argwhere(sums == 0)


def _symbols_of(agents: Union[int, Dict[str, int]],
                objects: Dict[str, int]) -> Tuple[list, list]:
    if isinstance(agents, int):
        ag = ["agent.agent"] * agents
    else:
        ag = [f"agent.{g}" for g, n in agents.items() for _ in range(n)]
    obj = [name for name, n in objects.items() for _ in range(n)]
    return ag, obj


# ---------------------------------------------------------------------------
# varied terrain
# ---------------------------------------------------------------------------


class VariedTerrain(Scene):
    """Obstacle-rich terrain: labyrinth patches, random connected blobs,
    crosses, scattered walls, rectangular blocks, then objects/agents
    (scenes/varied_terrain.py). Styles scale counts by area/3600 with a 30%
    per-feature occupancy cap."""

    STYLES = {
        "all-sparse": dict(large=(0, 2), small=(0, 2), crosses=(0, 2),
                           labyrinths=(0, 2), walls=(0, 2), blocks=(0, 2)),
        "balanced": dict(large=(3, 7), small=(3, 7), crosses=(3, 7),
                         labyrinths=(3, 7), walls=(3, 7), blocks=(3, 7)),
        "dense": dict(large=(8, 15), small=(8, 15), crosses=(7, 15),
                      labyrinths=(6, 15), walls=(40, 60), blocks=(5, 15)),
        "maze": dict(large=(0, 2), small=(0, 2), crosses=(0, 2),
                     labyrinths=(10, 20), walls=(0, 2), blocks=(0, 2)),
    }
    AVG_SIZE = dict(large=17.5, small=4.5, crosses=9.0, labyrinths=72.0,
                    walls=1.0, blocks=64.0)

    class Config(SceneConfig):
        objects: Dict[str, int] = Field(default_factory=dict)
        agents: int = 1
        style: str = "balanced"

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        style = self.STYLES.get(self.config.style)
        if style is None:
            raise ValueError(
                f"Unknown style {self.config.style!r}; "
                f"one of {sorted(self.STYLES)}"
            )
        scale = (H * W) / 3600.0

        def count(key):
            lo, hi = style[key]
            base = int(rng.integers(lo, hi)) if hi > lo else lo
            scaled = int(base * scale)
            cap = int(0.3 * H * W / self.AVG_SIZE[key])
            return min(scaled, cap) if scaled > 0 else 0

        occ = grid != "empty"

        def place(pattern: np.ndarray, clearance: int = 0) -> bool:
            ph, pw = pattern.shape
            cands = _empty_windows(occ, ph + 2 * clearance, pw + 2 * clearance)
            if len(cands) == 0:
                return False
            r, c = cands[rng.integers(len(cands))]
            r, c = r + clearance, c + clearance
            sub = grid[r : r + ph, c : c + pw]
            mask = pattern != "empty"
            sub[mask] = pattern[mask]
            occ[r : r + ph, c : c + pw] |= mask
            return True

        # labyrinth patches
        for _ in range(count("labyrinths")):
            place(self._labyrinth(rng))
        # connected blobs, large then small (1-cell clearance)
        for key, lo_hi in (("large", (10, 25)), ("small", (3, 6))):
            for _ in range(count(key)):
                n = int(rng.integers(lo_hi[0], lo_hi[1] + 1))
                place(self._blob(n, rng), clearance=1)
        # crosses
        for _ in range(count("crosses")):
            ch = int(rng.integers(1, 9))
            cw = int(rng.integers(1, 9))
            pat = np.full((ch, cw), "empty", dtype=grid.dtype)
            pat[ch // 2, :] = "wall"
            pat[:, cw // 2] = "wall"
            place(pat)
        # scattered single walls
        n_walls = count("walls")
        flat = np.flatnonzero(~occ)
        if n_walls and flat.size:
            pick = rng.choice(flat, size=min(n_walls, flat.size), replace=False)
            rr, cc = np.unravel_index(pick, occ.shape)
            grid[rr, cc] = "wall"
            occ[rr, cc] = True
        # rectangular blocks
        for _ in range(count("blocks")):
            bh = int(rng.integers(2, 15))
            bw = int(rng.integers(2, 15))
            place(np.full((bh, bw), "wall", dtype=grid.dtype))

        # agents then objects in random empty cells
        def drop(symbol):
            flat = np.flatnonzero(~occ)
            if flat.size == 0:
                return False
            i = flat[rng.integers(flat.size)]
            r, c = np.unravel_index(i, occ.shape)
            grid[r, c] = symbol
            occ[r, c] = True
            return True

        for _ in range(self.config.agents):
            if not drop("agent.agent"):
                break
        for name, n in self.config.objects.items():
            need = n - int((grid == name).sum())
            for _ in range(max(need, 0)):
                if not drop(name):
                    break

    @staticmethod
    def _blob(n: int, rng) -> np.ndarray:
        """Random connected 4-neighbour shape of ~n cells."""
        cells = {(0, 0)}
        while len(cells) < n:
            frontier = [
                (r + dr, c + dc)
                for r, c in cells
                for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1))
                if (r + dr, c + dc) not in cells
            ]
            if not frontier:
                break
            cells.add(frontier[rng.integers(len(frontier))])
        rs = [r for r, _ in cells]
        cs = [c for _, c in cells]
        pat = np.full((max(rs) - min(rs) + 1, max(cs) - min(cs) + 1), "empty",
                      dtype="<U50")
        for r, c in cells:
            pat[r - min(rs), c - min(cs)] = "wall"
        return pat

    @staticmethod
    def _labyrinth(rng) -> np.ndarray:
        """DFS maze patch (odd dims in [11, 25]) with border gaps, 3%
        assembler sprinkle, probabilistic passage thickening."""
        h = int(rng.integers(11, 26))
        w = int(rng.integers(11, 26))
        h -= 1 - h % 2
        w -= 1 - w % 2
        maze = np.full((h, w), "wall", dtype="<U50")
        maze[1, 1] = "empty"
        stack = [(1, 1)]
        while stack:
            r, c = stack[-1]
            nbrs = [
                (r + dr, c + dc)
                for dr, dc in ((-2, 0), (2, 0), (0, -2), (0, 2))
                if 0 <= r + dr < h and 0 <= c + dc < w
                and maze[r + dr, c + dc] == "wall"
            ]
            if nbrs:
                nr, nc = nbrs[rng.integers(len(nbrs))]
                maze[(r + nr) // 2, (c + nc) // 2] = "empty"
                maze[nr, nc] = "empty"
                stack.append((nr, nc))
            else:
                stack.pop()

        def has_gap(line):
            run = 0
            for v in line:
                run = run + 1 if v == "empty" else 0
                if run >= 2:
                    return True
            return False

        if w > 3 and not has_gap(maze[0, 1 : w - 1]):
            maze[0, 1:3] = "empty"
        if w > 3 and not has_gap(maze[h - 1, 1 : w - 1]):
            maze[h - 1, 1:3] = "empty"
        if h > 3 and not has_gap(maze[1 : h - 1, 0]):
            maze[1:3, 0] = "empty"
        if h > 3 and not has_gap(maze[1 : h - 1, w - 1]):
            maze[1:3, w - 1] = "empty"

        sprinkle = (rng.random((h, w)) < 0.03) & (maze == "empty")
        maze[sprinkle] = "assembler"

        thick = 0.7 * rng.random()
        out = maze.copy()
        inner = maze[1 : h - 1, 1 : w - 1] == "empty"
        right = (rng.random((h - 2, w - 2)) < thick) & inner
        down = (rng.random((h - 2, w - 2)) < thick) & inner
        rr, cc = np.nonzero(right)
        out[rr + 1, cc + 2] = "empty"
        rr, cc = np.nonzero(down)
        out[rr + 2, cc + 1] = "empty"
        return out


# ---------------------------------------------------------------------------
# radial maze
# ---------------------------------------------------------------------------


class RadialMaze(Scene):
    """N arms carved from the centre through a wall fill; endpoint + center
    sub-areas for child scenes (scenes/radial_maze.py)."""

    class Config(SceneConfig):
        arms: int = Field(default=4, ge=3, le=12)
        arm_width: int = Field(default=4, ge=1)
        arm_length: Optional[int] = None
        clear_background: bool = True
        outline_walls: bool = True

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        length = self.config.arm_length or min(H, W) // 2 - 1
        aw = self.config.arm_width
        if self.config.clear_background:
            grid[:] = "wall"
        cy, cx = H // 2, W // 2
        carved = np.zeros((H, W), bool)
        offs = np.arange(-(aw // 2), aw // 2 + aw % 2)

        for arm in range(self.config.arms):
            ang = 2 * math.pi * arm / self.config.arms
            ex = cx + int(round(length * math.cos(ang)))
            ey = cy + int(round(length * math.sin(ang)))
            n = max(abs(ex - cx), abs(ey - cy), 1)
            xs = np.rint(np.linspace(cx, ex, n + 1)).astype(int)
            ys = np.rint(np.linspace(cy, ey, n + 1)).astype(int)
            for dx in offs:
                for dy in offs:
                    x2, y2 = xs + dx, ys + dy
                    m = (x2 >= 0) & (x2 < W) & (y2 >= 0) & (y2 < H)
                    carved[y2[m], x2[m]] = True
            inb = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
            if inb.any():
                i = np.max(np.nonzero(inb))
                self.make_area(area, int(ys[i]), int(xs[i]), 1, 1,
                               tags=["endpoint"])

        grid[carved] = "empty"
        if self.config.outline_walls:
            g = carved.copy()
            g[:-1] |= carved[1:]; g[1:] |= carved[:-1]
            g[:, :-1] |= carved[:, 1:]; g[:, 1:] |= carved[:, :-1]
            g[:-1, :-1] |= carved[1:, 1:]; g[:-1, 1:] |= carved[1:, :-1]
            g[1:, :-1] |= carved[:-1, 1:]; g[1:, 1:] |= carved[:-1, :-1]
            grid[g & ~carved] = "wall"
        self.make_area(area, cy, cx, 1, 1, tags=["center"])


# ---------------------------------------------------------------------------
# biomes
# ---------------------------------------------------------------------------


class _DitherMixin:
    def _maybe_dither(self, grid, rng):
        c = self.config
        if c.dither_edges:
            dither_edges(grid, prob=c.dither_prob, depth=c.dither_depth, rng=rng)


class BiomeCaves(Scene, _DitherMixin):
    """Cellular-automata caves (scenes/biome_caves.py)."""

    class Config(SceneConfig):
        fill_prob: float = 0.4
        steps: int = 3
        birth_limit: int = 5
        death_limit: int = 3
        dither_edges: bool = True
        dither_prob: float = 0.15
        dither_depth: int = 5

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        c = self.config
        rock = (rng.random((H, W)) < c.fill_prob).astype(np.uint8)
        for _ in range(max(0, c.steps)):
            p = np.pad(rock, 1, constant_values=1)
            nb = sum(
                p[1 + dr : H + 1 + dr, 1 + dc : W + 1 + dc]
                for dr in (-1, 0, 1) for dc in (-1, 0, 1)
                if (dr, dc) != (0, 0)
            )
            rock = ((nb > c.birth_limit) | ((nb >= c.death_limit) & (rock == 1)))
            rock = rock.astype(np.uint8)
        grid[rock == 1] = "wall"
        self._maybe_dither(grid, rng)


class BiomeDesert(Scene, _DitherMixin):
    """Striated dune ridges at an angle with noise holes (biome_desert.py)."""

    class Config(SceneConfig):
        dune_period: int = 8
        ridge_width: int = 1
        angle: float = math.pi / 4
        noise_prob: float = 0.1
        dither_edges: bool = True
        dither_prob: float = 0.15
        dither_depth: int = 5

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        c = self.config
        period = max(2, c.dune_period)
        ys, xs = np.indices((H, W))
        xr = xs * math.cos(c.angle) + ys * math.sin(c.angle)
        dunes = (xr % period) < max(1, c.ridge_width)
        dunes &= ~(rng.random((H, W)) < c.noise_prob)
        grid[dunes] = "wall"
        self._maybe_dither(grid, rng)


class BiomeForest(Scene, _DitherMixin):
    """Clumpy tree growth from random seeds (biome_forest.py)."""

    class Config(SceneConfig):
        clumpiness: int = 2
        seed_prob: float = 0.03
        growth_prob: float = 0.5
        neighbor_threshold: int = 3
        dither_edges: bool = True
        dither_prob: float = 0.15
        dither_depth: int = 5

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        c = self.config
        forest = (rng.random((H, W)) < c.seed_prob).astype(np.uint8)
        for _ in range(max(0, c.clumpiness)):
            p = np.pad(forest, 1)
            nb = sum(
                p[1 + dr : H + 1 + dr, 1 + dc : W + 1 + dc]
                for dr in (-1, 0, 1) for dc in (-1, 0, 1)
                if (dr, dc) != (0, 0)
            )
            grow = (nb >= c.neighbor_threshold) & (rng.random((H, W)) < c.growth_prob)
            forest = (grow | (forest == 1)).astype(np.uint8)
        grid[forest == 1] = "wall"
        self._maybe_dither(grid, rng)


class BiomeCity(Scene, _DitherMixin):
    """Rectangular blocks separated by a road grid (biome_city.py)."""

    class Config(SceneConfig):
        pitch: int = 10
        road_width: int = 3
        place_prob: float = 0.9
        min_block_frac: float = 0.5
        jitter: int = 1
        dither_edges: bool = True
        dither_prob: float = 0.15
        dither_depth: int = 5

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        c = self.config
        pitch = max(4, c.pitch)
        rw = max(1, c.road_width)
        minb = max(1, int(pitch * c.min_block_frac))
        j = max(0, c.jitter)
        for gy in range(0, H, pitch):
            for gx in range(0, W, pitch):
                if rng.random() > c.place_prob:
                    continue
                bw = min(minb + int(rng.integers(-j, j + 1)), pitch - 2 * rw)
                bh = min(minb + int(rng.integers(-j, j + 1)), pitch - 2 * rw)
                if bw <= 0 or bh <= 0:
                    continue
                y0, x0 = gy + rw, gx + rw
                grid[y0 : min(y0 + bh, H), x0 : min(x0 + bw, W)] = "wall"
        # clear road stripes (keep walls already in them from blocks)
        for gy in range(0, H, pitch):
            band = grid[gy : min(gy + rw, H), :]
            band[band != "wall"] = "empty"
        for gx in range(0, W, pitch):
            band = grid[:, gx : min(gx + rw, W)]
            band[band != "wall"] = "empty"
        self._maybe_dither(grid, rng)


class BiomePlains(Scene):
    """Sparse rock clusters grown by random walkers from jittered anchors
    (biome_plains.py)."""

    class Config(SceneConfig):
        cluster_period: int = 7
        cluster_min_radius: int = 0
        cluster_max_radius: int = 2
        cluster_fill: float = 0.7
        cluster_prob: float = 0.8
        jitter: int = 2

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        c = self.config
        period = max(3, c.cluster_period)
        rocks = np.zeros((H, W), bool)
        anchors = [
            (x, y)
            for y in range(0, H, period)
            for x in range(0, W, period)
            if rng.random() <= c.cluster_prob
        ]
        for cx, cy in anchors:
            if c.jitter:
                cx += int(rng.integers(-c.jitter, c.jitter + 1))
                cy += int(rng.integers(-c.jitter, c.jitter + 1))
            if not (0 <= cx < W and 0 <= cy < H):
                continue
            radius = (int(rng.integers(c.cluster_min_radius,
                                       c.cluster_max_radius + 1))
                      if c.cluster_max_radius > 0 else 0)
            if radius == 0:
                rocks[cy, cx] = True
                continue
            fill = c.cluster_fill * rng.uniform(0.6, 1.0)
            for _ in range(int(rng.integers(2, 5))):      # walker branches
                x, y = cx, cy
                d = int(rng.integers(4))
                for _ in range(max(3, radius * 3)):
                    if 0 <= x < W and 0 <= y < H and rng.random() <= fill:
                        rocks[y, x] = True
                    if rng.random() < 0.35:
                        d = int(rng.integers(4))
                    dx, dy = ((1, 0), (-1, 0), (0, 1), (0, -1))[d]
                    if (x + dx - cx) ** 2 + (y + dy - cy) ** 2 > (radius + 1) ** 2:
                        d = int(rng.integers(4))
                        dx, dy = ((1, 0), (-1, 0), (0, 1), (0, -1))[d]
                    x, y = x + dx, y + dy
        grid[rocks] = "wall"


# ---------------------------------------------------------------------------
# placement / layout scenes
# ---------------------------------------------------------------------------


class Spiral(Scene):
    """Objects along a spiral from the centre with min spacing
    (scenes/spiral.py)."""

    class Config(SceneConfig):
        objects: Dict[str, int] = Field(default_factory=dict)
        agents: Union[int, Dict[str, int]] = 0
        spacing: int = 15
        start_radius: int = 0
        radius_increment: float = 2.5
        angle_increment: float = 0.3
        randomize_position: int = 2
        place_at_center: bool = True

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        c = self.config
        ag, obj = _symbols_of(c.agents, c.objects)
        symbols = (ag + obj) if (c.place_at_center and ag) else (obj + ag)
        if not symbols:
            return
        cx, cy = W // 2, H // 2
        positions = []
        angle, radius = 0.0, float(c.start_radius)
        if c.place_at_center:
            positions.append((cx, cy))
            angle += c.angle_increment
        lx, ly = cx, cy
        while len(positions) < len(symbols):
            x = int(cx + radius * math.cos(angle))
            y = int(cy + radius * math.sin(angle))
            if math.hypot(x - lx, y - ly) >= c.spacing:
                if c.randomize_position > 0:
                    x = int(np.clip(x + rng.integers(-c.randomize_position,
                                                     c.randomize_position + 1),
                                    1, W - 2))
                    y = int(np.clip(y + rng.integers(-c.randomize_position,
                                                     c.randomize_position + 1),
                                    1, H - 2))
                if 0 <= x < W and 0 <= y < H:
                    positions.append((x, y))
                    lx, ly = x, y
            angle += c.angle_increment
            radius += c.radius_increment * c.angle_increment / (2 * math.pi)
            if radius > max(W, H):
                break
        for sym, (x, y) in zip(symbols, positions):
            if grid[y, x] == "empty":
                grid[y, x] = sym


class LayoutAreaSpec(SceneConfig):
    width: int
    height: int
    placement: Literal["center"] = "center"
    tag: str


class Layout(Scene):
    """Declare centred sub-areas by size + tag (scenes/layout.py)."""

    class Config(SceneConfig):
        areas: List[LayoutAreaSpec] = Field(default_factory=list)

    def _render(self, area: Area, rng):
        H, W = area.height, area.width
        for spec in self.config.areas:
            if spec.width > W or spec.height > H:
                raise ValueError(
                    f"layout area {spec.tag} ({spec.width}x{spec.height}) "
                    f"exceeds grid {W}x{H}"
                )
            r = (H - spec.height) // 2
            c = (W - spec.width) // 2
            self.make_area(area, r, c, spec.height, spec.width, tags=[spec.tag])


class BoundedLayout(Scene):
    """Centred sub-area clamped by zone size and max dims
    (scenes/bounded_layout.py)."""

    class Config(SceneConfig):
        max_width: int = Field(ge=1)
        max_height: int = Field(ge=1)
        tag: str = "bounded"

    def _render(self, area: Area, rng):
        H, W = area.height, area.width
        w = max(1, min(W, self.config.max_width))
        h = max(1, min(H, self.config.max_height))
        w = max(min(W, max(10, self.config.max_width // 2)), w)
        h = max(min(H, max(10, self.config.max_height // 2)), h)
        c = (W - w) // 2
        r = (H - h) // 2
        w = min(w, W - c)
        h = min(h, H - r)
        if w > 0 and h > 0:
            self.make_area(area, r, c, h, w, tags=[self.config.tag])


class Nop(Scene):
    """Does nothing (scenes/nop.py)."""

    class Config(SceneConfig):
        pass

    def _render(self, area: Area, rng):
        pass


class RemoveAgents(Scene):
    """Blank out all agent cells (scenes/remove_agents.py)."""

    class Config(SceneConfig):
        pass

    def _render(self, area: Area, rng):
        grid = area.grid
        mask = np.char.startswith(grid.astype(str), "agent")
        grid[mask] = "empty"


class RandomObjects(Scene):
    """Scatter objects by area *percentage* ranges instead of counts
    (scenes/random_objects.py)."""

    class Config(SceneConfig):
        object_ranges: Dict[str, Tuple[float, float]] = Field(default_factory=dict)

    def _render(self, area: Area, rng):
        from metta_tpu_torch.mapgen.scenes import Random

        size = area.height * area.width
        objects = {
            name: int(size * rng.uniform(lo, hi))
            for name, (lo, hi) in self.config.object_ranges.items()
        }
        Random.Config(objects=objects).create().render(area, rng)


class MeanDistance(Scene):
    """Agent at centre; objects at Poisson-distributed radial distances
    (scenes/mean_distance.py)."""

    class Config(SceneConfig):
        mean_distance: float = 5.0
        objects: Dict[str, int] = Field(default_factory=dict)

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        ar, ac = H // 2, W // 2
        grid[ar, ac] = "agent.agent"
        for name, n in self.config.objects.items():
            placed = 0
            attempts = 0
            while placed < n and attempts < 10000:
                attempts += 1
                d = max(1, int(rng.poisson(self.config.mean_distance)))
                ang = rng.uniform(0, 2 * math.pi)
                r = ar + int(round(d * math.sin(ang)))
                c = ac + int(round(d * math.cos(ang)))
                if 0 <= r < H and 0 <= c < W and grid[r, c] == "empty":
                    grid[r, c] = name
                    placed += 1


class Mirror(Scene):
    """Render a child scene into one half/quadrant and reflect it
    (scenes/mirror.py; horizontal / vertical / x4 symmetry)."""

    class Config(SceneConfig):
        scene: Any
        symmetry: Literal["horizontal", "vertical", "x4"] = "horizontal"

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        child = self.config.scene.create()
        if self.config.symmetry == "horizontal":
            lw = (W + 1) // 2
            child.render(area.sub(0, 0, H, lw), rng)
            grid[:, lw:] = grid[:, : W - lw][:, ::-1]
        elif self.config.symmetry == "vertical":
            th = (H + 1) // 2
            child.render(area.sub(0, 0, th, W), rng)
            grid[th:, :] = grid[: H - th, :][::-1, :]
        else:  # x4
            sh, sw = (H + 1) // 2, (W + 1) // 2
            child.render(area.sub(0, 0, sh, sw), rng)
            grid[:sh, sw:] = grid[:sh, : W - sw][:, ::-1]
            grid[sh:, :sw] = grid[: H - sh, :sw][::-1, :]
            grid[sh:, sw:] = grid[: H - sh, : W - sw][::-1, ::-1]


class GridAltars(Scene):
    """Objects on a regular grid across the map with optional jitter;
    agent optionally at the centre (scenes/grid_altars.py)."""

    class Config(SceneConfig):
        objects: Dict[str, int] = Field(default_factory=dict)
        agents: Union[int, Dict[str, int]] = 0
        grid_rows: int = 3
        grid_cols: int = 3
        margin: int = 5
        min_spacing: int = Field(default=9, gt=0)
        randomize_position: int = 0
        place_agent_center: bool = True

    def _render(self, area: Area, rng):
        grid = area.grid
        H, W = grid.shape
        c = self.config
        ag, obj = _symbols_of(c.agents, c.objects)
        if not ag and not obj:
            return
        uw, uh = W - 2 * c.margin, H - 2 * c.margin
        cols = min(c.grid_cols, max(1, 1 + uw // c.min_spacing))
        rows = min(c.grid_rows, max(1, 1 + uh // c.min_spacing))
        xs = (c.margin + np.round(np.linspace(0, uw, cols)).astype(int)
              if cols > 1 else np.array([W // 2]))
        ys = (c.margin + np.round(np.linspace(0, uh, rows)).astype(int)
              if rows > 1 else np.array([H // 2]))
        positions = [(int(x), int(y)) for y in ys for x in xs]
        if c.randomize_position > 0:
            positions = [
                (int(np.clip(x + rng.integers(-c.randomize_position,
                                              c.randomize_position + 1),
                             1, W - 2)),
                 int(np.clip(y + rng.integers(-c.randomize_position,
                                              c.randomize_position + 1),
                             1, H - 2)))
                for x, y in positions
            ]
        if c.place_agent_center and ag:
            cy, cx = H // 2, W // 2
            if grid[cy, cx] == "empty":
                grid[cy, cx] = ag.pop(0)
        rng.shuffle(positions)
        for sym, (x, y) in zip(obj + ag, positions):
            if grid[y, x] == "empty":
                grid[y, x] = sym


class MultiLeftAndRight(Scene):
    """Paired left/right agent spawn rooms with altars on opposite sides
    (scenes/multi_left_and_right.py): a symmetric two-team layout."""

    class Config(SceneConfig):
        rows: int = Field(default=1, ge=1)
        columns: int = Field(default=1, ge=1)
        altar_ratio: float = 0.75
        total_altars: int = 2

    def _render(self, area: Area, rng):
        H, W = area.height, area.width
        rows, cols = self.config.rows, self.config.columns
        rh, cw = H // rows, W // cols
        n_alt = self.config.total_altars
        n_major = int(round(n_alt * self.config.altar_ratio))
        for i in range(rows):
            for jj in range(cols):
                sub = area.sub(i * rh, jj * cw, rh, cw)
                g = sub.grid
                g[:] = "empty"
                g[0, :] = "wall"
                g[-1, :] = "wall"
                g[:, 0] = "wall"
                g[:, -1] = "wall"
                mid = rh // 2
                left_major = bool(rng.integers(2))
                la = n_major if left_major else n_alt - n_major
                ra = n_alt - la
                for k in range(la):
                    g[1 + (mid + k) % max(rh - 2, 1), 1] = "assembler"
                for k in range(ra):
                    g[1 + (mid + k) % max(rh - 2, 1), cw - 2] = "assembler"
                g[mid, cw // 2 - 1] = "agent.agent"
                g[mid, cw // 2 + 1] = "agent.agent"
