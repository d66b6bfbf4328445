"""Structured base / station-distribution scenes.

Behavioral parity with reference ``mapgen/scenes/base_hub.py`` (430 LoC) and
``mapgen/scenes/building_distributions.py`` (454 LoC) — the cogames-style
symmetric home base and the extractor-field generator with configurable
spatial distributions. The port's own copy of
``metta_tpu/mapgen/scenes_structures.py``.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Dict, List, Literal, Optional

import numpy as np
from pydantic import Field

from metta_tpu_torch.config.base import Config
from metta_tpu_torch.mapgen.scene import Area, Scene, SceneConfig

DEFAULT_EXTRACTORS = (
    "carbon_extractor",
    "oxygen_extractor",
    "germanium_extractor",
    "silicon_extractor",
)

DEFAULT_BUILDING_WEIGHTS: Dict[str, float] = {
    "charger": 0.3,
    "silicon_extractor": 0.2,
    "carbon_extractor": 0.1,
    "oxygen_extractor": 0.1,
    "germanium_extractor": 0.1,
}
DEFAULT_FALLBACK_WEIGHT = 0.1


class BaseHub(Scene):
    """Symmetric home base: central assembler + charger/chest, corner
    extractors, gated inner wall (or tight perimeter + L-shaped exits),
    spawn pads around the core (scenes/base_hub.py)."""

    class Config(SceneConfig):
        assembler_object: str = "assembler"
        corner_generator: Optional[str] = None
        spawn_symbol: str = "agent.agent"
        spawn_count: Optional[int] = None
        hub_width: int = 21
        hub_height: int = 21
        include_inner_wall: bool = True
        outer_clearance: int = 3
        corner_objects: Optional[List[str]] = None
        corner_bundle: Literal["extractors", "none", "custom"] = "extractors"
        cross_objects: Optional[List[str]] = None
        cross_bundle: Literal["none", "extractors", "custom"] = "none"
        cross_distance: int = 4
        layout: Literal["default", "tight"] = "default"
        charger_object: str = "charger"
        heart_chest_object: str = "chest"

    # -- helpers -----------------------------------------------------------

    def _corner_names(self) -> List[str]:
        c = self.config
        if c.corner_objects and len(c.corner_objects) == 4:
            return list(c.corner_objects)
        if c.corner_generator:
            return [c.corner_generator] * 4
        if c.corner_bundle == "extractors":
            return list(DEFAULT_EXTRACTORS)
        return []

    def _cross_names(self) -> List[str]:
        c = self.config
        if c.cross_objects and len(c.cross_objects) == 4:
            return list(c.cross_objects)
        if c.cross_bundle == "extractors":
            return list(DEFAULT_EXTRACTORS)
        return []

    # -- render ------------------------------------------------------------

    def _render(self, area: Area, rng):
        full = area.grid
        H, W = full.shape
        c = self.config
        hw = max(7, min(c.hub_width, W))
        hh = max(7, min(c.hub_height, H))
        x0 = (W - hw) // 2
        y0 = (H - hh) // 2

        cl = max(0, c.outer_clearance)
        if cl:
            full[max(0, y0 - cl) : min(H, y0 + hh + cl),
                 max(0, x0 - cl) : min(W, x0 + hw + cl)] = "empty"

        g = full[y0 : y0 + hh, x0 : x0 + hw]
        h, w = hh, hw
        cx, cy = w // 2, h // 2
        g[:] = "empty"

        if c.include_inner_wall and h >= 3 and w >= 3:
            g[0, :] = g[-1, :] = "wall"
            g[:, 0] = g[:, -1] = "wall"
            gh = 2
            for row in (0, 1, h - 2, h - 1):
                g[row, cx - gh : cx + gh + 1] = "empty"
            for col in (0, 1, w - 2, w - 1):
                g[cy - gh : cy + gh + 1, col] = "empty"

        if c.layout == "tight":
            self._tight(g, cx, cy, rng)
        else:
            self._default(g, cx, cy, rng)

    def _default(self, g, cx, cy, rng):
        h, w = g.shape
        c = self.config
        half = 2      # corridor width 5
        g[1 : h - 1, max(1, cx - half) : min(w - 1, cx + half + 1)] = "empty"
        g[max(1, cy - half) : min(h - 1, cy + half + 1), 1 : w - 1] = "empty"

        g[cy, cx] = c.assembler_object
        if 1 <= cy - 3 < h - 1:
            g[cy - 3, cx] = c.charger_object
        if 1 <= cy + 3 < h - 1:
            g[cy + 3, cx] = c.heart_chest_object

        desired = c.spawn_count if c.spawn_count is not None else 4
        pads = []
        ring = [(cx, cy - 2), (cx + 2, cy), (cx, cy + 2), (cx - 2, cy)]
        radius = 3
        while len(pads) < desired and radius < max(h, w):
            for x, y in ring:
                if len(pads) >= desired:
                    break
                if 0 <= x < w and 0 <= y < h and g[y, x] == "empty":
                    pads.append((x, y))
            ring = [
                (cx + radius, cy), (cx - radius, cy),
                (cx, cy + radius), (cx, cy - radius),
                (cx + radius, cy + radius), (cx + radius, cy - radius),
                (cx - radius, cy + radius), (cx - radius, cy - radius),
            ]
            radius += 1
        for x, y in pads[:desired]:
            if 1 <= x < w - 1 and 1 <= y < h - 1 and g[y, x] == "empty":
                g[y, x] = c.spawn_symbol

        for (x, y), name in zip(
            [(2, 2), (w - 3, 2), (2, h - 3), (w - 3, h - 3)],
            self._corner_names(),
        ):
            if name and 1 <= x < w - 1 and 1 <= y < h - 1:
                g[y, x] = name

        cross = self._cross_names()
        if cross:
            d = max(1, c.cross_distance)
            for (x, y), name in zip(
                [(cx, cy - d), (cx + d, cy), (cx, cy + d), (cx - d, cy)], cross
            ):
                if name and 0 <= x < w and 0 <= y < h:
                    g[y, x] = name

    def _tight(self, g, cx, cy, rng):
        h, w = g.shape
        c = self.config

        def carve(x0, y0, cw, ch):
            g[max(0, y0) : min(h, y0 + ch), max(0, x0) : min(w, x0 + cw)] = "empty"

        width, leg = 5, max(3, min(h, w) // 3)
        # four L-shaped exits (orientation per corner)
        carve(1, 1, leg, width); carve(1 + leg - width, 1, width, leg)
        carve(1, 0, width, 1)
        carve(w - 4 - leg + width, 1, leg, width)
        carve(w - 4 - leg + width, 1, width, leg)
        carve(w - 4 - width + 1, 0, width, 1)
        carve(1, h - 4, leg, width); carve(1 + leg - width, h - 4 - leg + width, width, leg)
        carve(0, h - 4 - width + 1, width, width)
        carve(w - 4 - leg + width, h - 4, leg, width)
        carve(w - 4 - leg + width, h - 4 - leg + width, width, leg)
        carve(w - 4 - width + 1, h - 1, width, 1)

        core = 3
        carve(cx - core, cy - core, 2 * core + 1, 2 * core + 1)

        placed = []

        def put(x, y, name):
            if 1 <= x < w - 1 and 1 <= y < h - 1 and g[y, x] == "empty":
                g[y, x] = name
                placed.append((x, y))

        put(cx, cy, c.assembler_object)
        put(cx, cy - 2, c.charger_object)
        put(cx, cy + 2, c.heart_chest_object)
        for (x, y), name in zip(
            [(cx - 2, cy - 2), (cx + 2, cy - 2), (cx - 2, cy + 2), (cx + 2, cy + 2)],
            self._corner_names(),
        ):
            if name:
                put(x, y, name)
        cross = self._cross_names()
        if cross:
            d = max(1, c.cross_distance)
            for (x, y), name in zip(
                [(cx, cy - d), (cx + d, cy), (cx, cy + d), (cx - d, cy)], cross
            ):
                if name and 0 <= x < w and 0 <= y < h:
                    g[y, x] = name

        # one-cell clearance around each building
        for x, y in placed:
            for nx in range(x - 1, x + 2):
                for ny in range(y - 1, y + 2):
                    if (nx, ny) != (x, y) and 0 <= nx < w and 0 <= ny < h:
                        g[ny, nx] = "empty"

        # square perimeter with 4 gates
        pr, gh_ = core + 1, 2
        for x in range(cx - pr, cx + pr + 1):
            for y in range(cy - pr, cy + pr + 1):
                if not (0 <= x < w and 0 <= y < h):
                    continue
                on_p = (abs(x - cx) == pr and abs(y - cy) <= pr) or (
                    abs(y - cy) == pr and abs(x - cx) <= pr)
                on_gate = (abs(x - cx) <= gh_ and abs(y - cy) == pr) or (
                    abs(y - cy) <= gh_ and abs(x - cx) == pr)
                if on_p and not on_gate:
                    g[y, x] = "wall"

        desired = c.spawn_count if c.spawn_count is not None else 4
        sd = pr + 1
        pads = [(cx, cy - sd), (cx + sd, cy), (cx, cy + sd), (cx - sd, cy)]
        step = max(1, (2 * pr + 1) // 4)
        dx = -pr
        while len(pads) < desired and dx <= pr:
            pads.append((cx + dx, cy - sd))
            pads.append((cx + dx, cy + sd))
            dx += step
        for x, y in pads[:desired]:
            if 1 <= x < w - 1 and 1 <= y < h - 1 and g[y, x] == "empty":
                g[y, x] = c.spawn_symbol


# ---------------------------------------------------------------------------
# building distributions
# ---------------------------------------------------------------------------


class DistributionType(str, Enum):
    UNIFORM = "uniform"
    NORMAL = "normal"
    EXPONENTIAL = "exponential"
    POISSON = "poisson"
    BIMODAL = "bimodal"


class DistributionConfig(Config):
    """Spatial distribution of building placements
    (building_distributions.py:31-53)."""

    type: DistributionType = DistributionType.UNIFORM
    mean_x: Optional[float] = None
    mean_y: Optional[float] = None
    std_x: float = 0.2
    std_y: float = 0.2
    decay_rate: float = 2.0
    origin_x: float = 0.0
    origin_y: float = 0.0
    center1_x: float = 0.25
    center1_y: float = 0.25
    center2_x: float = 0.75
    center2_y: float = 0.75
    cluster_std: float = 0.15


def sample_positions(count: int, row_min: int, row_max: int, col_min: int,
                     col_max: int, dc: DistributionConfig,
                     rng: np.random.Generator) -> List[tuple]:
    """(row, col) samples in bounds per the distribution
    (building_distributions.py:56-183)."""
    aw, ah = col_max - col_min + 1, row_max - row_min + 1
    if count <= 0 or aw <= 0 or ah <= 0:
        return []
    t = dc.type
    if t == DistributionType.NORMAL:
        mx = 0.5 if dc.mean_x is None else dc.mean_x
        my = 0.5 if dc.mean_y is None else dc.mean_y
        cols = rng.normal(col_min + mx * aw, dc.std_x * aw, count)
        rows = rng.normal(row_min + my * ah, dc.std_y * ah, count)
    elif t == DistributionType.EXPONENTIAL:
        sx = np.clip(rng.exponential(1.0 / dc.decay_rate, count), 0, 1)
        sy = np.clip(rng.exponential(1.0 / dc.decay_rate, count), 0, 1)
        if dc.origin_x > 0.5:
            sx = 1.0 - sx
        if dc.origin_y > 0.5:
            sy = 1.0 - sy
        cols = col_min + sx * aw
        rows = row_min + sy * ah
    elif t == DistributionType.POISSON:
        k = max(1, count // 5)
        ccx = rng.uniform(col_min, col_max, k)
        ccy = rng.uniform(row_min, row_max, k)
        idx = rng.integers(0, k, count)
        cols = ccx[idx] + rng.normal(0, aw * 0.05, count)
        rows = ccy[idx] + rng.normal(0, ah * 0.05, count)
    elif t == DistributionType.BIMODAL:
        half = count // 2
        sc, sr = dc.cluster_std * aw, dc.cluster_std * ah
        cols = np.concatenate([
            rng.normal(col_min + dc.center1_x * aw, sc, half),
            rng.normal(col_min + dc.center2_x * aw, sc, count - half),
        ])
        rows = np.concatenate([
            rng.normal(row_min + dc.center1_y * ah, sr, half),
            rng.normal(row_min + dc.center2_y * ah, sr, count - half),
        ])
    else:  # uniform
        rows = rng.integers(row_min, row_max + 1, count)
        cols = rng.integers(col_min, col_max + 1, count)
    rows = np.clip(np.asarray(rows).astype(int), row_min, row_max)
    cols = np.clip(np.asarray(cols).astype(int), col_min, col_max)
    return list(zip(rows.tolist(), cols.tolist()))


class UniformExtractorScene(Scene):
    """Extractor field: stations on a jittered grid or sampled from spatial
    distributions with per-building overrides; each station carved into a
    padding-sized clearing (building_distributions.py:223-470)."""

    class Config(SceneConfig):
        rows: int = 4
        cols: int = 4
        jitter: int = 1
        padding: int = 1
        clear_existing: bool = False
        frame_with_walls: bool = False
        target_coverage: Optional[float] = None
        building_names: List[str] = Field(
            default_factory=lambda: list(DEFAULT_EXTRACTORS) + ["charger"]
        )
        building_weights: Optional[Dict[str, float]] = None
        distribution: DistributionConfig = Field(default_factory=DistributionConfig)
        building_distributions: Optional[Dict[str, DistributionConfig]] = None

    def _weights(self):
        c = self.config
        if c.building_weights:
            items = [(n, float(v)) for n, v in c.building_weights.items() if v > 0]
            if not items:
                raise ValueError("building_weights must contain positive values")
            names = [n for n, _ in items]
            w = np.array([v for _, v in items], float)
        else:
            names = c.building_names or ["carbon_extractor"]
            w = np.array(
                [DEFAULT_BUILDING_WEIGHTS.get(n, DEFAULT_FALLBACK_WEIGHT)
                 for n in names], float)
        return names, w / w.sum()

    def _render(self, area: Area, rng):
        g = area.grid
        H, W = g.shape
        c = self.config
        if H < 3 or W < 3:
            raise ValueError("extractor map must be at least 3x3")
        pad = max(0, c.padding)
        rmin, rmax = pad, H - pad - 1
        cmin, cmax = pad, W - pad - 1
        if rmin > rmax or cmin > cmax:
            return
        if c.clear_existing:
            g[:] = "empty"
            if c.frame_with_walls:
                g[0, :] = g[-1, :] = "wall"
                g[:, 0] = g[:, -1] = "wall"

        names, probs = self._weights()
        centers: List[tuple] = []

        def free(r, col):
            return not any(abs(r - r0) <= pad and abs(col - c0) <= pad
                           for r0, c0 in centers)

        def carve(r, col, name):
            g[max(0, r - pad) : min(H, r + pad + 1),
              max(0, col - pad) : min(W, col + pad + 1)] = "empty"
            g[r, col] = name
            centers.append((r, col))

        if c.target_coverage is not None:
            spacing = pad + 1
            maxn = max(0, -(-(rmax - rmin + 1) // spacing)) * max(
                0, -(-(cmax - cmin + 1) // spacing))
            if maxn == 0:
                return
            goal = min(maxn, max(1, int(c.target_coverage * (H - 2) * (W - 2))))
            if c.building_distributions:
                # group names by their (per-building or default) distribution
                groups: Dict[str, List[str]] = {}
                for n in names:
                    dc = c.building_distributions.get(n, c.distribution)
                    groups.setdefault(repr(dc.model_dump()), []).append(n)
                for gnames in groups.values():
                    dc = c.building_distributions.get(gnames[0], c.distribution)
                    gidx = [i for i, n in enumerate(names) if n in gnames]
                    gw = float(sum(probs[i] for i in gidx))
                    n_here = max(1, int(gw * goal))
                    pos = sample_positions(n_here, rmin, rmax, cmin, cmax, dc, rng)
                    gp = np.array([probs[i] for i in gidx])
                    gp = gp / gp.sum()
                    picks = rng.choice(gnames, size=len(pos), p=gp)
                    for (r, col), name in zip(pos, picks):
                        if free(r, col):
                            carve(r, col, str(name))
            else:
                pos = sample_positions(goal, rmin, rmax, cmin, cmax,
                                       c.distribution, rng)
                picks = rng.choice(names, size=len(pos), p=probs)
                for (r, col), name in zip(pos, picks):
                    if free(r, col):
                        carve(r, col, str(name))
            return

        # jittered uniform grid
        def linpos(n, interior):
            if n <= 0:
                return []
            if n >= interior:
                return list(range(1, interior + 1))
            step = (interior + 1) / (n + 1)
            return [1 + max(0, min(interior - 1, round(step * (i + 1))))
                    for i in range(n)]

        rows_p = linpos(c.rows, H - 2)
        cols_p = linpos(c.cols, W - 2)
        if not rows_p or not cols_p:
            raise ValueError("rows and cols must be positive")
        positions = list(dict.fromkeys(
            (r, col) for r in rows_p for col in cols_p))
        picks = rng.choice(names, size=len(positions), p=probs)
        j = max(0, c.jitter)
        for (br, bc), name in zip(positions, picks):
            br = int(np.clip(br, rmin, rmax))
            bc = int(np.clip(bc, cmin, cmax))
            for _ in range(8 if j else 1):
                r = int(np.clip(br + (rng.integers(-j, j + 1) if j else 0),
                                rmin, rmax))
                col = int(np.clip(bc + (rng.integers(-j, j + 1) if j else 0),
                                  cmin, cmax))
                if free(r, col):
                    carve(r, col, str(name))
                    break
