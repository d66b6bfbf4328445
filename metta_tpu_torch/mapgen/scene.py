"""Scene framework for procedural map generation.

Parity: reference ``mettagrid/mapgen/scene.py`` — a Scene renders into a
rectangular area of the map grid and may declare sub-areas (tagged) into which
child scenes render. Scene configs follow the MapBuilder ``.Config`` binding
pattern so they compose in pydantic config trees.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, ClassVar, List, Optional

import numpy as np
from pydantic import Field

from metta_tpu_torch.config.base import Config


class Area:
    """A rectangular view into the map grid with optional tags."""

    def __init__(self, grid: np.ndarray, r: int, c: int, height: int, width: int,
                 tags: Optional[list[str]] = None):
        self.outer_grid = grid
        self.r, self.c = r, c
        self.height, self.width = height, width
        self.tags = tags or []

    @property
    def grid(self) -> np.ndarray:
        return self.outer_grid[self.r : self.r + self.height, self.c : self.c + self.width]

    def sub(self, r: int, c: int, height: int, width: int, tags=None) -> "Area":
        return Area(self.outer_grid, self.r + r, self.c + c, height, width, tags)


class ChildSpec(Config):
    """Attach a child scene to sub-areas matching ``where`` tag ('*' = all)."""

    scene: Any
    where: str = "*"
    limit: Optional[int] = None


class SceneConfig(Config):
    _scene_cls: ClassVar[Optional[type]] = None

    children: List[ChildSpec] = Field(default_factory=list)
    seed: Optional[int] = None

    def create(self) -> "Scene":
        if self._scene_cls is None:
            raise TypeError(f"{type(self).__name__} is not bound to a Scene")
        return self._scene_cls(self)


class Scene(ABC):
    Config: ClassVar[type] = SceneConfig

    def __init__(self, config: SceneConfig):
        self.config = config
        self.areas: list[Area] = []

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cfg = cls.__dict__.get("Config")
        if cfg is not None and issubclass(cfg, SceneConfig):
            cfg._scene_cls = cls

    def make_area(self, area: Area, r, c, h, w, tags=None) -> Area:
        sub = area.sub(r, c, h, w, tags)
        self.areas.append(sub)
        return sub

    @abstractmethod
    def _render(self, area: Area, rng: np.random.Generator) -> None: ...

    def render(self, area: Area, rng: Optional[np.random.Generator] = None) -> None:
        if rng is None:
            rng = np.random.default_rng(self.config.seed)
        self.areas = []
        self._render(area, rng)
        # render children into matching sub-areas
        for spec in self.config.children:
            targets = [
                a for a in self.areas
                if spec.where == "*" or spec.where in a.tags
            ]
            if spec.limit is not None:
                targets = targets[: spec.limit]
            for sub_area in targets:
                child = spec.scene.create()
                child.render(sub_area, rng)


def render_scene(scene_cfg: SceneConfig, height: int, width: int,
                 seed: Optional[int] = None) -> np.ndarray:
    """Render a scene tree into a fresh grid."""
    grid = np.full((height, width), "empty", dtype="<U50")
    area = Area(grid, 0, 0, height, width)
    scene = scene_cfg.create()
    scene.render(area, np.random.default_rng(seed if seed is not None else scene_cfg.seed))
    return grid
