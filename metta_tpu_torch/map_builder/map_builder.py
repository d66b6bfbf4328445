"""Map builder framework.

Parity: reference ``mettagrid/map_builder/map_builder.py``. A ``MapBuilder``
turns a config into a ``GameMap`` — a 2-D numpy grid of map-name strings
("empty", "wall", "agent.agent", ...). Map building is host-side numpy; the
engine compiler bakes the result into initial state arrays.
"""

from __future__ import annotations

import importlib
from abc import ABC, abstractmethod
from typing import Any, ClassVar, Generic, TypeVar, cast

import numpy as np
from pydantic import model_serializer

from metta_tpu_torch.config.base import Config

MapGrid = np.ndarray  # 2-D array of dtype <U str


class GameMap:
    """A built game map: 2-D grid of map-name strings."""

    def __init__(self, grid: MapGrid):
        self.grid = grid

    @property
    def height(self) -> int:
        return int(self.grid.shape[0])

    @property
    def width(self) -> int:
        return int(self.grid.shape[1])


TBuilder = TypeVar("TBuilder", bound="MapBuilder")


class MapBuilderConfig(Config, Generic[TBuilder]):
    """Base class for map builder configs; ``create()`` instantiates the
    builder. Serialization carries a ``type`` import-path discriminator so
    polymorphic configs survive JSON round-trips (reference
    ``map_builder/map_builder.py:37-140``); resolve with
    :func:`load_map_builder_config`."""

    _builder_cls: ClassVar[type | None] = None

    @model_serializer(mode="wrap")
    def _serialize_with_type(self, handler):
        d = handler(self)
        cls = type(self)
        d["type"] = f"{cls.__module__}.{cls.__qualname__}"
        return d

    @classmethod
    def builder_cls(cls) -> type[TBuilder]:
        if cls._builder_cls is None:
            raise TypeError(f"{cls.__qualname__} is not bound to a MapBuilder")
        return cast(type[TBuilder], cls._builder_cls)

    def create(self) -> TBuilder:
        return self.builder_cls()(self)


class MapBuilder(ABC):
    """Base class for map builders. Subclasses gain a bound ``Config`` attr."""

    Config: ClassVar[type[MapBuilderConfig]]

    def __init__(self, config: MapBuilderConfig):
        self.config = config

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # Bind the config class declared via the `Config` class attribute (or
        # via generic parameter naming convention `<Name>Config`).
        cfg = cls.__dict__.get("Config")
        if cfg is not None and issubclass(cfg, MapBuilderConfig):
            cfg._builder_cls = cls

    @abstractmethod
    def build(self) -> GameMap: ...


def bind_config(builder_cls: type, config_cls: type) -> None:
    """Bind a MapBuilderConfig to its builder (for configs defined separately)."""
    config_cls._builder_cls = builder_cls
    builder_cls.Config = config_cls


def load_map_builder_config(value: Any) -> Any:
    """Resolve a serialized map-builder config (dict with a ``type`` import
    path) back to its concrete MapBuilderConfig; passes other values through.
    """
    if isinstance(value, MapBuilderConfig) or value is None:
        return value
    if isinstance(value, dict) and "type" in value:
        d = dict(value)
        path = d.pop("type")
        mod_name, _, qual = path.rpartition(".")
        obj: Any = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
        if not (isinstance(obj, type) and issubclass(obj, MapBuilderConfig)):
            raise TypeError(f"{path} is not a MapBuilderConfig")
        return obj.model_validate(d)
    return value
