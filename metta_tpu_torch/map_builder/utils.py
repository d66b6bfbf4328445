"""Map building numpy helpers."""

from __future__ import annotations

import numpy as np


def draw_border(grid: np.ndarray, border_width: int, border_object: str) -> None:
    """Fill a border of the given width with ``border_object`` (in place)."""
    if border_width <= 0:
        return
    grid[:border_width, :] = border_object
    grid[-border_width:, :] = border_object
    grid[:, :border_width] = border_object
    grid[:, -border_width:] = border_object


def create_grid(height: int, width: int, fill: str = "empty") -> np.ndarray:
    return np.full((height, width), fill, dtype="<U50")
