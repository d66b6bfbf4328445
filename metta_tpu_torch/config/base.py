"""Config base class.

Parity: reference ``mettagrid/base_config.py`` — everything is pydantic v2 with
strict extra-field checking so typos in recipes fail loudly.
"""

from __future__ import annotations

from typing import Any, Self

from pydantic import BaseModel, ConfigDict


class Config(BaseModel):
    """Base class for all metta_tpu configuration models."""

    model_config = ConfigDict(extra="forbid", validate_assignment=False)

    def merged(self, **overrides: Any) -> Self:
        """Return a copy with the given field overrides applied."""
        return self.model_copy(update=overrides, deep=True)

    def override(self, path: str, value: Any) -> Self:
        """Apply a dotted-path override (CLI style), returning self.

        ``cfg.override("game.num_agents", 4)`` mirrors the reference's
        ``key=value`` recipe overrides (``metta/common/tool/run_tool.py``).
        Unknown paths raise — a typo'd key must not silently do nothing.
        """
        parts = path.split(".")
        obj: Any = self
        for i, part in enumerate(parts[:-1]):
            if isinstance(obj, dict):
                if part not in obj:
                    raise AttributeError(
                        f"Unknown config path {'.'.join(parts[: i + 1])!r} (in override {path!r})"
                    )
                obj = obj[part]
                continue
            if not hasattr(obj, part):
                raise AttributeError(
                    f"Unknown config path {'.'.join(parts[: i + 1])!r} (in override {path!r})"
                )
            obj = getattr(obj, part)
        last = parts[-1]
        if isinstance(obj, dict):
            # dict leaves (e.g. consumed_resources.laser) may introduce new keys
            obj[last] = value
            return self
        if isinstance(obj, BaseModel) and last not in type(obj).model_fields:
            raise AttributeError(
                f"Unknown config field {last!r} on {type(obj).__name__} (in override {path!r})"
            )
        current = getattr(obj, last, None)
        if current is not None and not isinstance(value, type(current)):
            # Coerce strings from CLI into the field's current type.
            if isinstance(current, bool) and isinstance(value, str):
                value = value.lower() in ("1", "true", "yes")
            elif isinstance(current, (int, float)) and isinstance(value, str):
                value = type(current)(value)
        object.__setattr__(obj, parts[-1], value)
        return self
