"""Observation feature-id assignment.

Parity: reference ``mettagrid/config/id_map.py:90-180``. Feature ids are
assigned sequentially in a fixed canonical order; this ordering is a
trained-policy compatibility contract (``obs_config.py:1-5`` in the reference).

Order: agent:group, agent:frozen, episode_completion_pct, last_action,
last_reward, goal, vibe, agent:compass, tag, cooldown_remaining, clipped,
remaining_uses, then per resource ``inv:<r>`` (+ ``inv:<r>:pN`` power tokens),
then ``protocol_input:<r>`` and ``protocol_output:<r>`` when
``protocol_details_obs`` is enabled.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

from pydantic import BaseModel, ConfigDict

if TYPE_CHECKING:
    from metta_tpu_torch.config.mettagrid_config import GameConfig


def num_inventory_tokens_needed(max_inventory_value: int, token_value_base: int) -> int:
    """Tokens needed to encode ``max_inventory_value`` in base ``token_value_base``."""
    if max_inventory_value == 0:
        return 1
    return math.ceil(math.log(max_inventory_value + 1, token_value_base))


class ObservationFeatureSpec(BaseModel):
    model_config = ConfigDict(protected_namespaces=())

    id: int
    name: str
    normalization: float


# (name, normalization) for the fixed leading feature block.
_CORE_FEATURES: list[tuple[str, float]] = [
    ("agent:group", 10.0),
    ("agent:frozen", 1.0),
    ("episode_completion_pct", 255.0),
    ("last_action", 10.0),
    ("last_reward", 100.0),
    ("goal", 100.0),
    ("vibe", 255.0),
    ("agent:compass", 1.0),
    ("tag", 10.0),
    ("cooldown_remaining", 255.0),
    ("clipped", 1.0),
    ("remaining_uses", 255.0),
]


class IdMap:
    """Computes the feature-id table for a GameConfig."""

    def __init__(self, config: "GameConfig"):
        self._config = config
        self._features: list[ObservationFeatureSpec] | None = None

    def features(self) -> list[ObservationFeatureSpec]:
        if self._features is None:
            self._features = self._compute()
        return self._features

    def feature_ids(self) -> dict[str, int]:
        return {f.name: f.id for f in self.features()}

    def feature_id(self, name: str) -> int:
        ids = self.feature_ids()
        if name not in ids:
            raise KeyError(f"Unknown observation feature: {name}")
        return ids[name]

    def feature(self, name: str) -> ObservationFeatureSpec:
        for f in self.features():
            if f.name == name:
                return f
        raise KeyError(f"Unknown observation feature: {name}")

    def tag_names(self) -> list[str]:
        """All tags across objects and agents, sorted (tag id = position)."""
        cfg = self._config
        tags = set()
        for obj in cfg.objects.values():
            tags.update(obj.tags)
        for agent in cfg.agents:
            tags.update(agent.tags)
        tags.update(cfg.agent.tags)
        return sorted(tags)

    def _compute(self) -> list[ObservationFeatureSpec]:
        cfg = self._config
        feats: list[ObservationFeatureSpec] = []
        next_id = 0

        def add(name: str, normalization: float) -> None:
            nonlocal next_id
            feats.append(ObservationFeatureSpec(id=next_id, name=name, normalization=normalization))
            next_id += 1

        for name, norm in _CORE_FEATURES:
            add(name, norm)

        base = cfg.obs.token_value_base
        n_inv_tokens = num_inventory_tokens_needed(65535, base)
        for resource in cfg.resource_names:
            add(f"inv:{resource}", float(base))
            for power in range(1, n_inv_tokens):
                add(f"inv:{resource}:p{power}", float(base))

        if cfg.protocol_details_obs:
            for resource in cfg.resource_names:
                add(f"protocol_input:{resource}", 100.0)
            for resource in cfg.resource_names:
                add(f"protocol_output:{resource}", 100.0)

        return feats
