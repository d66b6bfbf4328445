"""Observation configuration.

Parity: reference ``mettagrid/config/obs_config.py``. Feature ids and names are
managed by ``IdMap``; changing them breaks trained policies.
"""

from __future__ import annotations

from pydantic import Field

from metta_tpu_torch.config.base import Config


class ObsConfig(Config):
    width: int = Field(default=11)
    height: int = Field(default=11)
    token_dim: int = Field(default=3)
    num_tokens: int = Field(default=200)
    token_value_base: int = Field(default=256)
    """Base for multi-token inventory encoding (value per token: 0..base-1)."""
