"""World state of a batch of environments: a dataclass of torch tensors.

Counterpart of ``metta_tpu/engine/state.py``. The JAX package keeps one env's
state and ``vmap``s it; here every field carries a real leading env dimension
E. Field names, dtypes and meanings are the JAX ones, with two differences:

- the per-env PRNG key is gone: randomness is an explicit input of the step
  (``perm``) or comes from the env's ``torch.Generator``;
- ``step``, ``done`` and ``truncated`` are ``[E]`` instead of scalars.
"""

from __future__ import annotations

import dataclasses

import torch

# Cell kinds in static_kind / occupancy queries.
KIND_EMPTY = 0
KIND_AGENT = 1
KIND_WALL = 2
KIND_ASSEMBLER = 3
KIND_CHEST = 4


@dataclasses.dataclass
class _Tensors:
    """Shared helper for the tensor dataclasses below."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class EnvState(_Tensors):
    """Per-environment world state, batched over E."""

    def map(self, fn):
        """New state with ``fn`` applied to every field."""
        return EnvState(**{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
        })

    # --- episode bookkeeping ---
    step: torch.Tensor          # [E] int32, current_step
    done: torch.Tensor          # [E] bool (terminated)
    truncated: torch.Tensor     # [E] bool

    # --- agents (SoA over agent id) ---
    agent_r: torch.Tensor       # [E, A] int32
    agent_c: torch.Tensor       # [E, A] int32
    agent_prev_r: torch.Tensor  # [E, A] int32
    agent_prev_c: torch.Tensor  # [E, A] int32
    agent_inv: torch.Tensor     # [E, A, R] int32 (0..65535)
    agent_frozen: torch.Tensor  # [E, A] int32 (ticks remaining; <0 = permanent)
    agent_vibe: torch.Tensor    # [E, A] int32
    agent_steps_without_motion: torch.Tensor  # [E, A] int32
    agent_current_stat_reward: torch.Tensor   # [E, A] f32
    agent_gained: torch.Tensor  # [E, A, R] int32
    agent_lost: torch.Tensor    # [E, A, R] int32
    agent_chest_deposited: torch.Tensor  # [E, A, R] int32

    # --- occupancy grids ---
    agent_grid: torch.Tensor    # [E, H, W] int32: agent idx+1, 0 = empty
    static_kind: torch.Tensor   # [E, H, W] int32: KIND_* for immobile objects
    static_idx: torch.Tensor    # [E, H, W] int32: index into the per-kind table
    static_type: torch.Tensor   # [E, H, W] int32: object-type id

    # --- assemblers ---
    asm_r: torch.Tensor               # [E, NA] int32
    asm_c: torch.Tensor               # [E, NA] int32
    asm_type: torch.Tensor            # [E, NA] int32
    asm_cooldown_end: torch.Tensor    # [E, NA] int32
    asm_cooldown_duration: torch.Tensor  # [E, NA] int32
    asm_uses: torch.Tensor            # [E, NA] int32
    asm_clipped: torch.Tensor         # [E, NA] bool
    asm_unclip_proto: torch.Tensor    # [E, NA] int32
    asm_valid: torch.Tensor           # [E, NA] bool

    # --- chests ---
    chest_inv: torch.Tensor     # [E, NC, R] int32
    chest_type: torch.Tensor    # [E, NC] int32
    chest_valid: torch.Tensor   # [E, NC] bool

    # --- collectives ---
    coll_inv: torch.Tensor      # [E, NL, R] int32
    agent_coll: torch.Tensor    # [E, A] int32
    coll_aligned: torch.Tensor  # [E, NL, NT] int32
    coll_deposited: torch.Tensor  # [E, NL, R] int32
    coll_withdrawn: torch.Tensor  # [E, NL, R] int32

    # --- game-level stat accumulators ---
    game_chest_deposited: torch.Tensor  # [E, R] int32
    game_chest_withdrawn: torch.Tensor  # [E, R] int32
    game_asm_created: torch.Tensor      # [E, R] int32

    # --- per-step outputs ---
    reward: torch.Tensor            # [E, A] f32 (this step)
    episode_reward: torch.Tensor    # [E, A] f32
    action_success: torch.Tensor    # [E, A] bool
    executed_action: torch.Tensor   # [E, A] int32 (noop when failed)


# Fields that stay the same across episodes of one map; auto-reset passes
# them through instead of copying the template over them.
EPISODE_INVARIANT = (
    "static_kind", "static_idx", "static_type",
    "asm_r", "asm_c", "asm_type", "asm_valid", "chest_type", "chest_valid",
)


@dataclasses.dataclass
class VecEnvState(_Tensors):
    """Counterpart of ``metta_tpu/engine/env.py:VecEnvState``."""

    env: EnvState
    desync_step: torch.Tensor          # [E] int32; >0 = truncate first episode there
    episode_len: torch.Tensor          # [E] int32 of the last finished episode
    last_episode_reward: torch.Tensor  # [E, A] f32 of the last finished episode
    last_episode_gained: torch.Tensor  # [E, R] f32 agent-mean resources gained
