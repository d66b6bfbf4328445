"""Carry engine state and compiled tables across from numpy.

The port imports nothing of the JAX package, so state crosses as a dict of
numpy arrays, one per field, each with a leading env axis: for a JAX state
``s``, ``{f.name: np.asarray(getattr(s, f.name)) for f in
dataclasses.fields(s)}``. Fields the port does not keep (the JAX per-env PRNG
``key``) are dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metta_tpu_torch.engine.compiler import CompiledConfig
from metta_tpu_torch.engine.state import EnvState, VecEnvState
from metta_tpu_torch.engine.tables import Tables, attach_static_block_grid


def _env_from_numpy(d: dict, device) -> EnvState:
    kw = {}
    for f in dataclasses.fields(EnvState):
        x = np.asarray(d[f.name])
        if f.name in ("step", "done", "truncated"):
            x = x.reshape(-1)                   # [E] (JAX keeps per-env scalars)
        kw[f.name] = torch.as_tensor(np.array(x), device=device)
    return EnvState(**kw)


def state_from_numpy(d: dict, device="cpu"):
    """numpy fields -> port state. A dict with an ``env`` entry is a
    VecEnvState, else an EnvState; every array has a leading env axis."""
    if "env" in d:
        kw = {f.name: torch.as_tensor(np.array(d[f.name]),
                                      device=device)
              for f in dataclasses.fields(VecEnvState) if f.name != "env"}
        return VecEnvState(env=_env_from_numpy(d["env"], device), **kw)
    return _env_from_numpy(d, device)


def state_to_numpy(state) -> dict:
    """Port state -> dict of numpy arrays (the inverse of
    :func:`state_from_numpy`)."""
    if isinstance(state, VecEnvState):
        out = {f.name: getattr(state, f.name).cpu().numpy()
               for f in dataclasses.fields(VecEnvState) if f.name != "env"}
        out["env"] = state_to_numpy(state.env)
        return out
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(EnvState)}


def tables_from_compiled(compiled, init=None, track_stats: bool = True, device="cpu"):
    """Port ``Tables`` from a compiled config with the fields of
    :class:`CompiledConfig` (the port's own or the JAX package's). With the
    compiler's ``init`` arrays, the static block grid of the obs prep is
    attached too."""
    cfg = CompiledConfig(**{f.name: getattr(compiled, f.name)
                            for f in dataclasses.fields(CompiledConfig)})
    tables = Tables(cfg, track_stats=track_stats, device=device)
    if init is not None:
        from metta_tpu_torch.engine.step import make_initial_state

        attach_static_block_grid(tables, make_initial_state(tables, init))
    return tables
