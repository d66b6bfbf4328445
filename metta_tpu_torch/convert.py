"""Carry engine state, compiled tables and policy parameters across.

The port imports nothing of the JAX package, so state crosses as a dict of
numpy arrays, one per field, each with a leading env axis: for a JAX state
``s``, ``{f.name: np.asarray(getattr(s, f.name)) for f in
dataclasses.fields(s)}``. Fields the port does not keep (the JAX per-env PRNG
``key``) are dropped. A task set crosses as its compiled configs and numpy
leaves (:func:`task_set_from_numpy`). Policy parameters cross as flax parameter trees of
numpy arrays (:func:`flax_to_state_dict`, :func:`state_dict_to_flax`).
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


def task_set_from_numpy(compiled_list, leaves: dict, template: dict, obs1, weights,
                        track_stats: bool = True, device="cpu"):
    """A task set's ``TaskSetData`` from numpy: the compiled config of each
    task (the port's or the JAX package's, for the statics), the stacked
    table leaves {name: [K, ...]} (each task's tables take their rows, the
    static block grid ``obs_static_bg`` included), the stacked reset
    template {field: [K, ...]}, the initial obs [K, A, T, 3] and the
    weights [K]; the start-clipped masks are the templates' clipped
    assemblers, which they are wherever the clipper runs. Leaves the JAX
    package does not keep (the port's derived ones) are derived here; any
    leaf given must equal what the port derives."""
    from metta_tpu_torch.engine.taskset import TaskSetData
    from metta_tpu_torch.engine.tables import stack_tables

    per_task = []
    for k, compiled in enumerate(compiled_list):
        t = tables_from_compiled(compiled, track_stats=track_stats, device=device)
        t.obs_static_bg = torch.as_tensor(np.array(leaves["obs_static_bg"][k]), device=device)
        t.array_names += ("obs_static_bg",)
        for n in t.array_names:
            if n in leaves and not np.array_equal(getattr(t, n).cpu().numpy(), leaves[n][k]):
                raise ValueError(f"task {k}: leaf {n} differs from the port's")
        per_task.append(t)
    return TaskSetData(
        tables=stack_tables(per_task),
        template=_env_from_numpy(template, device),
        obs1=torch.as_tensor(np.array(obs1), device=device),
        start_clipped=torch.as_tensor(np.array(template["asm_clipped"], bool),
                                      device=device).reshape(len(compiled_list), -1),
        weights=torch.as_tensor(np.array(weights, np.float32), device=device),
    )


# ---------------------------------------------------------------------------
# Policy parameters: flax trees <-> the port's state_dict
# ---------------------------------------------------------------------------

_LSTM_GATES = ("i", "f", "g", "o")
_LSTM_LEAVES = ("core.weight_ih", "core.weight_hh", "core.bias")
_ATTN_IN = ("query", "key", "value")


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "/"))
        else:
            out[name] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flax_to_state_dict(params) -> dict:
    """A flax ``ViTPolicy`` parameter tree -> the port's ``state_dict``
    (torch float32 tensors on the CPU).

    ``params`` is the nested dict ``policy.init`` returns (with or without
    its ``params`` level) or a bundle's flat ``params/...`` names. Layouts:
    ``Dense`` kernels [in, out] become weights [out, in]; the attention
    projections ``DenseGeneral`` (D, H, hd) and (H, hd, D) become [H·hd, D]
    and [D, H·hd]; the LSTM's input kernels ``core/lstm/i{i,f,g,o}`` (no
    bias) stack into ``core.weight_ih`` [4H, in] and its hidden kernels
    ``core/lstm/h{i,f,g,o}`` with their biases into ``core.weight_hh`` [4H, H]
    and ``core.bias`` [4H]. Under a cortex core (``core/block_0/...``) every
    leaf keeps its path (``core.block_0.expert_0.cell.kqvbg_proj.weight``):
    Dense kernels become weights, and the raw parameters (sLSTM's
    [NH, 4, DH] ``bias`` and gates, the conv's ``kernel`` [K, H] and
    ``bias``, the scalars ``alpha_main`` and ``alpha_col``, ...) keep their
    shape and layout."""
    if not any("/" in k for k in params):
        params = flatten_tree(params)
    flat = {k.removeprefix("params/"): np.asarray(v, dtype=np.float32)
            for k, v in params.items()}
    sd = {}
    lstm = {}
    for name, v in flat.items():
        parts = name.split("/")
        if parts[0] == "core" and parts[1] == "lstm":
            lstm[(parts[2], parts[3])] = v
            continue
        if parts[-1] == "embedding":
            sd["token_embed.embedding"] = v
            continue
        module, leaf = ".".join(parts[:-1]), parts[-1]
        if parts[0] == "core" and (leaf != "kernel" or parts[-2] == "conv"):
            sd[f"{module}.{leaf}"] = v                 # cortex raw parameter, as it is
            continue
        if leaf == "kernel":
            if parts[-2] in _ATTN_IN:                  # (D, H, hd) -> [H*hd, D]
                v = v.reshape(v.shape[0], -1).T
            elif parts[-2] == "out" and v.ndim == 3:   # (H, hd, D) -> [D, H*hd]
                v = v.reshape(-1, v.shape[-1]).T
            else:
                v = v.T
            sd[f"{module}.weight"] = v
        elif leaf == "bias":
            sd[f"{module}.bias"] = v.reshape(-1)
        else:                                          # latents, LayerNorm scale
            sd[f"{module}.{leaf}"] = v
    if lstm:
        sd["core.weight_ih"] = np.concatenate([lstm[(f"i{g}", "kernel")] for g in _LSTM_GATES],
                                              axis=1).T
        sd["core.weight_hh"] = np.concatenate([lstm[(f"h{g}", "kernel")] for g in _LSTM_GATES],
                                              axis=1).T
        sd["core.bias"] = np.concatenate([lstm[(f"h{g}", "bias")] for g in _LSTM_GATES])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def state_dict_to_flax(sd: dict, num_heads: int) -> dict:
    """The port's ``state_dict`` -> the flax parameter tree
    ``{"params": {...}}`` of numpy float32 arrays (the inverse of
    :func:`flax_to_state_dict`; ``num_heads`` shapes the attention
    kernels)."""
    flat = {}
    for name, t in sd.items():
        v = t.detach().float().cpu().numpy()
        parts = name.split(".")
        if name in _LSTM_LEAVES:
            H = v.shape[0] // 4
            for gi, g in enumerate(_LSTM_GATES):
                rows = v[gi * H:(gi + 1) * H]
                if parts[1] == "weight_ih":
                    flat[f"core/lstm/i{g}/kernel"] = rows.T
                elif parts[1] == "weight_hh":
                    flat[f"core/lstm/h{g}/kernel"] = rows.T
                else:
                    flat[f"core/lstm/h{g}/bias"] = rows
            continue
        if parts[-1] == "embedding":
            flat["token_embed/Embed_0/embedding"] = v
            continue
        module, leaf = "/".join(parts[:-1]), parts[-1]
        attn = len(parts) >= 3 and parts[-3].startswith("xattn_")
        if leaf == "weight":
            if attn and parts[-2] in _ATTN_IN:
                v = v.T.reshape(v.shape[1], num_heads, -1)
            elif attn and parts[-2] == "out":
                v = v.T.reshape(num_heads, -1, v.shape[0])
            else:
                v = v.T
            flat[f"{module}/kernel"] = v
        elif leaf == "bias" and attn and parts[-2] in _ATTN_IN:
            flat[f"{module}/bias"] = v.reshape(num_heads, -1)
        else:
            flat[f"{module}/{leaf}"] = v
    # np.array, not np.ascontiguousarray, which makes a 0-d leaf (alpha_main) 1-d
    return {"params": unflatten_tree({k: np.array(v, order="C") for k, v in flat.items()})}
