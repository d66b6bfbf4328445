"""Sim-kernel smoke check (S3): CUDA kernel and plain version.

Counterpart of ``scripts/smoke_sim_kernel.py`` (the Pallas kernel
``kernel`` :31). For r [A, E] and inv [R, A, E] int32:
``out1[a, e] = #{t: r[t, e] == r[a, e]} + #{a': r[a', e] == r[a, e]}`` and
``out2 = min(sum_k inv[k], 7)``, both [A, E] int32, for any A up to
``MAX_AGENTS``, any E and any R. The kernel (``csrc/smoke_sim.cu``)
exercises K2's warp primitives (a warp per env, lane = agent, shuffles over
the env's lanes, shared-memory atomics and a ballot mask) after one round
trip of coalesced loads: ``ENVS`` envs a block, r staged through shared
memory, out2 summed where inv is loaded, and in step k of A each lane
compares with lane (a + k) mod A, so that a step's atomics hit distinct
words.
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.ops.build import check_tensor

A, R = 24, 10                       # the script's agents and inventory rows
MAX_AGENTS = 32                     # a warp's lanes: one warp per env
ENVS = 4                            # the kernel's envs a block, a warp each

# Launches of the CUDA kernel, counted by the wrapper where it launches.
launches = 0


def smoke_sim_plain(r, inv):
    """The check in torch ops -> (out1, out2), [A, E] int32 each."""
    eq = (r[:, None, :] == r[None, :, :]).to(torch.int32)              # [a, t, e]
    out1 = eq.sum(1, dtype=torch.int32) + eq.sum(0, dtype=torch.int32)
    out2 = inv.sum(0, dtype=torch.int32).clamp(max=7)
    return out1, out2


_lib = None


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("smoke_sim")
        lib.smoke_sim_launch.restype = ctypes.c_int
        lib.smoke_sim_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                         + [ctypes.c_void_p])
        _lib = lib
    return _lib


def smoke_sim(r, inv):
    """(out1, out2) for r [A, E] and inv [R, A, E] int32: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Refuses more than
    ``MAX_AGENTS`` agents on either."""
    global launches
    a = r.shape[0]
    if a > MAX_AGENTS:
        raise ValueError(f"one warp per env takes at most {MAX_AGENTS} agents, got {a} "
                         f"agents (r's rows)")
    if r.device.type == "cpu":
        return smoke_sim_plain(r, inv)
    E = r.shape[1]
    nr = inv.shape[0]
    check_tensor("r", r, torch.int32, (a, E), r.device)
    check_tensor("inv", inv, torch.int32, (nr, a, E), r.device)
    out1 = torch.empty((a, E), dtype=torch.int32, device=r.device)
    out2 = torch.empty_like(out1)
    if E == 0 or a == 0:
        return out1, out2
    with torch.cuda.device(r.device):
        err = _library().smoke_sim_launch(
            r.data_ptr(), inv.data_ptr(), out1.data_ptr(), out2.data_ptr(), E, a, nr,
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smoke_sim kernel launch failed: CUDA error {err}")
    launches += 1
    return out1, out2
