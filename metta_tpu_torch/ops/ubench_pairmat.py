"""Pair-mat micro-benchmarks (S2): CUDA kernel and plain versions.

Counterpart of ``scripts/ubench_pairmat.py`` (the nine Pallas cases
:29-:117): each repeats one layout primitive of the fused sim kernel REP
times over x [A=24, E] int32 and writes [24, E] int32. The kernel
(``csrc/ubench_pairmat.cu``) takes K2's formulation: one warp per env,
lane = agent, shuffles over the env's lanes. The plain versions repeat the
TPU bodies' arithmetic in torch ops, loop for loop.
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.ops.build import check_tensor

A, EL, NA, REP = 24, 128, 88, 32
CASES = ("elemwise", "flat", "bT", "bA", "pair_full", "red_a", "repeat_na", "iota_div", "tdiv")
# int32 operations of the TPU body per output element, for the bound
OPS_PER_ELEMENT = {
    "elemwise": 2 * REP * 24,              # compare, add
    "flat": 2 * REP,
    "bT": 2 * REP,
    "bA": 2 * REP,
    "pair_full": REP * (1 + 2 * A),        # x + i, then A compares and adds
    "red_a": REP * 3,                      # x + i, its share of the column sum, add
    "repeat_na": (REP // 8) * (1 + NA),
    "iota_div": REP * 4,                   # iota, divide, compare, add
    "tdiv": REP * 8 * 12,                  # abs, two converts, divide, multiply, ...
}

# Launches of the CUDA kernel, counted by the wrapper where it launches.
launches = 0


def plain(case: str, x):
    """Case ``case`` in torch ops, as the TPU body computes it -> [A, E] int32."""
    acc = torch.zeros_like(x)
    if case == "elemwise":
        for i in range(REP * 24):
            acc = acc + (x > i).to(torch.int32)
    elif case in ("flat", "bA"):
        for i in range(REP):
            acc = acc + (x + i)
    elif case == "bT":
        for i in range(REP):
            acc = acc + (x[0:1] + i).expand_as(x)
    elif case == "pair_full":
        for i in range(REP):
            xi = x + i
            acc = acc + (xi[:, None, :] == xi[None, :, :]).sum(1, dtype=torch.int32)
    elif case == "red_a":
        for i in range(REP):
            acc = acc + (x + i).sum(0, keepdim=True, dtype=torch.int32).expand_as(x)
    elif case == "repeat_na":
        for i in range(max(REP // 8, 1)):
            s = torch.zeros_like(x)
            for _ in range(NA):
                s = s + (x + i)
            acc = acc + s
    elif case == "iota_div":
        for i in range(REP):
            blk = 0                          # iota // EL over the first lane block
            acc = acc + (x + i == blk).to(torch.int32)
    elif case == "tdiv":
        n = (x & 7) + 1
        for i in range(REP * 8):
            a = x + i
            aa = a.abs()
            q0 = (aa.to(torch.float32) / n.to(torch.float32)).to(torch.int32)
            r0 = aa - q0 * n
            q = q0 + (r0 >= n).to(torch.int32) - (r0 < 0).to(torch.int32)
            acc = acc + torch.where(a >= 0, q, -q)
    else:
        raise ValueError(f"unknown case {case!r}; known: {CASES}")
    return acc


_lib = None


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("ubench_pairmat")
        lib.pairmat_launch.restype = ctypes.c_int
        lib.pairmat_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        _lib = lib
    return _lib


def run(case: str, x):
    """Case ``case`` on x [24, E] int32: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    global launches
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; known: {CASES}")
    if x.device.type == "cpu":
        return plain(case, x)
    E = x.shape[1]
    check_tensor("x", x, torch.int32, (A, E), x.device)
    out = torch.empty_like(x)
    if E == 0:
        return out
    with torch.cuda.device(x.device):
        err = _library().pairmat_launch(x.data_ptr(), out.data_ptr(), E, CASES.index(case),
                                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairmat {case} launch failed: CUDA error {err}")
    launches += 1
    return out
