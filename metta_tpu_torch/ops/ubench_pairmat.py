"""Pair-mat micro-benchmarks (S2): CUDA kernel and plain versions.

Counterpart of ``scripts/ubench_pairmat.py`` (the nine Pallas cases
:29-:117): each repeats one layout primitive of the fused sim kernel REP
times over x [A=24, E] int32 and writes [24, E] int32. The kernel
(``csrc/ubench_pairmat.cu``) takes a thread per element in the six cases
that use only their own agent's value, and K2's formulation (a warp per env,
lane = agent, warp shuffles and reduce, x staged through shared memory) in
the three that need the env's other agents (``WARP_PER_ENV``). ``EXTRAS``
are two launches that are no TPU case, timed beside the cases:
``pair_full_match``, pair_full by K2's warp match, and ``load_store``, the
thread-per-element grid that only copies x.
The plain versions repeat the TPU bodies' arithmetic in torch ops, loop for
loop.

``tdiv`` runs, on the card, the TPU body's float32 route with n's
reciprocal taken once where that is exact, |x + i| < ``TDIV_LIMIT`` at
every rep, and the IEEE divide elsewhere (``csrc/ubench_pairmat.cu`` says
why): it equals the plain version on the card for every int32 x. The plain
version on the CPU differs from it only for n = 1 and |x + i| >= 2^31 - 64,
where the quotient 2^31 converts to INT_MAX on the card and INT_MIN on x86.
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.ops.build import check_tensor

A, EL, NA, REP = 24, 128, 88, 32
CASES = ("elemwise", "flat", "bT", "bA", "pair_full", "red_a", "repeat_na", "iota_div", "tdiv")
EXTRAS = ("pair_full_match", "load_store")    # the kernel's entries after CASES, in order
WARP_PER_ENV = ("bT", "pair_full", "red_a", "pair_full_match")
# The kernel's blocks: THREADS envs of one agent row (thread per element), or
# ENVS envs, a warp each (WARP_PER_ENV)
THREADS, ENVS = 256, 32
TDIV_REPS = REP * 8
TDIV_LIMIT = 2 ** 23                # |x + i| below it at every rep: the reciprocal route
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


def corrected_quotient(aa, q0, n):
    """The TPU body's correction of a quotient estimate: ``q0`` within 1 of
    trunc(aa / n) (aa >= 0, n >= 1) -> trunc(aa / n) exactly."""
    r0 = aa - q0 * n
    return q0 + (r0 >= n).to(q0.dtype) - (r0 < 0).to(q0.dtype)


def plain(case: str, x):
    """Case ``case`` (or an extra) in torch ops, as the TPU body computes
    it -> [A, E] int32."""
    if case == "pair_full_match":
        case = "pair_full"
    if case == "load_store":
        return x.clone()
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
        for i in range(TDIV_REPS):
            a = x + i
            aa = a.abs()
            q = corrected_quotient(aa, (aa.to(torch.float32) / n.to(torch.float32))
                                   .to(torch.int32), n)
            acc = acc + torch.where(a >= 0, q, -q)
    else:
        raise ValueError(f"unknown case {case!r}; known: {CASES + EXTRAS}")
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
    """Case ``case`` (or an extra) on x [24, E] int32: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    global launches
    if case not in CASES + EXTRAS:
        raise ValueError(f"unknown case {case!r}; known: {CASES + EXTRAS}")
    if x.device.type == "cpu":
        return plain(case, x)
    E = x.shape[1]
    check_tensor("x", x, torch.int32, (A, E), x.device)
    out = torch.empty_like(x)
    if E == 0:
        return out
    with torch.cuda.device(x.device):
        err = _library().pairmat_launch(x.data_ptr(), out.data_ptr(), E,
                                        (CASES + EXTRAS).index(case),
                                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairmat {case} launch failed: CUDA error {err}")
    launches += 1
    return out
