"""Primitive micro-benchmarks (S1): inputs, CUDA kernels and plain versions.

Counterpart of ``scripts/ubench_mosaic.py`` (its Pallas kernels, ``pallas_call``
at :42, :125, :170, :190, :206). Ten cases at grid G, ``reps`` repeats and
EPS envs a step (EA = 24 EPS rows); ``csrc/ubench_mosaic.cu`` says what each
computes (:func:`fold_schedule` mirrors the chunks of its fold, M1 and M1b),
and ``csrc/ubench_gemm.cu`` holds the three GEMMs (TMA and wgmma;
:func:`gemm_boxes` and :func:`gemm_schedule` mirror its depth boxes and its
block schedule). Every case returns (slots, checksum): ``slots[g]`` is what
grid step g writes (the TPU output is the last step's, ``slots[-1]``), and
the checksum covers what the TPU output drops (int32 sums of float bits, or
float32 sums of the GEMMs' row tiles; None where nothing is dropped).

Inputs come from a numpy seed: floats (u + 0.5) / 128 and bf16
(2u - 255) / 128 for random bytes u, all exact in their types, and the
M3 shifts in [0, 128).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from metta_tpu_torch.ops.build import check_tensor

CASES = ("M5", "M1", "M1b", "M2", "M3", "M4", "M6a", "M6b", "M6c", "M7")
GEMMS = ("M6a", "M6b", "M6c")
F, HP, WP, FR = 3072, 72, 128, 384          # the GEMMs' rows, depth, width; M6c's rows
NSHIFT, COPIES, COLS = 24, 11, 640
PER_LANE = COLS // 32                        # M7's columns a lane holds: lane + 32 k

# Launches of the CUDA kernels, counted by the wrapper where it launches:
# ``launches`` those of csrc/ubench_mosaic.cu, ``launches_gemm`` the GEMMs'.
launches = 0
launches_gemm = 0

# The GEMM kernel's shared memory (mirrors csrc/ubench_gemm.cu): a ring of at
# most 8 stages of 16 KB, B whole (nE x padded depth x 128 bf16), barriers.
GEMM_STAGE_BYTES, GEMM_MAX_STAGES, GEMM_SMEM_LIMIT = 16384, 8, 232448
GEMM_MAX_DEPTH = 512
# The fold's chunk: floats a stage holds, one bulk copy (csrc/ubench_mosaic.cu:kFoldChunk).
FOLD_CHUNK = 4096
# M2's rows a block stages in shared memory (csrc/ubench_mosaic.cu:kTrMaxRows).
TR_MAX_ROWS = 256
# M3's rows: a multiple of ROLL_ROWS (the rows a block's threads carry at
# once, kRollRowStep x kRollPerThread), at most ROLL_MAX_ROWS (kRollMaxRows).
ROLL_ROWS, ROLL_MAX_ROWS = 16, 64


def _bytes(rng, shape, device):
    u = rng.integers(0, 256, size=shape, dtype=np.uint8)
    return torch.from_numpy(u).to(device)


def make_inputs(case: str, G: int, eps: int, seed: int, device="cuda"):
    """The case's inputs, from ``seed`` with numpy, as a tuple of tensors."""
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; known: {CASES}")
    rng = np.random.default_rng([seed, CASES.index(case)])
    EA = 24 * eps

    def f32(*shape):
        return (_bytes(rng, shape, device).float() + 0.5) / 128

    def bf16(*shape):
        return ((2 * _bytes(rng, shape, device).float() - 255) / 128).to(torch.bfloat16)

    if case in ("M5", "M4"):
        return (f32(G, 264, 128),)
    if case == "M1":
        return (f32(G, 264 * 16, 128),)
    if case == "M1b":
        return (f32(G, EA * 11, 128),)
    if case == "M2":
        return (f32(G, EA, 128),)
    if case == "M3":
        shifts = torch.from_numpy(rng.integers(0, 128, size=(1, NSHIFT), dtype=np.int32))
        return f32(G, 16, 128), shifts.to(device)
    if case == "M6a":
        return bf16(G // eps, eps, F, HP), bf16(G // eps, eps, HP, WP)
    if case == "M6b":
        return bf16(G // eps, eps * F, eps * HP), bf16(G // eps, eps * HP, WP)
    if case == "M6c":
        return bf16(G // eps, eps * FR, eps * HP), bf16(G // eps, eps * HP, WP)
    return (f32(G, EA, COLS),)                                        # M7


def bitsum(t):
    """[G] int32: per leading index, the wrapping sum of the float32 bit patterns."""
    s = t.contiguous().view(torch.int32).reshape(t.shape[0], -1).long().sum(1)
    return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _gemm_plain(a, b):
    """The GEMM in float32 (bf16 products are exact; sums in f32, TF32 as the
    caller set it) -> (rows :128 [B, 128, 128], row-tile sums [B, rows/128])."""
    r = torch.matmul(a.float(), b.float())
    if r.dim() == 4:                                                   # M6a: sum over EPS
        r = r.sum(1)
    B, rows = r.shape[:2]
    return r[:, :128].contiguous(), r.reshape(B, rows // 128, -1).sum(-1)


def gemm_boxes(Kd: int):
    """The TMA boxes that cover a GEMM's depth Kd (a multiple of 8), as
    csrc/ubench_gemm.cu:make_plan picks them: [(first column, width, swizzle
    bytes)]. 64-wide boxes (128-byte swizzle) while 64 columns are left, then
    the rest r: a 16-wide box (32-byte swizzle) for r <= 16, 32-wide (64-byte)
    for r <= 32, 32 + 16 for r <= 48, else 64. TMA zero-fills a box's columns
    past Kd: fewer than 16 of them (72 -> 80, not 128). The kernel takes at
    most 8 boxes, a depth of at most 512."""
    if Kd <= 0 or Kd % 8 or Kd > GEMM_MAX_DEPTH:
        raise ValueError(f"GEMM depth must be a multiple of 8 in [8, {GEMM_MAX_DEPTH}], "
                         f"got {Kd}")
    boxes, c = [], 0

    def add(w):
        nonlocal c
        boxes.append((c, w, 2 * w))
        c += w

    while Kd - c >= 64:
        add(64)
    r = Kd - c
    for w in ((64,) if r > 48 else (32, 16) if r > 32 else (32,) if r > 16
              else (16,) if r > 0 else ()):
        add(w)
    return boxes


def gemm_stages(nE: int, Kd: int) -> int:
    """Ring stages the GEMM kernel gets for nE matrices of depth Kd: as many
    of its 8 as fit beside B in a block's shared memory (it needs 2)."""
    kpad = sum(w for _, w, _ in gemm_boxes(Kd))
    for stages in range(GEMM_MAX_STAGES, 0, -1):
        if (1024 + stages * GEMM_STAGE_BYTES + nE * kpad * 256 + 8 * (2 * stages + 2)
                + 64 <= GEMM_SMEM_LIMIT):
            return stages
    return 0


def gemm_schedule(pairs: int, blocks: int):
    """The (g, 128-row tile) pairs each block of the GEMM kernel takes, in
    g-major order: block i the range [i P / nb, (i + 1) P / nb), consecutive
    tiles of one g (so it loads that g's B once). The kernel launches
    ``min(pairs, SMs)`` blocks (one an SM). Mirrors csrc/ubench_gemm.cu."""
    return [(pairs * i // blocks, pairs * (i + 1) // blocks) for i in range(blocks)]


def fold_schedule(G: int, n: int, blocks: int):
    """The chunks each block of the fold kernel takes, as (g, first element,
    length): the G x ceil(n / FOLD_CHUNK) chunks in g-major order, FOLD_CHUNK
    elements each but the last of each g, block i the range [i C / nb,
    (i + 1) C / nb) of the C chunks. The kernel launches min(C, SMs x blocks
    an SM) blocks. Mirrors csrc/ubench_mosaic.cu:fold_chunk."""
    per_g = -(-n // FOLD_CHUNK)
    total = G * per_g

    def chunk(c):
        g, j = divmod(c, per_g)
        return g, j * FOLD_CHUNK, min(FOLD_CHUNK, n - j * FOLD_CHUNK)
    return [[chunk(c) for c in range(total * i // blocks, total * (i + 1) // blocks)]
            for i in range(blocks)]


def compact_roll_sources(b: int):
    """[32, PER_LANE] int64: for the register k of lane l that M7's stage b
    (a roll left by 2^b) fills, the column of the row it takes, by the
    kernel's index map (mirrors ``csrc/ubench_mosaic.cu:compact_stage``):
    lane l holds columns l + 32 k; a roll by 32 m renames register k to k + m
    (mod PER_LANE); a roll by s < 32 shuffles from lane (l + s) & 31, whose
    register k + 1 (mod PER_LANE) where that lane is below s (its receiver
    wraps past lane 31), else its register k."""
    sh = 1 << b
    lane = torch.arange(32)[:, None].expand(32, PER_LANE)
    k = torch.arange(PER_LANE)[None, :].expand(32, PER_LANE)
    if sh >= 32:
        src_lane, src_k = lane, (k + sh // 32) % PER_LANE
    else:
        src_lane = (lane + sh) & 31
        src_k = torch.where(src_lane < sh, (k + 1) % PER_LANE, k)
    return src_lane + 32 * src_k


def plain(case: str, inputs, reps: int):
    """Case ``case`` in torch ops, rep for rep as the TPU body -> (slots, checksum)."""
    x = inputs[0]
    G = x.shape[0]
    if case == "M5":
        acc = x.clone()
        for _ in range(reps):
            acc = acc + 1.0
        return acc, None
    if case in ("M1", "M1b"):
        width = 2048 if case == "M1" else 128 * COPIES
        v = x.reshape(G, -1, width)
        acc = torch.zeros_like(v)
        for _ in range(reps):
            acc = acc + v
        return acc[..., :128].contiguous(), bitsum(acc[..., 128:])
    if case == "M2":
        acc = torch.zeros_like(x.transpose(1, 2))
        for _ in range(reps):
            acc = acc + x.transpose(1, 2)
        return acc.contiguous(), None
    if case == "M3":
        shifts = inputs[1].reshape(-1).tolist()
        acc = torch.zeros_like(x)
        for i in range(reps):
            acc = acc + torch.roll(x, shifts[i % len(shifts)], dims=2)
        return acc, None
    if case == "M4":
        tiled = x.repeat(1, COPIES, 1)
        acc = torch.zeros_like(tiled)
        for _ in range(reps):
            acc = acc + tiled
        return acc[:, :x.shape[1]].contiguous(), bitsum(acc[:, x.shape[1]:])
    if case in GEMMS:
        return _gemm_plain(*inputs)
    if case == "M7":
        v, d = x.clone(), x * 0.5
        for _ in range(reps):
            for b in range(10):
                sv = torch.roll(v, -(1 << b), dims=2)
                sd = torch.roll(d, -(1 << b), dims=2)
                m = sd > 0.5
                v = torch.where(m, sv, v)
                d = torch.where(m, sd - float(1 << b), d)
        return v[..., :128].contiguous(), bitsum(v[..., 128:])
    raise ValueError(f"unknown case {case!r}; known: {CASES}")


def work(case: str, G: int, eps: int, reps: int):
    """(bytes, operations, type) the case must move and do: each input read
    once, each output written once; float32 adds and selects, or the GEMMs'
    bf16 tensor-core FLOPs at the real depth (72, not the padded 80)."""
    EA = 24 * eps
    if case in GEMMS:
        rows = {"M6a": F, "M6b": eps * F, "M6c": eps * FR}[case]
        depth = HP if case == "M6a" else eps * HP
        per = G // eps
        mats = eps if case == "M6a" else 1
        nbytes = 2 * per * mats * (rows * depth + depth * WP) + 4 * per * (128 * WP + rows // 128)
        return nbytes, 2 * per * mats * rows * depth * WP, "bf16"
    elems = {"M5": 264 * 128, "M1": 264 * 16 * 128, "M1b": EA * 11 * 128, "M2": EA * 128,
             "M3": 16 * 128, "M4": 264 * 128, "M7": EA * COLS}[case]
    out = {"M1": 264 * 128, "M1b": EA * 128, "M7": EA * 128}.get(case, elems)
    ops = {"M4": elems * COPIES * reps, "M7": elems * 10 * reps * 4}.get(case, elems * reps)
    extra = 4 * NSHIFT if case == "M3" else 0
    return 4 * G * (elems + out + (1 if case in ("M1", "M1b", "M4", "M7") else 0)) + extra, \
        G * ops, "f32"


_lib = None
_gemm_lib = None


def _gemm_library():
    global _gemm_lib
    if _gemm_lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("ubench_gemm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mosaic_gemm.restype = ctypes.c_int
        lib.mosaic_gemm.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.ubench_gemm_plan.restype = ctypes.c_int
        lib.ubench_gemm_plan.argtypes = [i, p, p]
        lib.ubench_gemm_shape.restype = ctypes.c_int
        lib.ubench_gemm_shape.argtypes = [i, i, p, p, p, p]
        _gemm_lib = lib
    return _gemm_lib


def gemm_launch_shape(nE: int, Kd: int):
    """The GEMM kernel's launch shape on the current card: {stages, smem
    bytes, blocks an SM holds, SMs} (needs the card)."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = _gemm_library().ubench_gemm_shape(nE, Kd, *[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"ubench_gemm_shape failed: CUDA error {err}")
    return dict(zip(("stages", "smem", "per_sm", "sms"), (v.value for v in vals)))


def fold_launch_shape():
    """The fold kernel's launch shape on the current card: {stages, smem
    bytes, blocks an SM holds, SMs} (needs the card)."""
    vals = [ctypes.c_int() for _ in range(4)]
    err = _library().mosaic_fold_shape(*[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"mosaic_fold_shape failed: CUDA error {err}")
    return dict(zip(("stages", "smem", "per_sm", "sms"), (v.value for v in vals)))


def relayout_launch_shape(case: str, rows: int = 96):
    """M2's or M3's launch shape at ``rows`` (``case="M2"`` or ``"M3"``) or
    M4's on the current card: {threads a block, smem bytes (dynamic), blocks
    an SM holds, SMs} (needs the card)."""
    vals = [ctypes.c_int() for _ in range(4)]
    lib = _library()
    args = [ctypes.byref(v) for v in vals]
    err = (lib.mosaic_transpose_shape(rows, *args) if case == "M2"
           else lib.mosaic_droll_shape(rows, *args) if case == "M3"
           else lib.mosaic_rep_shape(*args))
    if err != 0:
        raise RuntimeError(f"{case}'s launch shape failed: CUDA error {err}")
    return dict(zip(("threads", "smem", "per_sm", "sms"), (v.value for v in vals)))


def gemm_boxes_built(Kd: int):
    """The depth boxes as the built kernel library picks them (needs the
    card's toolchain): [(first column, width)]."""
    col, width = (ctypes.c_int * 16)(), (ctypes.c_int * 16)()
    n = _gemm_library().ubench_gemm_plan(Kd, col, width)
    return [(col[j], width[j]) for j in range(n)]


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("ubench_mosaic")
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
        for name, args in (
            ("mosaic_tiny", [p, p, i, i, i, s]),
            ("mosaic_fold", [p, p, p, i, i, i, i, s]),
            ("mosaic_transpose", [p, p, i, i, i, s]),
            ("mosaic_droll", [p, p, p, i, i, i, i, s]),
            ("mosaic_rep", [p, p, p, i, i, i, s]),
            ("mosaic_compact", [p, p, p, i, i, i, s]),
            ("mosaic_fold_shape", [p, p, p, p]),
            ("mosaic_transpose_shape", [i, p, p, p, p]),
            ("mosaic_droll_shape", [i, p, p, p, p]),
            ("mosaic_rep_shape", [p, p, p, p]),
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def run(case: str, inputs, reps: int):
    """Case ``case``: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors -> (slots, checksum)."""
    global launches, launches_gemm
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; known: {CASES}")
    x = inputs[0]
    if x.device.type == "cpu":
        return plain(case, inputs, reps)
    dev = x.device
    G = x.shape[0]
    f32, i32 = torch.float32, torch.int32
    stream = torch.cuda.current_stream(dev).cuda_stream
    cks = None
    if case in GEMMS:
        a, b = inputs
        mats = a.shape[1] if case == "M6a" else 1
        rows, depth = a.shape[-2], a.shape[-1]
        check_tensor("a", a, torch.bfloat16, (G, mats, rows, depth) if case == "M6a"
                     else (G, rows, depth), dev)
        check_tensor("b", b, torch.bfloat16, (G, mats, depth, WP) if case == "M6a"
                     else (G, depth, WP), dev)
        if rows % 128 or depth % 8:
            raise ValueError(f"{case}: rows must be a multiple of 128 and depth of 8, "
                             f"got {rows}, {depth}")
        if gemm_stages(mats, depth) < 2:                    # (gemm_boxes refuses depth > 512)
            raise ValueError(f"{case}: B ({mats} x {depth} x {WP}) does not fit the "
                             f"kernel's shared memory beside two stages")
        if a.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError(f"{case}: a and b must be 16-byte aligned (TMA)")
        out = torch.empty((G, 128, WP), dtype=f32, device=dev)
        cks = torch.empty((G, rows // 128), dtype=f32, device=dev)
        with torch.cuda.device(dev):
            err = _gemm_library().mosaic_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                              cks.data_ptr(), G, mats, rows, depth, stream)
    else:
        lib = _library()
        check_tensor("x", x, f32, tuple(x.shape), dev)
        n = x[0].numel()
        with torch.cuda.device(dev):
            if case == "M5":
                if x.data_ptr() % 16:
                    raise ValueError("M5: x must be 16-byte aligned (16-byte vector loads)")
                out = torch.empty_like(x)
                err = lib.mosaic_tiny(x.data_ptr(), out.data_ptr(), G, n, reps, stream)
            elif case in ("M1", "M1b"):
                width = 2048 if case == "M1" else 128 * COPIES
                if n % width or x.data_ptr() % 16:
                    raise ValueError(f"{case}: x[g] must hold whole rows of {width} and x be "
                                     f"16-byte aligned (bulk copies)")
                out = torch.empty((G, n // width, 128), dtype=f32, device=dev)
                cks = torch.zeros((G,), dtype=i32, device=dev)     # the kernel adds into it
                err = lib.mosaic_fold(x.data_ptr(), out.data_ptr(), cks.data_ptr(), G, n, width,
                                      reps, stream)
            elif case == "M2":
                if x.dim() != 3 or x.shape[2] != 128 or not 0 < x.shape[1] <= TR_MAX_ROWS:
                    raise ValueError(f"M2 takes [G, rows, 128] with rows <= {TR_MAX_ROWS} (a "
                                     f"block stages rows x 32 in shared memory), got "
                                     f"{tuple(x.shape)}")
                if x.data_ptr() % 16:
                    raise ValueError("M2: x must be 16-byte aligned (16-byte vector loads)")
                out = torch.empty((G, 128, x.shape[1]), dtype=f32, device=dev)
                err = lib.mosaic_transpose(x.data_ptr(), out.data_ptr(), G, x.shape[1], reps,
                                           stream)
            elif case == "M3":
                shifts = inputs[1]
                check_tensor("shifts", shifts, i32, (1, NSHIFT), dev)
                if x.dim() != 3 or x.shape[2] != 128 or x.shape[1] % ROLL_ROWS or \
                        not 0 < x.shape[1] <= ROLL_MAX_ROWS:
                    raise ValueError(f"M3 takes [G, rows, 128] with rows a multiple of "
                                     f"{ROLL_ROWS} up to {ROLL_MAX_ROWS} (a block stages x[g] in "
                                     f"shared memory, {ROLL_ROWS} rows at a time), got "
                                     f"{tuple(x.shape)}")
                if x.data_ptr() % 16:
                    raise ValueError("M3: x must be 16-byte aligned (16-byte vector loads)")
                out = torch.empty_like(x)
                err = lib.mosaic_droll(x.data_ptr(), shifts.data_ptr(), out.data_ptr(), G,
                                       x.shape[1], NSHIFT, reps, stream)
            elif case == "M4":
                if n % 128 or x.data_ptr() % 16 or G * n // 4 >= 2 ** 31:
                    raise ValueError("M4: x must be 16-byte aligned and hold under 2^31 "
                                     "16-byte vectors, x[g] whole rows of 128 floats (16-byte "
                                     "vector loads, whole warps a g)")
                out = torch.empty_like(x)
                cks = torch.zeros((G,), dtype=i32, device=dev)     # the kernel adds into it
                err = lib.mosaic_rep(x.data_ptr(), out.data_ptr(), cks.data_ptr(), G, n, reps,
                                     stream)
            else:                                                      # M7
                if x.shape[2] != COLS:
                    raise ValueError(f"M7 takes [G, rows, {COLS}], got {tuple(x.shape)}")
                out = torch.empty((G, x.shape[1], 128), dtype=f32, device=dev)
                cks = torch.empty((G,), dtype=i32, device=dev)
                err = lib.mosaic_compact(x.data_ptr(), out.data_ptr(), cks.data_ptr(), G,
                                         x.shape[1], reps, stream)
    if err != 0:
        raise RuntimeError(f"ubench_mosaic {case} launch failed: CUDA error {err}")
    if case in GEMMS:
        launches_gemm += 1
    else:
        launches += 1
    return out, cks
