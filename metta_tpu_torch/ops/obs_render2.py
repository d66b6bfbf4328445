"""Batched token-observation render, v2 (kernel K4): CUDA kernel and plain version.

Counterpart of ``metta_tpu/ops/obs_render2.py`` (the Pallas kernel
``_obs2_kernel`` behind ``render_obs_pallas2``). The same function as K1
(``ops/obs_render3.py``), byte for byte: every agent's global tokens, then the
tokens of its window cells in center-out order, truncated at T, EMPTY after.
K4 keeps its own formulation: the window is walked in row-major order, each
cell's first output slot is a prefix sum of the token counts taken in the
center-out *rank* of the cells (a rank table in place of the TPU kernel's
rank matrix), and each cell's tokens are scattered to their slots.

- :func:`rank_table` is the [S] rank of every row-major window cell.
- :func:`render_obs2` is the kernel's wrapper. A CUDA tensor launches the
  kernel in ``csrc/obs_render2.cu`` (or raises); a CPU tensor takes
  :func:`render_obs2_plain`, the same formulation in torch ops.
- :func:`render2_grid`, :func:`render2_schedule` and
  :func:`render2_smem_bytes` mirror the kernel's persistent plan: its
  blocks, which (env, agent) pairs each warp renders, and each block's
  warp-private shared memory.

It reads the outputs of ``ops/obs_render3.py:prep_env3``, as the TPU kernel
reads those of ``prep_core``; with a task set the prep has read each env's
own tables. None of the TPU kernel's limits (A <= 32, block ids <= 128,
``eps`` dividing E) carry over; the kernel takes at most ``MAX_CELLS``
window cells and ``MAX_TOKENS`` tokens a row (where the TPU kernel took 128
window cells).
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.engine.obs import EMPTY
from metta_tpu_torch.ops.build import check_tensor

# Launches of the CUDA kernel, counted by the wrapper where it launches.
launches = 0

# The kernel's plan constants (``csrc/obs_render2.cu``: kThreads / 32, kPass,
# kMaxCells, kMaxTokens)
WARPS = 8           # warps a block, one agent each at a time
PASS = 128          # window cells of a pass: four a lane
MAX_CELLS = 256     # window cells the kernel takes (two passes)
MAX_TOKENS = 2048   # tokens a warp's staging row holds


def rank_table(scan, ww: int):
    """[S] int32: the center-out rank of each row-major window cell
    ``s = (dr + ohr) * ww + (dc + owr)``, from the center-out offsets ``scan``
    [S, 2] (``_rank_tril`` of the JAX module, as a table)."""
    S = scan.shape[0]
    ohr, owr = (S // ww) // 2, ww // 2
    cell = (scan[:, 0].long() + ohr) * ww + (scan[:, 1].long() + owr)
    rank = torch.empty((S,), dtype=torch.int32, device=scan.device)
    return rank.scatter_(0, cell, torch.arange(S, dtype=torch.int32, device=scan.device))


def render_obs2_plain(sb, tok, counts, rc, g_count, g_tok, rank, num_tokens: int,
                      wh: int, ww: int):
    """The render in torch ops, in K4's formulation -> [E, A, T, 3] uint8.

    Row-major window cells read their block ids; the counts, moved into
    rank order, are summed exclusively there, and each cell takes its first
    slot from that sum (after the ``g_count`` global tokens); every token of
    a cell is scattered to its slot, truncated at T; the rest is EMPTY."""
    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    S = wh * ww
    T = num_tokens
    dev = sb.device

    s = torch.arange(S, device=dev)
    j, i = s // ww, s % ww                                              # window row, col
    rr = rc[..., 0:1].long() + (j - wh // 2)                            # [E, A, S]
    cc = rc[..., 1:2].long() + (i - ww // 2)
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)
    b = sb.reshape(E, -1).gather(1, flat.reshape(E, -1)).reshape(E, A, S).long()
    b = torch.where(inb, b, torch.zeros_like(b))
    cnt = counts.gather(1, b.reshape(E, -1)).reshape(E, A, S).long()

    rk = rank.long().expand(E, A, S)
    in_rank = torch.zeros_like(cnt).scatter_(2, rk, cnt)                # counts by rank
    excl = in_rank.cumsum(-1) - in_rank
    start = excl.gather(2, rk) + g_count.long()[..., None]              # [E, A, S]

    k = torch.arange(K, device=dev)
    slot = start[..., None] + k                                         # [E, A, S, K]
    keep = (k < cnt[..., None]) & (slot < T)
    dest = torch.where(keep, slot, torch.full_like(slot, T))            # T: spare slot
    loc = (((j << 4) | i) & 255).to(torch.uint8).expand(E, A, S)[..., None].expand(-1, -1, -1, K)
    ft = tok.reshape(E, NB * K, 2).gather(
        1, (b[..., None] * K + k).reshape(E, -1, 1).expand(-1, -1, 2)
    ).reshape(E, A, S, K, 2)
    vals = torch.cat([loc[..., None], ft], dim=-1)                      # [E, A, S, K, 3]

    out = torch.full((E, A, T + 1, 3), EMPTY, dtype=torch.uint8, device=dev)
    out.scatter_(2, dest.reshape(E, A, -1, 1).expand(-1, -1, -1, 3), vals.reshape(E, A, -1, 3))
    G = g_tok.shape[2]
    g = torch.arange(min(G, T), device=dev)
    is_global = (g < g_count[..., None])[..., None]                     # [E, A, g, 1]
    out[:, :, :g.numel()] = torch.where(is_global, g_tok[:, :, :g.numel()],
                                        out[:, :, :g.numel()])
    return out[:, :, :T]


def render2_grid(E: int, A: int, sms: int, per_sm: int) -> int:
    """Blocks the CUDA kernel launches: one warp an agent, no more blocks
    than the card holds at once (``sms`` x ``per_sm``)."""
    return min(-(-E * A // WARPS), sms * per_sm)


def render2_schedule(E: int, A: int, blocks: int):
    """The (env, agent) pairs each warp of a grid of ``blocks`` renders, in
    order (mirrors ``csrc/obs_render2.cu``): warp w of the grid takes the
    flat agent indices w, w + nw, w + 2 nw, ... (nw = ``WARPS`` x blocks)."""
    nw = WARPS * blocks
    return [[divmod(p, A) for p in range(w, E * A, nw)] for w in range(nw)]


def render2_smem_bytes(S: int, T: int) -> int:
    """A block's dynamic shared memory: each rank slot's location byte (a
    pass of ``PASS`` slots, two past ``PASS`` cells), then each warp's
    counts and block ids by rank slot (an int each) and its staging row (3T
    bytes after up to 3 bytes of word offset, in 16-byte units)."""
    slots = PASS * (1 if S <= PASS else 2)
    return slots + WARPS * (8 * slots + (3 * T + 3 + 15) // 16 * 16)


def check_inputs(sb, tok, counts, rc, g_count, g_tok, rank, wh: int, ww: int,
                 num_tokens: int):
    """Raise ValueError unless the render's inputs are what the kernel takes."""
    if not 1 <= wh * ww <= MAX_CELLS:
        raise ValueError(f"window cells: the kernel takes 1 to {MAX_CELLS}, got {wh}x{ww}")
    if not 1 <= num_tokens <= MAX_TOKENS:
        raise ValueError(f"num_tokens: the kernel takes 1 to {MAX_TOKENS}, got {num_tokens}")
    if sb.shape[0] * rc.shape[1] >= 2**31:
        raise ValueError(f"agents: E x A must stay under 2^31, got {sb.shape[0]} x {rc.shape[1]}")
    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    G = g_tok.shape[2]
    for name, x, dtype, shape in (
        ("sb", sb, torch.int32, (E, H, W)), ("tok", tok, torch.uint8, (E, NB, K, 2)),
        ("counts", counts, torch.int32, (E, NB)), ("rc", rc, torch.int32, (E, A, 2)),
        ("g_count", g_count, torch.int32, (E, A)), ("g_tok", g_tok, torch.uint8, (E, A, G, 3)),
        ("rank", rank, torch.int32, (wh * ww,)),
    ):
        check_tensor(name, x, dtype, shape, sb.device)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("obs_render2")
        lib.obs_render2_launch.restype = ctypes.c_int
        lib.obs_render2_launch.argtypes = (
            [ctypes.c_void_p] * 8                    # sb tok counts rc gcnt gtok rank out
            + [ctypes.c_int] * 10                    # E H W A NB K WH WW G T
            + [ctypes.c_void_p]                      # stream
        )
        lib.obs_render2_shape.restype = ctypes.c_int
        lib.obs_render2_shape.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        _lib = lib
    return _lib


def launch_shape(S: int, T: int):
    """The CUDA kernel's launch shape for S window cells and T tokens on the
    current card: {smem bytes, blocks an SM holds, SMs} (needs the card)."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = _library().obs_render2_shape(S, T, *[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"obs_render2_shape failed: CUDA error {err}")
    return dict(zip(("smem", "per_sm", "sms"), (v.value for v in vals)))


def render_obs2(sb, tok, counts, rc, g_count, g_tok, rank, num_tokens: int,
                wh: int, ww: int):
    """Render [E, A, T, 3] uint8 observations from ``prep_env3``'s outputs
    and :func:`rank_table`: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global launches
    if sb.device.type == "cpu":
        return render_obs2_plain(sb, tok, counts, rc, g_count, g_tok, rank,
                                 num_tokens, wh, ww)
    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    G = g_tok.shape[2]
    T = num_tokens
    check_inputs(sb, tok, counts, rc, g_count, g_tok, rank, wh, ww, T)
    out = torch.empty((E, A, T, 3), dtype=torch.uint8, device=sb.device)
    if E == 0:
        return out
    lib = _library()
    with torch.cuda.device(sb.device):
        err = lib.obs_render2_launch(
            sb.data_ptr(), tok.data_ptr(), counts.data_ptr(), rc.data_ptr(),
            g_count.data_ptr(), g_tok.data_ptr(), rank.data_ptr(), out.data_ptr(),
            E, H, W, A, NB, K, wh, ww, G, T,
            torch.cuda.current_stream(sb.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"obs_render2 kernel launch failed: CUDA error {err}")
    launches += 1
    return out
