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

It reads the outputs of ``ops/obs_render3.py:prep_env3``, as the TPU kernel
reads those of ``prep_core``; with a task set the prep has read each env's
own tables. None of the TPU kernel's limits (window cells <= 128, A <= 32,
block ids <= 128, ``eps`` dividing E) carry over.
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.engine.obs import EMPTY
from metta_tpu_torch.ops.build import check_tensor

# Launches of the CUDA kernel, counted by the wrapper where it launches.
launches = 0


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


def check_inputs(sb, tok, counts, rc, g_count, g_tok, rank, wh: int, ww: int):
    """Raise ValueError unless the render's inputs are what the kernel takes."""
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
        _lib = lib
    return _lib


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
    check_inputs(sb, tok, counts, rc, g_count, g_tok, rank, wh, ww)
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
