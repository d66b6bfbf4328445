"""Per-env token-observation render, v1 (kernel K5): prep, CUDA kernel and plain version.

Counterpart of ``metta_tpu/ops/obs_render.py`` (the Pallas kernel
``_obs_kernel`` behind ``render_obs_pallas``), which the JAX package's
sequential step and reset run when ``tables.obs_renderer == "pl"``. The same
function as the other renders, byte for byte: every agent's global tokens,
then the tokens of its window cells in center-out order, each cell's at the
exclusive prefix sum of the counts before it, truncated at T, EMPTY after.
K5 reads two planes, the agents' (agent id + 1) and the static objects'
block ids, and merges them per cell: the agent's block where one stands,
else the static block.

- :func:`prep_obs1` builds its inputs from the state, as the JAX wrapper
  does: the static block plane from the state's grids
  (``tables.static_block_grid``, not the cached ``obs_static_bg``), the
  block table and counts (``engine/obs.py:block_table``), the compacted
  global tokens.
- :func:`render_obs1` is the kernel's wrapper. A CUDA tensor launches the
  kernel in ``csrc/obs_render.cu`` (or raises); a CPU tensor takes
  :func:`render_obs1_plain`, the same function in torch ops.
  :func:`render_schedule` is the kernel's persistent schedule, which agents
  each warp of its grid renders, and :func:`render1_smem_bytes` its shared
  memory.

The TPU kernel's one-hot GEMMs, strict-lower-triangular cumsum GEMM and
lane-roll anti-diagonals are its way to gather, sum and scatter on the MXU;
none of them carries over. It runs per env under ``vmap``; here one launch
renders the batch.
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.engine.obs import EMPTY, block_table
from metta_tpu_torch.engine.obs_mm import global_tokens_all
from metta_tpu_torch.ops.build import check_tensor

# Launches of the CUDA kernel, counted by the wrapper where it launches.
launches = 0

WARPS = 8           # warps a block of the CUDA kernel, one agent each at a time
PASS = 128          # window cells of a pass: four a lane
SMEM_LIMIT = 232_448  # shared memory a block can use


def prep_obs1(state, tables, executed_actions, rewards_at_obs):
    """Tensor inputs of one render: (agent_grid [E, H, W] int32, sblock
    [E, H, W] int32, tok [E, NB, K, 2] uint8, counts [E, NB] int32, rc
    [E, A, 2] int32, g_count [E, A] int32, g_tok [E, A, G, 3] uint8)."""
    from metta_tpu_torch.engine.tables import static_block_grid

    tok, counts = block_table(state, tables)
    sblock = static_block_grid(tables, state.static_kind, state.static_idx, state.static_type)
    g_count, g_tok = global_tokens_all(state, tables, executed_actions, rewards_at_obs)
    rc = torch.stack([state.agent_r, state.agent_c], dim=-1).to(torch.int32)
    return (state.agent_grid.to(torch.int32).contiguous(), sblock.contiguous(), tok, counts,
            rc.contiguous(), g_count.contiguous(), g_tok.contiguous())


def render_obs1_plain(agent_grid, sblock, tok, counts, rc, g_count, g_tok, scan,
                      num_tokens: int, ohr: int, owr: int):
    """The render in torch ops, in K5's formulation -> [E, A, T, 3] uint8.

    Each window cell in center-out order (the rows of ``scan``) reads its
    block id from the two planes (outside the map: block 0, no tokens) and
    the block's count; the exclusive prefix sum of the counts after the
    ``g_count`` global tokens is the cell's first slot, and its tokens are
    scattered to their slots, truncated at T; the rest is EMPTY."""
    E, H, W = agent_grid.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    S = scan.shape[0]
    T = num_tokens
    dev = agent_grid.device

    rr = rc[..., 0:1].long() + scan[:, 0].long()                        # [E, A, S]
    cc = rc[..., 1:2].long() + scan[:, 1].long()
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = (rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)).reshape(E, -1)
    a_plus1 = agent_grid.reshape(E, -1).gather(1, flat).reshape(E, A, S).long()
    static = sblock.reshape(E, -1).gather(1, flat).reshape(E, A, S).long()
    b = torch.where(inb, torch.where(a_plus1 > 0, a_plus1, static), torch.zeros_like(static))
    n = counts.gather(1, b.reshape(E, -1)).reshape(E, A, S).long()
    start = g_count.long()[..., None] + n.cumsum(-1) - n                # [E, A, S]

    k = torch.arange(K, device=dev)
    slot = start[..., None] + k                                         # [E, A, S, K]
    keep = (k < n[..., None]) & (slot < T)
    dest = torch.where(keep, slot, torch.full_like(slot, T))           # T: spare slot
    loc = (((scan[:, 0].long() + ohr) << 4) | (scan[:, 1].long() + owr)) & 255
    loc = loc.to(torch.uint8)[:, None].expand(S, K).expand(E, A, S, K)
    ft = tok.reshape(E, NB * K, 2).gather(
        1, (b[..., None] * K + k).reshape(E, -1, 1).expand(-1, -1, 2)
    ).reshape(E, A, S, K, 2)
    vals = torch.cat([loc[..., None], ft], dim=-1)                      # [E, A, S, K, 3]

    out = torch.full((E, A, T + 1, 3), EMPTY, dtype=torch.uint8, device=dev)
    out.scatter_(2, dest.reshape(E, A, -1, 1).expand(-1, -1, -1, 3), vals.reshape(E, A, -1, 3))
    G = min(g_tok.shape[2], T)
    is_global = (torch.arange(G, device=dev) < g_count[..., None])[..., None]
    out[:, :, :G] = torch.where(is_global, g_tok[:, :, :G], out[:, :, :G])
    return out[:, :, :T]


def render_grid(E: int, A: int, sms: int, per_sm: int) -> int:
    """Blocks the CUDA kernel launches: one warp an agent, no more blocks
    than the card holds at once (``sms`` x ``per_sm``)."""
    return min(-(-E * A // WARPS), sms * per_sm)


def render_schedule(E: int, A: int, blocks: int):
    """The (env, agent) pairs each warp of a grid of ``blocks`` renders, in
    order (mirrors ``csrc/obs_render.cu``): warp w of the grid takes the
    flat agent indices w, w + nw, w + 2 nw, ... (nw = ``WARPS`` x blocks)."""
    nw = WARPS * blocks
    return [[divmod(p, A) for p in range(w, E * A, nw)] for w in range(nw)]


def check_sizes(S: int, T: int):
    """Raise ValueError unless a block's shared memory holds the kernel's
    arrays for a window of S cells and a row of T tokens."""
    if S < 1 or T < 1 or render1_smem_bytes(S, T) > SMEM_LIMIT:
        raise ValueError(f"a window of {S} cells and num_tokens={T} need "
                         f"{render1_smem_bytes(S, T)} bytes of shared memory a block, over "
                         f"{SMEM_LIMIT} (or none)")


def render1_smem_bytes(S: int, T: int) -> int:
    """A block's shared memory (mirrors ``csrc/obs_render.cu:smem_bytes``):
    the window offsets (8 bytes a cell), each warp's block ids and counts (8
    bytes a cell) and staging row, the cells' location bytes; cells rounded
    up to 4, each array to 16 bytes."""
    sp = (S + 3) & ~3
    return 8 * sp + WARPS * (8 * sp + (3 * T + 3 + 15) // 16 * 16) + (S + 15) // 16 * 16


_lib = None


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("obs_render")
        lib.obs_render_launch.restype = ctypes.c_int
        lib.obs_render_launch.argtypes = (
            [ctypes.c_void_p] * 9                    # grid sblock tok counts rc gcnt gtok scan out
            + [ctypes.c_int] * 11                    # E A H W NB K S G T ohr owr
            + [ctypes.c_void_p]                      # stream
        )
        lib.obs_render_shape.restype = ctypes.c_int
        lib.obs_render_shape.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        _lib = lib
    return _lib


def launch_shape(S: int, T: int):
    """The CUDA kernel's launch shape for S window cells and T tokens on the
    current card: {smem bytes, blocks an SM holds, SMs} (needs the card)."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = _library().obs_render_shape(S, T, *[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"obs_render_shape failed: CUDA error {err}")
    return dict(zip(("smem", "per_sm", "sms"), (v.value for v in vals)))


def render_obs1(agent_grid, sblock, tok, counts, rc, g_count, g_tok, scan, num_tokens: int,
                ohr: int, owr: int):
    """Render [E, A, T, 3] uint8 observations from :func:`prep_obs1`'s
    outputs and the window's center-out offsets ``scan`` [S, 2]: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    global launches
    if agent_grid.device.type == "cpu":
        return render_obs1_plain(agent_grid, sblock, tok, counts, rc, g_count, g_tok, scan,
                                 num_tokens, ohr, owr)
    E, H, W = agent_grid.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    S = scan.shape[0]
    G = g_tok.shape[2]
    T = num_tokens
    dev = agent_grid.device
    check_sizes(S, T)
    for name, x, dtype, shape in (
        ("agent_grid", agent_grid, torch.int32, (E, H, W)),
        ("sblock", sblock, torch.int32, (E, H, W)), ("tok", tok, torch.uint8, (E, NB, K, 2)),
        ("counts", counts, torch.int32, (E, NB)), ("rc", rc, torch.int32, (E, A, 2)),
        ("g_count", g_count, torch.int32, (E, A)), ("g_tok", g_tok, torch.uint8, (E, A, G, 3)),
        ("scan", scan, torch.int32, (S, 2)),
    ):
        check_tensor(name, x, dtype, shape, dev)
    out = torch.empty((E, A, T, 3), dtype=torch.uint8, device=dev)
    if E * A == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.obs_render_launch(
            agent_grid.data_ptr(), sblock.data_ptr(), tok.data_ptr(), counts.data_ptr(),
            rc.data_ptr(), g_count.data_ptr(), g_tok.data_ptr(), scan.data_ptr(),
            out.data_ptr(), E, A, H, W, NB, K, S, G, T, ohr, owr,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"obs_render kernel launch failed: CUDA error {err}")
    launches += 1
    return out
