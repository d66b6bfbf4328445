"""Batched token-observation render: prep, CUDA kernel and plain version.

Counterpart of ``metta_tpu/ops/obs_render3.py`` (``prep_env3`` on
``obs_render2.prep_core``, and the Pallas kernel ``_obs3_kernel`` behind
``render_obs_pallas3``). Reference semantics:
``bindings/mettagrid_c.cpp:397-563``.

- :func:`prep_env3` builds, with torch ops over the whole env batch, what the
  kernel reads: the combined block grid ``sb`` (agent id + 1 where an agent
  stands, else the static block id), the compacted token table of every block
  and its counts, agent positions, and the compacted global tokens. The TPU
  packing tricks (two ``feat<<8|val`` pairs per int32, bf16 grids, 128-lane
  pads) are gone: tokens are plain bytes.
- :func:`render_obs3` is the kernel's wrapper. A CUDA tensor launches the
  kernel in ``csrc/obs_render3.cu`` (or raises); a CPU tensor takes
  :func:`render_obs3_plain`, the same function in torch ops.
  :func:`render_schedule` is the kernel's persistent schedule, which agents
  each warp of its grid renders.
- :func:`supports_v3` (with :func:`pick_eps`) is the JAX package's rule for
  which render a config and env count take: K1 here, else K4
  (``ops/obs_render2.py``).
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


def prep_env3(state, tables, executed_actions, rewards_at_obs):
    """Kernel inputs of one batched render.

    Returns (sb [E, H, W] int32, tok [E, NB, K, 2] uint8, counts [E, NB]
    int32, rc [E, A, 2] int32, g_count [E, A] int32, g_tok [E, A, G, 3]
    uint8). The static block grid ``tables.obs_static_bg`` is one map's
    [H, W] or, for a task set whose maps differ, each env's own [E, H, W]."""
    tok, counts = block_table(state, tables)
    sb = torch.where(state.agent_grid > 0, state.agent_grid,
                     tables.obs_static_bg).to(torch.int32).contiguous()
    g_count, g_tok = global_tokens_all(state, tables, executed_actions, rewards_at_obs)
    rc = torch.stack([state.agent_r, state.agent_c], dim=-1).to(torch.int32).contiguous()
    return sb, tok, counts, rc, g_count.contiguous(), g_tok.contiguous()


LW = 16             # lanes per window row of the TPU kernel's sparse layout
RW = 16             # rows per agent of the TPU kernel's window-read layout


def pick_eps(E: int, want: int = 8):
    """Envs per grid step of the TPU kernel: a multiple of 8 that divides E,
    or E itself up to 8; None when there is none. Copied from
    ``metta_tpu/ops/obs_render3.py:pick_eps``: the port picks its render by
    the JAX package's rule (:func:`supports_v3`), although the CUDA kernels
    have no such limit."""
    if E <= 8:
        return E
    for eps in range(min((want // 8) * 8, (E // 8) * 8), 0, -8):
        if E % eps == 0:
            return eps
    return None


def supports_v3(tables, num_envs=None) -> bool:
    """The JAX package's gate of the v3 render (``metta_tpu/ops/
    obs_render3.py:supports_v3``): where it holds the env renders through K1
    (:func:`render_obs3`), elsewhere through K4 (``ops/obs_render2.py``), as
    the JAX env launches its v3 or v2 TPU kernel."""
    WH = int(tables.obs_height)
    WW = int(tables.obs_width)
    NB = (1 + tables.num_agents + tables.n_object_types
          + tables.n_assembler_slots + tables.n_chest_slots)
    return (
        WH <= RW and WW <= LW and WH * WW <= 128
        and NB <= 128
        and tables.width + LW <= 128
        and tables.height + 2 * (WH // 2) <= 128
        and (num_envs is None or pick_eps(num_envs) is not None)
    )


def render_obs3_plain(sb, tok, counts, rc, g_count, g_tok, scan, num_tokens: int,
                      ohr: int, owr: int):
    """The render in torch ops: window block ids by gather, cell token
    starts by ``cumsum``, and for each output slot its cell by
    ``searchsorted`` -> [E, A, T, 3] uint8.

    Global tokens fill the first ``g_count`` slots, then each window cell's
    tokens in center-out order (the rows of ``scan``), truncated at T; the
    rest is EMPTY. Cells outside the map read block 0 (no tokens)."""
    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    S = scan.shape[0]
    T = num_tokens
    dev = sb.device

    rr = rc[..., 0:1].long() + scan[:, 0].long()                        # [E, A, S]
    cc = rc[..., 1:2].long() + scan[:, 1].long()
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)
    b = sb.reshape(E, -1).gather(1, flat.reshape(E, -1)).reshape(E, A, S).long()
    b = torch.where(inb, b, torch.zeros_like(b))
    cnt = counts.gather(1, b.reshape(E, -1)).reshape(E, A, S).long()
    cum = cnt.cumsum(-1)                                                # inclusive
    cum_excl = cum - cnt

    t = torch.arange(T, device=dev)
    gcnt = g_count.long()[..., None]                                    # [E, A, 1]
    tp = t - gcnt                                                       # object-token index
    seg = torch.searchsorted(cum, tp.contiguous(), right=True).clamp(0, S - 1)
    j = (tp - cum_excl.gather(-1, seg)).clamp(0, K - 1)
    b_t = b.gather(-1, seg)
    obj = tok.reshape(E, NB * K, 2).gather(
        1, (b_t * K + j).reshape(E, -1, 1).expand(-1, -1, 2)
    ).reshape(E, A, T, 2)
    loc_bytes = (((scan[:, 0].long() + ohr) << 4) | (scan[:, 1].long() + owr)) & 255
    loc = loc_bytes.to(torch.uint8)[seg]                                # [E, A, T]
    obj3 = torch.cat([loc[..., None], obj], dim=-1)
    obj_valid = (tp >= 0) & (tp < cum[..., -1:])

    G = g_tok.shape[2]
    is_global = t < gcnt
    glob = g_tok.gather(2, t.clamp(max=G - 1).expand(E, A, T)[..., None].expand(-1, -1, -1, 3))
    out = torch.where(is_global[..., None], glob, obj3)
    return torch.where((is_global | obj_valid)[..., None], out,
                       torch.full_like(out, EMPTY))


def render_grid(E: int, A: int, sms: int, per_sm: int) -> int:
    """Blocks the CUDA kernel launches: one warp an agent, no more blocks
    than the card holds at once (``sms`` x ``per_sm``)."""
    return min(-(-E * A // WARPS), sms * per_sm)


def render_schedule(E: int, A: int, blocks: int):
    """The (env, agent) pairs each warp of a grid of ``blocks`` renders, in
    order (mirrors ``csrc/obs_render3.cu``): warp w of the grid takes the
    flat agent indices w, w + nw, w + 2 nw, ... (nw = ``WARPS`` x blocks), so
    consecutive warps write consecutive rows."""
    nw = WARPS * blocks
    return [[divmod(p, A) for p in range(w, E * A, nw)] for w in range(nw)]


def check_inputs(sb, tok, counts, rc, g_count, g_tok, scan):
    """Raise ValueError unless the render's inputs are what the kernel takes."""
    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    G = g_tok.shape[2]
    for name, x, dtype, shape in (
        ("sb", sb, torch.int32, (E, H, W)), ("tok", tok, torch.uint8, (E, NB, K, 2)),
        ("counts", counts, torch.int32, (E, NB)), ("rc", rc, torch.int32, (E, A, 2)),
        ("g_count", g_count, torch.int32, (E, A)), ("g_tok", g_tok, torch.uint8, (E, A, G, 3)),
        ("scan", scan, torch.int32, (scan.shape[0], 2)),
    ):
        check_tensor(name, x, dtype, shape, sb.device)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("obs_render3")
        lib.obs_render3_launch.restype = ctypes.c_int
        lib.obs_render3_launch.argtypes = (
            [ctypes.c_void_p] * 8                    # sb tok counts rc gcnt gtok scan out
            + [ctypes.c_int] * 10                    # E H W A NB K S G T ohr
            + [ctypes.c_int, ctypes.c_void_p]        # owr stream
        )
        lib.obs_render3_shape.restype = ctypes.c_int
        lib.obs_render3_shape.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        _lib = lib
    return _lib


def launch_shape(S: int, T: int):
    """The CUDA kernel's launch shape for S window cells and T tokens on the
    current card: {smem bytes, blocks an SM holds, SMs} (needs the card)."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = _library().obs_render3_shape(S, T, *[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"obs_render3_shape failed: CUDA error {err}")
    return dict(zip(("smem", "per_sm", "sms"), (v.value for v in vals)))


def render_obs3(sb, tok, counts, rc, g_count, g_tok, scan, num_tokens: int,
                ohr: int, owr: int):
    """Render [E, A, T, 3] uint8 observations from :func:`prep_env3`'s
    outputs: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    global launches
    if sb.device.type == "cpu":
        return render_obs3_plain(sb, tok, counts, rc, g_count, g_tok, scan,
                                 num_tokens, ohr, owr)
    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    S = scan.shape[0]
    G = g_tok.shape[2]
    T = num_tokens
    check_inputs(sb, tok, counts, rc, g_count, g_tok, scan)
    out = torch.empty((E, A, T, 3), dtype=torch.uint8, device=sb.device)
    if E == 0:
        return out
    lib = _library()
    with torch.cuda.device(sb.device):
        err = lib.obs_render3_launch(
            sb.data_ptr(), tok.data_ptr(), counts.data_ptr(), rc.data_ptr(),
            g_count.data_ptr(), g_tok.data_ptr(), scan.data_ptr(), out.data_ptr(),
            E, H, W, A, NB, K, S, G, T, ohr, owr,
            torch.cuda.current_stream(sb.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"obs_render3 kernel launch failed: CUDA error {err}")
    launches += 1
    return out
