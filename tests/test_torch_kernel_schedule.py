"""Host-side plans of the port's persistent kernels, on the CPU.

K1 (``csrc/obs_render3.cu``), K2 (``csrc/sim_fused.cu``) and S1's GEMMs
(``csrc/ubench_gemm.cu``) walk their work from a persistent grid;
``ops/obs_render3.py:render_schedule``, ``ops/sim_fused.py:span_schedule``
and ``ops/ubench_mosaic.py:gemm_schedule`` are those schedules as pure
functions, and ``gemm_boxes`` the TMA boxes that cover a GEMM's depth. Each
schedule must give every agent, env or (g, tile) pair to exactly one warp
or block, at the shapes of ``tests/test_torch_cuda.py`` and of
``chip_smoke.py``, including grids larger than the work; the boxes must
tile the depth with zero fill only past it. K2's shared memory must fit the
repo's table packs, and the sizes its wrapper enforces must be the
kernel's. The kernels themselves are held to their plain versions on the
card (``tests/test_torch_cuda.py``).
"""

import copy
import pathlib
import re

import pytest

from metta_tpu_torch.builder import envs
from metta_tpu_torch.convert import tables_from_compiled
from metta_tpu_torch.engine.compiler import compile_game
from metta_tpu_torch.ops import obs_render3 as k1
from metta_tpu_torch.ops import sim_fused as k2
from metta_tpu_torch.ops import ubench_mosaic as s1

SMS = 132                                          # an H100 SXM's SMs
SM_SMEM = 233_472                                  # shared memory an H100 SM holds (228 KB)


@pytest.mark.parametrize("Kd,want", [
    (72, [(0, 64, 128), (64, 16, 32)]),
    (144, [(0, 64, 128), (64, 64, 128), (128, 16, 32)]),
    (288, [(0, 64, 128), (64, 64, 128), (128, 64, 128), (192, 64, 128), (256, 32, 64)]),
])
def test_gemm_boxes_tile_the_depth(Kd, want):
    """M6a's depth 72 at eps 1-4 and M6b/c's 144 (eps 2) and 288 (eps 4):
    boxes of 64 (128-byte swizzle), 32 (64-byte) or 16 (32-byte) columns,
    back to back from column 0, each starting inside the depth, zero fill
    under 16 columns and only past Kd."""
    boxes = s1.gemm_boxes(Kd)
    assert boxes == want
    for Kd in range(8, 513, 8):                     # every depth the kernel takes
        boxes = s1.gemm_boxes(Kd)
        ends = [c + w for c, w, _ in boxes]
        assert [c for c, _, _ in boxes] == [0] + ends[:-1]
        assert all(c < Kd for c, _, _ in boxes)
        assert Kd <= ends[-1] < Kd + 16 and ends[-1] % 16 == 0
        assert all(sw == 2 * w and w in (64, 32, 16) for _, w, sw in boxes)


def test_gemm_boxes_refuse_bad_depths():
    for Kd in (0, 12, 70, 520):
        with pytest.raises(ValueError):
            s1.gemm_boxes(Kd)


def test_gemm_stages_fit_shared_memory():
    """Every S1 GEMM shape keeps the kernel's full ring of 8 stages beside B;
    a B too large for two stages is refused."""
    for mats, Kd in ((4, 72), (1, 288), (2, 72), (1, 144)):
        assert s1.gemm_stages(mats, Kd) == 8
    assert s1.gemm_stages(8, 288) == 0


@pytest.mark.parametrize("B,tiles", [
    (256, 24), (256, 96), (256, 12),                 # phase 13: M6a, M6b, M6c at G=1024, eps 4
    (4, 24), (4, 48), (4, 6),                        # the cuda tests: G=8, eps 2
    (2, 3), (1, 1),                                  # F=384; fewer pairs than SMs
])
def test_gemm_schedule_covers_each_pair_once(B, tiles):
    pairs = B * tiles
    blocks = min(pairs, SMS)
    ranges = s1.gemm_schedule(pairs, blocks)
    assert len(ranges) == blocks
    taken = [p for lo, hi in ranges for p in range(lo, hi)]
    assert taken == list(range(pairs))               # each pair once, in g-major order
    for lo, hi in ranges:
        assert hi > lo                               # no idle block
        gs = {p // tiles for p in range(lo, hi)}
        assert len(gs) == (hi - 1) // tiles - lo // tiles + 1   # B loaded once per g
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("E,A,per_sm", [
    (4096, 24, 8),                                   # combat at E=4096 (phases 2, 6, 13)
    (16, 24, 8), (1, 24, 8), (4097, 24, 8),          # the cuda tests, E=1 under the grid
    (6, 40, 8), (4097, 24, 1),                       # A=40; a grid smaller than the agents
])
def test_render_schedule_covers_each_agent_once(E, A, per_sm):
    blocks = k1.render_grid(E, A, SMS, per_sm)
    assert blocks == min(-(-E * A // k1.WARPS), SMS * per_sm)
    plan = k1.render_schedule(E, A, blocks)
    assert len(plan) == blocks * k1.WARPS
    taken = sorted(pair for warp in plan for pair in warp)
    assert taken == [(e, a) for e in range(E) for a in range(A)]
    counts = [len(warp) for warp in plan]
    assert max(counts) - min(counts) <= 1
    if E * A >= len(plan):
        assert min(counts) >= 1                      # no idle warp while agents remain


@pytest.mark.parametrize("E,per_sm", [
    (4096, 4),                                       # combat at E=4096 (phases 3, 6, 13)
    (4097, 4), (5, 4), (1, 4),                       # the cuda tests; E under one block
    (4097, 1),                                       # a grid smaller than the envs
])
def test_span_schedule_covers_each_env_once(E, per_sm):
    blocks = k2.span_grid(E, k2.WARPS, SMS, per_sm)
    assert blocks == min(-(-E // k2.WARPS), SMS * per_sm)
    plan = k2.span_schedule(E, blocks, k2.WARPS)
    assert len(plan) == blocks * k2.WARPS
    assert sorted(e for warp in plan for e in warp) == list(range(E))
    counts = [len(warp) for warp in plan]
    assert max(counts) - min(counts) <= 1
    if E >= len(plan):
        assert min(counts) >= 1                      # no idle warp while envs remain
    if E == 4096 and per_sm == 4:
        assert max(counts) == 1                      # one wave: an env a warp


def _tables(name, agents=24):
    cfg = getattr(envs, f"make_{name}")(agents)
    cfg.game.map_builder.seed = 1234
    compiled, init = compile_game(cfg.game, cfg.game.map_builder.create().build())
    return tables_from_compiled(compiled, init, track_stats=False)


@pytest.mark.parametrize("name", ["combat", "arena"])
def test_span_shared_memory_fits(name):
    """The combat pack (6.6 KB) and the arena's (26.4 KB, V=152) with 8
    warps' rows fit a block, four blocks an SM without gained/lost and three
    with them; the wrapper's size check passes them."""
    t = _tables(name)
    pack, _ = k2.table_pack(t, "cpu")
    n_tab, A, R = pack.numel(), t.num_agents, t.num_resources
    plain = k2.span_smem_bytes(n_tab, A, R, False, k2.WARPS)
    tracked = k2.span_smem_bytes(n_tab, A, R, True, k2.WARPS)
    assert 4 * n_tab < plain < tracked <= k2.SMEM_LIMIT
    assert 4 * plain <= SM_SMEM and 3 * tracked <= SM_SMEM
    k2.check_sizes(t, n_tab)


def test_span_maxima_are_the_kernels():
    """The sizes the wrapper enforces are the constants of the CUDA source
    (the kernel cannot run here to catch a drift), and it refuses each one
    exceeded, by name."""
    src = (pathlib.Path(k2.__file__).parent.parent / "csrc" / "sim_fused.cu").read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kMaxA"], const["kMaxR"], const["kMaxNP"], const["kMaxWarps"]) == (
        k2.MAX_AGENTS, k2.MAX_RESOURCES, k2.MAX_PROTOCOLS, max(k2.ENVS_PER_BLOCK))
    assert k2.WARPS in k2.ENVS_PER_BLOCK
    t = _tables("combat")
    n_tab = k2.table_pack(t, "cpu")[0].numel()
    for name, most in (("num_agents", k2.MAX_AGENTS), ("num_resources", k2.MAX_RESOURCES),
                       ("n_protocols", k2.MAX_PROTOCOLS)):
        big = copy.copy(t)
        setattr(big, name, most + 1)
        with pytest.raises(ValueError, match=name):
            k2.check_sizes(big, n_tab)
    with pytest.raises(ValueError, match="shared memory"):
        k2.check_sizes(t, k2.SMEM_LIMIT // 4)
    for el in (0, 3, 16, 128):
        with pytest.raises(ValueError):
            k2.check_envs_per_block(el)
