"""Host-side plans of the port's persistent kernels, on the CPU.

K1 (``csrc/obs_render3.cu``) and S1's GEMMs (``csrc/ubench_gemm.cu``) walk
their work from a persistent grid; ``ops/obs_render3.py:render_schedule``
and ``ops/ubench_mosaic.py:gemm_schedule`` are those schedules as pure
functions, and ``gemm_boxes`` the TMA boxes that cover a GEMM's depth. Each
schedule must give every agent, or every (g, tile) pair, to exactly one
warp or block, at the shapes of ``tests/test_torch_cuda.py`` and of
``chip_smoke.py`` phase 13, including grids larger than the work; the boxes
must tile the depth with zero fill only past it. The kernels themselves are
held to their plain versions on the card (``tests/test_torch_cuda.py``).
"""

import pytest

from metta_tpu_torch.ops import obs_render3 as k1
from metta_tpu_torch.ops import ubench_mosaic as s1

SMS = 132                                          # an H100 SXM's SMs


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
