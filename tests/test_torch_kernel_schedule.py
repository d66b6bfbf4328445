"""Host-side plans of the port's persistent kernels, on the CPU.

K1 (``csrc/obs_render3.cu``), K4 (``csrc/obs_render2.cu``), K5
(``csrc/obs_render.cu``), K2 (``csrc/sim_fused.cu``) and S1's GEMMs
(``csrc/ubench_gemm.cu``) walk their work from a persistent grid;
``ops/obs_render3.py:render_schedule``, ``ops/obs_render2.py:render2_schedule``,
``ops/obs_render.py:render_schedule``, ``ops/sim_fused.py:span_schedule``
and ``ops/ubench_mosaic.py:gemm_schedule`` are those schedules as pure
functions, and ``gemm_boxes`` the TMA boxes that cover a GEMM's depth. Each
schedule must give every agent, env or (g, tile) pair to exactly one warp
or block, at the shapes of ``tests/test_torch_cuda.py`` and of
``chip_smoke.py``, including grids larger than the work; the boxes must
tile the depth with zero fill only past it. K3 (``csrc/discounted_sum.cu``)
walks column tiles through a ring of chunks (``ops/discounted_sum.py:
scan_plan``): every (t, b) once, each column in the plain version's order.
K2's, K4's and K5's shared memory must fit a block at the repo's shapes,
K3's ring too, and the sizes the wrappers enforce must be the kernels'.
S1's M7 keeps a row in registers: its index map
(``ops/ubench_mosaic.py:compact_roll_sources``) must be each stage's roll. The
kernels themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import copy
import pathlib
import re

import pytest
import torch

from metta_tpu_torch.builder import envs
from metta_tpu_torch.convert import tables_from_compiled
from metta_tpu_torch.engine.compiler import compile_game
from metta_tpu_torch.ops import discounted_sum as k3
from metta_tpu_torch.ops import obs_render as k5
from metta_tpu_torch.ops import obs_render2 as k4
from metta_tpu_torch.ops import obs_render3 as k1
from metta_tpu_torch.ops import sim_fused as k2
from metta_tpu_torch.ops import ubench_mosaic as s1

SMS = 132                                          # an H100 SXM's SMs
SM_SMEM = 233_472                                  # shared memory an H100 SM holds (228 KB)
BLOCK_SMEM = 232_448                               # shared memory a block can use (227 KB)
CSRC = pathlib.Path(k1.__file__).parent.parent / "csrc"


def _constants(source):
    """The ``constexpr int kName = value;`` constants of a CUDA source."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", (CSRC / source).read_text())}


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


def test_span_fits_is_check_sizes():
    """``span_fits``, the predicate the env's dispatch reads, is false exactly
    where ``check_sizes`` raises: at num_resources 17, n_protocols 33, a chest
    pack too large for a block's shared memory and chests without
    assemblers; true (and no raise) on combat, the arena and the chest
    config. The env takes the fused step only where it holds."""
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.scripts.common import chest_mission

    chests = MettaGridEnv(chest_mission(size=10, chests=6, seed=3), num_envs=1, track_stats=False,
                          step_mode="batched", device="cpu").tables
    # the chest config with 16 resources, all 152 vibes and 8 more object
    # types: a chest pack of 235,620 B
    from metta_tpu_torch.config.mettagrid_config import WallConfig
    from metta_tpu_torch.config.vibes import VIBES

    cfg = chest_mission(size=10, chests=6, seed=3)
    cfg.game.resource_names += [f"extra_{i}" for i in range(k2.MAX_RESOURCES
                                                            - len(cfg.game.resource_names))]
    cfg.game.actions.change_vibe.vibes = list(VIBES)
    for i in range(8):
        cfg.game.objects[f"block_{i}"] = WallConfig(name=f"block_{i}")
    big_env = MettaGridEnv(cfg, num_envs=1, track_stats=False, step_mode="batched", device="cpu")
    big_pack = big_env.tables
    fits = [_tables("combat"), _tables("arena"), chests]
    t = chests
    big_res, big_np, no_asm = (copy.copy(t) for _ in range(3))
    big_res.num_resources = k2.MAX_RESOURCES + 1
    big_np.n_protocols = k2.MAX_PROTOCOLS + 1
    no_asm.has_assemblers = False
    for tables in fits:
        assert k2.span_fits(tables) and k2.size_faults(tables) == []
        k2.check_sizes(tables)
    for tables, what in ((big_res, "num_resources"), (big_np, "n_protocols"),
                         (big_pack, "shared memory"), (no_asm, "assemblers")):
        assert not k2.span_fits(tables)
        with pytest.raises(ValueError, match=what):
            k2.check_sizes(tables)
    assert k2.pack_ints(big_pack) == k2.table_pack(big_pack, "cpu")[0].numel()
    assert 4 * k2.pack_ints(big_pack) > 4 * k2.pack_ints(chests) + 200_000
    for tables in (big_res, big_np, big_pack):       # the env takes the torch-ops step there
        assert k2.supports_fused(tables) and not k2.span_fits(tables)
    assert big_env._sim_step.__name__ == "step_env_batched"


@pytest.mark.parametrize("E,A,per_sm", [
    (170, 24, 8), (170, 24, 1),                      # the curriculum env (phases 4, 10)
    (4096, 24, 8), (4096, 30, 8),                    # combat and arena30 (phase 4)
    (4097, 24, 8), (1, 24, 8), (6, 40, 8),           # the cuda tests; E=1 under the grid
    (4097, 40, 1), (1, 30, 1),                       # a grid smaller than the agents
])
def test_render2_schedule_covers_each_agent_once(E, A, per_sm):
    """K4's persistent schedule: the curriculum's E=170, combat's and
    arena30's E=4096, E=4097 and E=1 (fewer agents than the grid has warps);
    A of combat, arena30 and the A=40 test; a full card and one block an SM."""
    blocks = k4.render2_grid(E, A, SMS, per_sm)
    assert blocks == min(-(-E * A // k4.WARPS), SMS * per_sm)
    plan = k4.render2_schedule(E, A, blocks)
    assert len(plan) == blocks * k4.WARPS
    taken = sorted(pair for warp in plan for pair in warp)
    assert taken == [(e, a) for e in range(E) for a in range(A)]
    counts = [len(warp) for warp in plan]
    assert max(counts) - min(counts) <= 1
    if E * A >= len(plan):
        assert min(counts) >= 1                      # no idle warp while agents remain
    if E == 170 and per_sm == 8:
        assert max(counts) == 1                      # one wave: an agent a warp


@pytest.mark.parametrize("S,T", [(121, 200), (169, 200), (121, 24), (121, 3), (121, 2048)])
def test_render2_shared_memory_fits(S, T):
    """K4's location table, warp-private slots and staging rows fit a block
    at the repo's windows (11x11, the 13x13 test window) and token budgets,
    and its largest row; at 11x11 and T=200 eight blocks fit an SM."""
    smem = k4.render2_smem_bytes(S, T)
    slots = k4.PASS * (1 if S <= k4.PASS else 2)
    assert slots >= S
    assert smem == slots + k4.WARPS * (8 * slots + (3 * T + 3 + 15) // 16 * 16)
    assert smem <= BLOCK_SMEM
    if (S, T) == (121, 200):
        assert 8 * smem <= SM_SMEM


def test_render2_maxima_are_the_kernels():
    """The sizes K4's wrapper enforces are the constants of its CUDA source,
    and it refuses each one exceeded, by name, before it looks at a tensor."""
    const = _constants("obs_render2.cu")
    assert (const["kThreads"] // 32, const["kPass"], const["kMaxCells"],
            const["kMaxTokens"]) == (k4.WARPS, k4.PASS, k4.MAX_CELLS, k4.MAX_TOKENS)
    assert const["kMaxCells"] == 2 * const["kPass"] == 64 * const["kCells"]  # two passes
    args = [torch.zeros(s, dtype=d) for s, d in (
        ((1, 4, 4), torch.int32), ((1, 2, 3, 2), torch.uint8), ((1, 2), torch.int32),
        ((1, 2, 2), torch.int32), ((1, 2), torch.int32), ((1, 2, 1, 3), torch.uint8))]
    rank = torch.zeros(17 * 17, dtype=torch.int32)
    with pytest.raises(ValueError, match="window cells"):
        k4.check_inputs(*args, rank, 17, 17, 200)
    with pytest.raises(ValueError, match="num_tokens"):
        k4.check_inputs(*args, rank[:121], 11, 11, k4.MAX_TOKENS + 1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k4.check_inputs(*args, rank[:256], 16, 16, k4.MAX_TOKENS)


@pytest.mark.parametrize("B", [1, 5, 60, 1000, 1057, 2112, 2113, 4080, 4081])
def test_scan_plan_covers_each_column_once(B):
    """K3's tiles: every column in exactly one block, tiles of 8, 16 or 32
    columns (32 bytes or more a row), the grid covering the SMs where B
    allows: 8 columns at the minibatch's B=60, 32 at the update's B=4080."""
    plan = k3.scan_plan(255, B)
    tiles = [range(c0, min(B, c0 + plan["cols"])) for c0 in range(0, plan["blocks"] * plan["cols"],
                                                                  plan["cols"])]
    assert all(len(t) > 0 for t in tiles) and plan["blocks"] == -(-B // plan["cols"])
    assert [b for t in tiles for b in t] == list(range(B))
    assert plan["cols"] in (8, 16, 32) and 4 * plan["cols"] >= 32
    if B <= k3.MIN_COLS * SMS:
        assert plan["cols"] == k3.MIN_COLS           # as many blocks as 32-byte rows allow
    else:
        assert plan["blocks"] <= 2 * SMS or plan["cols"] == k3.MAX_COLS
    assert plan["cols"] == {60: 8, 4080: 32}.get(B, plan["cols"])


@pytest.mark.parametrize("T", [1, 17, k3.CHUNK - 1, k3.CHUNK, k3.CHUNK + 1, 255, 256, 300])
@pytest.mark.parametrize("forward_in_time", [False, True])
def test_scan_plan_walks_the_plain_order(T, forward_in_time):
    """The plan's chunks, taken from T down (the forward pass) or from 0 up
    (its gradient) CHUNK steps at a time with the short one last, give every
    step once in the plain version's order (the kernel's own walk is held
    bit-equal on the card); its ring holds every chunk at T <= 256 and fits
    a block's shared memory with gdecay's two extra arrays."""
    want = list(range(T)) if forward_in_time else list(range(T - 1, -1, -1))
    for B in (1, 60, 1536, 4080):
        plan = k3.scan_plan(T, B)
        walk = [want[i * k3.CHUNK:(i + 1) * k3.CHUNK] for i in range(plan["chunks"])]
        assert all(walk) and [t for chunk in walk for t in chunk] == want
        assert plan["chunks"] == -(-T // k3.CHUNK)
        assert 1 <= plan["stages"] <= min(plan["chunks"], k3.MAX_STAGES)
        if T <= k3.CHUNK * k3.MAX_STAGES:
            assert plan["stages"] == plan["chunks"]  # every chunk in flight at once
        for gdecay in (False, True):
            assert k3.scan_smem_bytes(plan["cols"], plan["stages"], gdecay) <= BLOCK_SMEM


def test_scan_plan_constants_are_the_kernels():
    """The plan's constants are those of K3's CUDA source (the kernel cannot
    run here to catch a drift)."""
    const = _constants("discounted_sum.cu")
    assert (const["kChunk"], const["kStride"], const["kMaxStages"], const["kMinCols"],
            const["kMaxCols"], const["kLoaders"]) == (k3.CHUNK, k3.STRIDE, k3.MAX_STAGES,
                                                      k3.MIN_COLS, k3.MAX_COLS, k3.LOADERS)
    assert k3.STRIDE >= k3.CHUNK and k3.STRIDE % 4 == 0   # 16-byte column loads


@pytest.mark.parametrize("E", [1, 10, 170, 4096, 4097])
@pytest.mark.parametrize("A", [24, 30])
def test_render1_schedule_covers_each_agent_once(E, A):
    """K5's persistent schedule at the sequential step's E=1 and 10, the
    learner's 170, combat's 4096 and 4097, for combat's 24 agents and
    arena30's 30: the grid the kernel launches on a full card and on one
    block an SM (smaller than the agents where E is large), and a grid with
    more warps than agents."""
    need = -(-E * A // k5.WARPS)
    for blocks in (k5.render_grid(E, A, SMS, 8), k5.render_grid(E, A, SMS, 1), need + 3):
        assert blocks <= need + 3
        plan = k5.render_schedule(E, A, blocks)
        assert len(plan) == blocks * k5.WARPS
        taken = sorted(pair for warp in plan for pair in warp)
        assert taken == [(e, a) for e in range(E) for a in range(A)]
        counts = [len(warp) for warp in plan]
        assert max(counts) - min(counts) <= 1
        if E * A >= len(plan):
            assert min(counts) >= 1                  # no idle warp while agents remain
        else:
            assert max(counts) == 1                  # more warps than agents: one each
    assert k5.render_grid(E, A, SMS, 8) == min(need, SMS * 8)


@pytest.mark.parametrize("S", [121, 289])
@pytest.mark.parametrize("T", [24, 25, 200])
def test_render1_shared_memory_fits(S, T):
    """K5's window offsets, warp-private arrays and staging rows fit a block
    at combat's 11x11 window and the 17x17 test window, at the 24- and
    25-token budgets (rows of 72 and 75 bytes) and combat's 200 (600
    bytes); at 11x11 and T=200 eight blocks fit an SM. The wrapper passes
    them and refuses a row too long for a block's shared memory, by name."""
    sp = (S + 3) // 4 * 4
    smem = k5.render1_smem_bytes(S, T)
    stage = (3 * T + 3 + 15) // 16 * 16
    assert stage >= 3 * T + 3                        # a row after up to 3 bytes of offset
    assert smem == 8 * sp + k5.WARPS * (8 * sp + stage) + (S + 15) // 16 * 16
    assert smem <= BLOCK_SMEM
    k5.check_sizes(S, T)
    if (S, T) == (121, 200):
        assert 8 * smem <= SM_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        k5.check_sizes(S, 16 * T * 100)


def test_render1_constants_are_the_kernels():
    """The sizes K5's wrapper mirrors are the constants of its CUDA source
    (the kernel cannot run here to catch a drift)."""
    const = _constants("obs_render.cu")
    assert (const["kThreads"] // 32, const["kPass"], const["kMaxSmem"]) == (
        k5.WARPS, k5.PASS, k5.SMEM_LIMIT)
    assert const["kPass"] == 32 * const["kCells"]
    assert k5.SMEM_LIMIT == BLOCK_SMEM
    for S, T in ((0, 200), (121, 0)):
        with pytest.raises(ValueError):
            k5.check_sizes(S, T)


def test_mosaic_constants_are_the_kernels():
    """The sizes S1's wrapper mirrors are the constants of its CUDA source:
    the fold's chunk, M4's copies and M2's most rows, whose staged tile
    (rows x 33 floats) fits the 48 KB a block takes without opting in; M3's
    row step (a thread a column: 2 rows at a time in 256 threads) and most
    rows, whose staged x[g] fits the same 48 KB beside its shifts."""
    const = _constants("ubench_mosaic.cu")
    assert (const["kFoldChunk"], const["kRepCopies"], const["kTrMaxRows"]) == (
        s1.FOLD_CHUNK, s1.COPIES, s1.TR_MAX_ROWS)
    assert s1.TR_MAX_ROWS * (const["kTrCols"] + 1) * 4 <= 48 * 1024
    assert 128 % const["kTrCols"] == 0
    assert (const["kThreads"] // 128 * const["kRollPerThread"], const["kRollMaxRows"]) == (
        s1.ROLL_ROWS, s1.ROLL_MAX_ROWS)
    assert s1.ROLL_MAX_ROWS % s1.ROLL_ROWS == 0 and s1.NSHIFT <= const["kRollMaxShifts"]
    assert s1.ROLL_MAX_ROWS * 128 * 4 + 4 * const["kRollMaxShifts"] <= 48 * 1024


@pytest.mark.parametrize("b", range(10))
def test_compact_index_map_is_the_roll(b):
    """M7's register renaming (b >= 5) and shuffle map (b < 5), emulated in
    torch over a [640] row, equal ``torch.roll`` left by 2^b."""
    x = torch.randn(s1.COLS, generator=torch.Generator().manual_seed(b))
    regs = x.reshape(s1.PER_LANE, 32).T              # lane l, register k: column l + 32 k
    src = s1.compact_roll_sources(b)
    got = x[src]                                     # what each register takes
    assert torch.equal(got, torch.roll(x, -(1 << b)).reshape(s1.PER_LANE, 32).T)
    if b < 5:                                        # a shuffle moves one register a lane
        lane = torch.arange(32)[:, None]
        assert bool(((src % 32) == (lane + (1 << b)) % 32).all())
    else:                                            # renaming: no data leaves its lane
        assert bool(((src % 32) == torch.arange(32)[:, None]).all())
    assert regs.shape == (32, s1.PER_LANE)


def test_compact_through_the_index_map_matches_plain():
    """The whole M7 compaction emulated through the kernel's index map, rep
    for rep and stage for stage, is bit-equal to the plain version."""
    inputs = s1.make_inputs("M7", 2, 1, seed=4, device="cpu")
    x = inputs[0]
    maps = [s1.compact_roll_sources(b).T.reshape(-1) for b in range(10)]  # column order
    v, d = x.clone(), x * 0.5
    for _ in range(3):
        for b in range(10):
            sv, sd = v[..., maps[b]], d[..., maps[b]]
            m = sd > 0.5
            v = torch.where(m, sv, v)
            d = torch.where(m, sd - float(1 << b), d)
    slots, cks = s1.plain("M7", inputs, 3)
    assert torch.equal(v[..., :128], slots)
    assert torch.equal(s1.bitsum(v[..., 128:]), cks)
