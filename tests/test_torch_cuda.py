"""The port's CUDA kernels on a GPU (skipped without one).

Each kernel against its plain torch version, on the card, at small sizes:
K1 (``csrc/obs_render3.cu``) on rolled combat states and on a window outside
the TPU kernel's limits; K4 (``csrc/obs_render2.cu``) on the same, on
``make_arena(30)`` (149 block ids), on the curriculum's stacked tables at
E=170 and on synthetic inputs at the persistent schedule's edges, against
K1's plain version and S4's ``none`` (its own mask 0); the
multi-task env GPU against CPU and a tiny multi-task trainer update; K2
(``csrc/sim_fused.cu``) on combat, cooperation, arena with gained/lost
tracking, navigation at A=4 and the arena at A=32, at E=1, at an E that no
128-env block divides and at E=4097, each ablation variant, and every block
width it takes; K2 with its chest phase on the chest config at E=1, 16 and
4097 and with a table pack near the shared-memory limit, and an env beyond
K2's maxima stepping on the card through the torch-ops step; K3 (``csrc/discounted_sum.cu``) forward and backward at odd shapes
(T at and around the chunk length, a ring walked twice, rows that are not
16-byte multiples) and the advantages through it against the CPU; K5 (``csrc/obs_render.cu``)
on the sequential env's inputs at E=1, 64 and 4097, arena30, a cut at T, rows
of 75 bytes and a wrapping location byte, on synthetic inputs at its edges,
and the sequential env with K5 on the GPU against the CPU; S5's and S4's
nine masks of K1 and K4 on synthetic inputs at E=8, rows of 21 bytes among
them, and S4's on combat at E=64; S1's M7 bit-equal at phase 13's shape,
its fold (M1, M1b) at G=3 with a short last chunk, M5 at phase 13's
shape and with a scalar tail, M4 and M2 at phase 13's shape and at G=3
(M2 at rows 24, 48 and 96), and M3 at phase 13's shape with reps 1, 16 and
30 and at G=3; S2's nine cases and two extras at E=1, 128, 300 and 4096,
tdiv's reciprocal route across its stated domain and tdiv across all of
int32; S3 (``csrc/smoke_sim.cu``) at E=1, 31, 32, 33, 256, 257 and 4096 on
the script's inputs and adversarial ones; the wrappers' input
checks (M5's, M4's, M3's and M2's alignment, M3's rows, S4's one pass); a
few whole env steps on the GPU
against the CPU; and a tiny trainer update through all three kernels.
This file imports no JAX, so it runs on a machine with a card and torch
alone:

    python3 -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import copy

from metta_tpu_torch.builder.envs import (make_arena, make_combat, make_cooperation,
                                          make_navigation)
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.engine.step_batched import batched_step, rank_from_perm
from metta_tpu_torch.ops import discounted_sum as k3
from metta_tpu_torch.ops import obs_render as k5
from metta_tpu_torch.ops import obs_render2 as k4
from metta_tpu_torch.ops import obs_render3 as k1
from metta_tpu_torch.ops import sim_fused as k2

pytestmark = pytest.mark.cuda
E, A = 16, 24


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _env(device, **obs):
    cfg = make_combat(A)
    cfg.game.map_builder.seed = 1234
    for k, v in obs.items():
        setattr(cfg.game.obs, k, v)
    return MettaGridEnv(cfg, num_envs=E, seed=0, track_stats=True, step_mode="batched",
                        device=device)


def _inputs(env, steps=6):
    env.reset()
    gen = torch.Generator(device=env.device).manual_seed(0)
    for _ in range(steps):
        env.step(torch.randint(0, env.tables.n_actions, (E, A), generator=gen,
                               device=env.device))
    s, t = env.state.env, env.tables
    args = k1.prep_env3(s, t, s.executed_action, s.reward)
    return args, (t.obs_scan, t.num_obs_tokens, t.obs_height // 2, t.obs_width // 2)


@pytest.mark.parametrize("obs", [{}, dict(num_tokens=24), dict(width=13, height=13)],
                         ids=["combat", "budget24", "window13"])
def test_k1_matches_plain(obs):
    args, extra = _inputs(_env(_cuda(), **obs))
    before = k1.launches
    got = k1.render_obs3(*args, *extra)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert torch.equal(got, k1.render_obs3_plain(*args, *extra))


def test_k1_wrapper_checks_inputs():
    args, extra = _inputs(_env(_cuda()), steps=1)
    bad = list(args)
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(ValueError):
        k1.render_obs3(*bad, *extra)
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError):
        k1.render_obs3(*bad, *extra)


@pytest.mark.parametrize("name,obs", [("combat", {}), ("combat", dict(num_tokens=24)),
                                      ("combat", dict(width=13, height=13)), ("arena30", {})],
                         ids=["combat", "budget24", "window13", "arena30"])
def test_k4_matches_plain(name, obs):
    if name == "arena30":
        cfg = make_arena(30)
        cfg.game.map_builder.seed = 1234
        env = MettaGridEnv(cfg, num_envs=E, seed=0, track_stats=True, step_mode="batched",
                           device=_cuda())
    else:
        env = _env(_cuda(), **obs)
    env.reset()
    t = env.tables
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(6):
        env.step(torch.randint(0, t.n_actions, (E, t.num_agents), generator=gen, device="cuda"))
    s = env.state.env
    args = k1.prep_env3(s, t, s.executed_action, s.reward)
    extra = (k4.rank_table(t.obs_scan, t.obs_width), t.num_obs_tokens, t.obs_height,
             t.obs_width)
    before = k4.launches
    got = k4.render_obs2(*args, *extra)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    assert torch.equal(got, k4.render_obs2_plain(*args, *extra))
    assert torch.equal(got, k1.render_obs3_plain(*args, t.obs_scan, t.num_obs_tokens,
                                                 t.obs_height // 2, t.obs_width // 2))


def test_k4_wrapper_checks_inputs():
    args, (scan, T, ohr, owr) = _inputs(_env(_cuda()), steps=1)
    rank = k4.rank_table(scan, 2 * owr + 1)
    for i, bad in ((0, args[0].to(torch.int64)), (1, args[1].cpu()),
                   (3, args[3][:, :-1].contiguous()), (5, args[5].transpose(1, 2))):
        call = list(args)
        call[i] = bad
        with pytest.raises(ValueError):
            k4.render_obs2(*call, rank, T, 2 * ohr + 1, 2 * owr + 1)
    with pytest.raises(ValueError):
        k4.render_obs2(*args, rank.long(), T, 2 * ohr + 1, 2 * owr + 1)


def test_multitask_env_gpu_matches_cpu():
    """The multi-task env over three curriculum tasks (E=10: K4 renders) on
    the GPU against the CPU, with auto-reset and task resampling."""
    from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped, make_curriculum
    from metta_tpu_torch.engine.taskset import MultiTaskEnv

    base = make_arena_basic_easy_shaped(6)
    base.game.max_steps = 7
    cfgs = [t.get_env_cfg() for t in make_curriculum(base).active_tasks()[:3]]
    for k, c in enumerate(cfgs):
        c.game.map_builder.seed = 3 + k
    n = 10
    envs = [MultiTaskEnv(cfgs, num_envs=n, seed=0, track_stats=True, device=d)
            for d in (_cuda(), "cpu")]
    rng = np.random.default_rng(0)
    tid = rng.integers(0, 3, n)
    obs = [env.reset(task_id=tid, desync_step=np.zeros(n)) for env in envs]
    np.testing.assert_array_equal(*obs)
    before = k4.launches
    for _ in range(16):
        acts = rng.integers(0, envs[1].compiled.n_actions, (n, 6))
        perm = torch.as_tensor(np.stack([rng.permutation(6) for _ in range(n)]))
        draws = rng.integers(0, 3, n)
        for g, c in zip(*(env.step(acts, perm=perm, task_draws=draws) for env in envs)):
            np.testing.assert_array_equal(g, c)
        assert torch.equal(envs[0].state.task_id.cpu(), envs[1].state.task_id)
    assert k4.launches == before + 16
    assert int(envs[1].state.episodes_done.sum()) >= n


def test_env_gpu_matches_cpu():
    envs = [_env(_cuda()), _env("cpu")]
    rng = np.random.default_rng(0)
    desync = rng.integers(1, 12, E)
    obs = [env.reset(desync_step=desync) for env in envs]
    assert torch.equal(obs[0].cpu(), obs[1])
    for _ in range(12):
        acts = rng.integers(0, envs[1].tables.n_actions, (E, A))
        perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(E)]))
        outs = [env.step(acts, perm=perm) for env in envs]
        for g, c in zip(*outs):
            assert torch.equal(g.cpu(), c)


K2_CONFIGS = {"combat": make_combat, "cooperation": make_cooperation, "arena": make_arena,
              "navigation": lambda n: make_navigation(n, width=20, height=20)}


def _k2_env(name, n_envs, gained=False, agents=A):
    """A track_stats=False env on the card with seeded inventories and vibes
    (the attack and transfer vibes where the config has them)."""
    cfg = K2_CONFIGS[name](agents)
    cfg.game.map_builder.seed = 1234
    env = MettaGridEnv(cfg, num_envs=n_envs, seed=0, track_stats=False, step_mode="batched",
                       device=_cuda())
    if gained:
        env.tables.track_gained = True
    env.reset()
    t = env.tables
    gen = torch.Generator(device="cuda").manual_seed(5)
    vibes = torch.tensor([0, 3] + [int(v) for m in (t.attack_vibe_mask, t.transfer_vibe_mask)
                                   for v in torch.nonzero(m).flatten()] * 2, device="cuda")
    s = env.state.env
    env._state = env.state.replace(env=s.replace(
        agent_inv=torch.randint(0, 4, s.agent_inv.shape, generator=gen, device="cuda",
                                dtype=torch.int32),
        agent_vibe=vibes[torch.randint(0, len(vibes), s.agent_vibe.shape, generator=gen,
                                       device="cuda")].to(torch.int32),
    ))
    return env, gen


def _first_diffs(got, want, names):
    """Where the named span outputs first differ, for the failure message."""
    extra = {"success": 1, "executed": 2}
    lines = []
    for name in names:
        g, w = ((got[extra[name]], want[extra[name]]) if name in extra
                else (getattr(got[0], name), getattr(want[0], name)))
        if g.shape != w.shape or g.dtype != w.dtype:
            lines.append(f"{name}: kernel {g.dtype} {tuple(g.shape)} plain {w.dtype} "
                         f"{tuple(w.shape)}")
            continue
        idx = torch.nonzero(g != w)[:4].tolist()
        lines.append(f"{name}: at {idx}: kernel {g[tuple(idx[0])].item()} "
                     f"plain {w[tuple(idx[0])].item()}")
    return "; ".join(lines)


def _k2_checked(state, actions, rank, tables):
    """K2 through its wrapper, held byte for byte to its plain version."""
    before = k2.launches
    got = k2.fused_span(state, actions, rank, tables)
    assert k2.launches == before + 1
    want = k2.fused_span_plain(state, actions, rank, tables)
    torch.cuda.synchronize()
    bad = k2.span_mismatches(got, want)
    assert bad == [], _first_diffs(got, want, bad)
    return got


def _k2_steps(env, gen, tables, steps=8):
    """``steps`` batched steps through K2 checked against its plain version,
    half the actions moves (so the sections fire), half any id."""
    n_envs, agents = env.state.env.agent_r.shape
    state = env.state.env
    for _ in range(steps):
        moves = torch.randint(1, 5, (n_envs, agents), generator=gen, device="cuda")
        anything = torch.randint(-1, tables.n_actions + 1, (n_envs, agents), generator=gen,
                                 device="cuda")
        pick = torch.rand((n_envs, agents), generator=gen, device="cuda") < 0.5
        acts = torch.where(pick, moves, anything).to(torch.int32)
        state, _ = batched_step(state, acts, tables, _k2_checked, generator=gen)
    return state


@pytest.mark.parametrize("name,n_envs,gained,agents", [
    ("combat", E, False, A), ("cooperation", E, False, A), ("arena", E, True, A),
    ("combat", 13, False, A), ("navigation", E, False, 4), ("combat", 1, False, A),
    ("combat", 4097, False, A), ("arena", E, False, 32),
], ids=["combat", "cooperation", "arena_gained", "combat_e13", "navigation_a4", "combat_e1",
        "combat_e4097", "arena_a32"])
def test_k2_matches_plain(name, n_envs, gained, agents):
    env, gen = _k2_env(name, n_envs, gained, agents)
    _k2_steps(env, gen, env.tables)


@pytest.mark.parametrize("variant", ["full", "noasm", "noattack", "noswap", "bare"])
def test_k2_ablation_variant_matches_plain(variant):
    """Each of the ablation's variants (a copy of the tables with section
    flags off, so another instantiation of the kernel) byte-equal to its plain
    version over a few steps, on combat and cooperation; the script's own
    check at a small E."""
    from metta_tpu_torch.scripts import ablate_fused

    for name in ("combat", "cooperation"):
        env, gen = _k2_env(name, E)
        _k2_steps(env, gen, ablate_fused.variant_tables(env.tables, variant), steps=4)
    rows = ablate_fused.main(["--num-envs", "64", "--steps", "2", "--only", variant])
    assert rows[0]["max_abs_err"] == 0 and rows[0]["ms"] > 0


def test_k2_wrapper_never_takes_the_plain_version(monkeypatch):
    """A CUDA input launches the kernel or raises; it never reaches the
    plain version."""
    env, gen = _k2_env("combat", E)
    t, s = env.tables, env.state.env
    acts = torch.randint(0, t.n_actions, (E, A), generator=gen, device="cuda", dtype=torch.int32)
    rank = rank_from_perm(None, E, A, gen, "cuda")
    want = k2.fused_span_plain(s, acts, rank, t)

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(k2, "fused_span_plain", plain)
    before = k2.launches
    got = k2.fused_span(s, acts, rank, t)
    assert k2.launches == before + 1
    assert k2.span_mismatches(got, want) == []
    shape = k2.launch_shape(t)
    assert shape["per_sm"] >= 1 and shape["sms"] >= 1


def test_k2_wrapper_refuses_sizes_beyond_its_maxima():
    env, gen = _k2_env("combat", E)
    t, s = env.tables, env.state.env
    acts = torch.randint(0, t.n_actions, (E, A), generator=gen, device="cuda", dtype=torch.int32)
    rank = rank_from_perm(None, E, A, gen, "cuda")
    for name, value in (("num_resources", k2.MAX_RESOURCES + 1),
                        ("n_protocols", k2.MAX_PROTOCOLS + 1)):
        big = copy.copy(t)
        setattr(big, name, value)
        with pytest.raises(ValueError, match=name):
            k2.fused_span(s, acts, rank, big)
    for el in (0, 3, 16, 128):
        with pytest.raises(ValueError):
            k2.fused_span(s, acts, rank, t, envs_per_block=el)
    before = k2.launches
    for el in k2.ENVS_PER_BLOCK:                      # every width the kernel takes
        assert k2.span_mismatches(k2.fused_span(s, acts, rank, t, envs_per_block=el),
                                  k2.fused_span_plain(s, acts, rank, t)) == []
    assert k2.launches == before + len(k2.ENVS_PER_BLOCK)


def test_k2_wrapper_checks_inputs():
    env, gen = _k2_env("combat", E)
    t, s = env.tables, env.state.env
    acts = torch.randint(0, t.n_actions, (E, A), generator=gen, device="cuda", dtype=torch.int32)
    rank = rank_from_perm(None, E, A, gen, "cuda")
    with pytest.raises(ValueError):
        k2.fused_span(s, acts.long(), rank, t)
    with pytest.raises(ValueError):
        k2.fused_span(s, acts, rank.cpu(), t)
    with pytest.raises(ValueError):
        k2.fused_span(s.replace(agent_inv=s.agent_inv.transpose(1, 2).contiguous()
                                .transpose(1, 2)), acts, rank, t)
    cenv, cgen, _ = _k2_chest_env(E)
    cs, ct = cenv.state.env, cenv.tables
    cacts = torch.randint(0, ct.n_actions, (E, ct.num_agents), generator=cgen, device="cuda",
                          dtype=torch.int32)
    crank = rank_from_perm(None, E, ct.num_agents, cgen, "cuda")
    with pytest.raises(ValueError, match="chest_inv"):           # the chest phase's inputs too
        k2.fused_span(cs.replace(chest_inv=cs.chest_inv.long()), cacts, crank, ct)
    before = k2.launches
    k2.fused_span(s, acts, rank, t)
    assert k2.launches == before + 1


def _k2_chest_env(n_envs, cfg=None, gained=False):
    """The chest config (``scripts/common.py:chest_mission``, on a small map
    dense with stations) as a track_stats=False env on the card, each agent
    just beside a chest, with seeded inventories (agents 0-30 of each
    resource, chests 0-40) and every agent showing one of the chest's vibes
    -> (env, generator, the actions that move every agent into its chest).
    ``gained`` turns on the gained/lost bookkeeping after the chest phase."""
    from metta_tpu_torch.engine.state import KIND_CHEST, KIND_EMPTY
    from metta_tpu_torch.engine.step_batched import agent_grid_from_positions
    from metta_tpu_torch.scripts.common import chest_mission

    env = MettaGridEnv(cfg or chest_mission(size=10, chests=6, seed=3), num_envs=n_envs,
                       seed=0, track_stats=False, step_mode="batched", device=_cuda())
    assert env._sim_step is k2.fused_step_full
    if gained:
        env.tables.track_gained = True
    env.reset()
    gen = torch.Generator(device="cuda").manual_seed(5)
    t, s = env.tables, env.state.env
    kind = s.static_kind[0].cpu().numpy()
    names = env.compiled.action_names
    beside = {}                                     # a free cell beside a chest: its move
    for r, c in np.argwhere(kind == KIND_CHEST):
        for move, dr, dc in (("move_north", -1, 0), ("move_south", 1, 0),
                             ("move_west", 0, -1), ("move_east", 0, 1)):
            if kind[r - dr, c - dc] == KIND_EMPTY:
                beside.setdefault((r - dr, c - dc), names.index(move))
    beside = [(r, c, move) for (r, c), move in beside.items()]
    picked = torch.tensor([beside[a * len(beside) // t.num_agents] for a in range(t.num_agents)],
                          dtype=torch.int32, device="cuda").expand(n_envs, -1, -1)
    r, c = picked[..., 0].contiguous(), picked[..., 1].contiguous()
    vibes = torch.nonzero(t.chest_vibe_has.any(0)).flatten()

    def draw(hi, like):
        return torch.randint(0, hi, like.shape, generator=gen, device="cuda", dtype=torch.int32)
    env._state = env.state.replace(env=s.replace(
        agent_r=r, agent_c=c, agent_prev_r=r, agent_prev_c=c,
        agent_grid=agent_grid_from_positions(t, r, c),
        agent_inv=draw(31, s.agent_inv), chest_inv=draw(41, s.chest_inv),
        agent_vibe=vibes[draw(len(vibes), s.agent_vibe).long()].to(torch.int32)))
    return env, gen, picked[..., 2].contiguous()


def _big_chest_cfg(extra_types=4):
    """The chest config with 16 resources, every vibe of the catalog (152)
    and ``extra_types`` more object types: with 4, a table pack of 194 KB and
    205,552 B of shared memory a block (88% of it); with 8, 247,168 B, past
    it."""
    from metta_tpu_torch.config.mettagrid_config import WallConfig
    from metta_tpu_torch.config.vibes import VIBES
    from metta_tpu_torch.scripts.common import chest_mission

    cfg = chest_mission(size=10, chests=6, seed=3)
    cfg.game.resource_names += [f"extra_{i}" for i in range(k2.MAX_RESOURCES
                                                            - len(cfg.game.resource_names))]
    cfg.game.actions.change_vibe.vibes = list(VIBES)
    for i in range(extra_types):
        cfg.game.objects[f"block_{i}"] = WallConfig(name=f"block_{i}")
    return cfg


@pytest.mark.parametrize("n_envs,big,gained", [(E, False, False), (1, False, False),
                                               (4097, False, False), (E, True, False),
                                               (E, False, True)],
                         ids=["e16", "e1", "e4097", "pack_near_smem_limit", "e16_gained"])
def test_k2_chests_match_plain(n_envs, big, gained):
    """K2 with its chest phase byte-equal to its plain version over eight
    steps of the chest config (chest transfers must happen), at E=1, 16,
    4097, with a table pack near the shared-memory limit, and with the
    gained/lost bookkeeping that follows the chest phase."""
    env, gen, into = _k2_chest_env(n_envs, _big_chest_cfg() if big else None, gained)
    t = env.tables
    assert t.track_gained == gained
    n_tab = k2.pack_ints(t)
    smem = k2.span_smem_bytes(n_tab, t.num_agents, t.num_resources, t.track_gained, k2.WARPS)
    if big:
        assert t.num_resources == k2.MAX_RESOURCES and 0.85 * k2.SMEM_LIMIT < smem <= k2.SMEM_LIMIT
        assert k2.launch_shape(t)["smem"] == smem
    before = env.state.env.chest_inv
    state, _ = batched_step(env.state.env, into, t, _k2_checked, generator=gen)  # every agent bumps
    assert (state.chest_inv != before).any()
    env._state = env.state.replace(env=state)
    _k2_steps(env, gen, t)


def test_k2_chests_never_take_the_plain_version(monkeypatch):
    """With chests too, a CUDA input launches the kernel or raises."""
    env, gen, acts = _k2_chest_env(E)
    t, s = env.tables, env.state.env
    rank = rank_from_perm(None, E, t.num_agents, gen, "cuda")
    want = k2.fused_span_plain(s, acts, rank, t)

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(k2, "fused_span_plain", plain)
    before = k2.launches
    assert k2.span_mismatches(k2.fused_span(s, acts, rank, t), want) == []
    assert k2.launches == before + 1


def test_start_clipped_mission_draws_on_the_card():
    """``training_facility.repair`` (hub stations start clipped, the clipper
    on) with every draw from the env's own CUDA generator: the template's
    and each reset's unclip protocols, the clipper's draws; auto-reset after
    6 steps. Every start-clipped slot holds a protocol in range."""
    from metta_tpu_torch.cogames.catalog import get_mission

    cfg = get_mission("training_facility.repair").make_env()
    cfg.game.max_steps = 6
    env = MettaGridEnv(cfg, num_envs=E, device=_cuda())
    env.tables.obs_renderer = "pl"
    env.reset()
    t = env.tables
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(15):
        env.step(torch.randint(0, t.n_actions, (E, t.num_agents), generator=gen, device="cuda"))
    s = env.state.env
    protos = s.asm_unclip_proto[s.asm_clipped]
    assert protos.numel() and ((protos >= 0) & (protos < t.n_unclip_protocols)).all()


def _resources17_cfg():
    cfg = make_navigation(4, width=20, height=20)
    cfg.game.map_builder.seed = 1234
    cfg.game.resource_names += [f"extra_{i}" for i in range(k2.MAX_RESOURCES + 1
                                                            - len(cfg.game.resource_names))]
    return cfg


@pytest.mark.parametrize("which", ["resources17", "chest_pack"])
def test_env_beyond_k2_maxima_gpu_matches_cpu(which):
    """An env whose config K2 cannot take (17 resources; a chest pack past a
    block's shared memory) passes ``supports_fused`` but not ``span_fits``:
    on the card it steps through ``step_env_batched``, never reaching the
    kernel, byte for byte with its CPU run."""
    from metta_tpu_torch.engine.step_batched import step_env_batched

    cfg = _resources17_cfg() if which == "resources17" else _big_chest_cfg(8)
    envs = [MettaGridEnv(cfg, num_envs=E, seed=0, track_stats=False, step_mode="batched",
                         device=d) for d in (_cuda(), "cpu")]
    t = envs[0].tables
    assert k2.supports_fused(t) and not k2.span_fits(t)
    assert all(env._sim_step is step_env_batched for env in envs)
    A = t.num_agents
    rng = np.random.default_rng(3)
    desync = rng.integers(1, 12, E)
    obs = [env.reset(desync_step=desync) for env in envs]
    assert torch.equal(obs[0].cpu(), obs[1])
    before = k2.launches
    for _ in range(10):
        acts = rng.integers(0, t.n_actions, (E, A))
        perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(E)]))
        outs = [env.step(acts, perm=perm) for env in envs]
        for g, c in zip(*outs):
            assert torch.equal(g.cpu(), c)
    assert k2.launches == before


def test_env_fused_gpu_matches_cpu():
    """The track_stats=False env (the fused span: the kernel on the GPU, its
    plain version on the CPU) on both devices, byte for byte."""
    cfg = make_cooperation(A)
    cfg.game.map_builder.seed = 1234
    envs = [MettaGridEnv(cfg, num_envs=E, seed=0, track_stats=False, step_mode="batched", device=d)
            for d in (_cuda(), "cpu")]
    rng = np.random.default_rng(1)
    desync = rng.integers(1, 12, E)
    obs = [env.reset(desync_step=desync) for env in envs]
    assert torch.equal(obs[0].cpu(), obs[1])
    before = k2.launches
    for _ in range(12):
        acts = rng.integers(0, envs[1].tables.n_actions, (E, A))
        perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(E)]))
        outs = [env.step(acts, perm=perm) for env in envs]
        for g, c in zip(*outs):
            assert torch.equal(g.cpu(), c)
    assert k2.launches == before + 12


@pytest.mark.parametrize("T,B", [
    (1, 1), (17, 5), (33, 1000), (255, 60),
    (31, 60), (32, 4080), (33, 4081),            # T at the chunk's length and either side of it
    (255, 4080), (256, 61), (300, 13),           # full rings; a ring walked twice; rows of 244
                                                 # and 52 bytes (not multiples of 16)
    (255, 1536), (33, 1057), (256, 2112),        # 16-column tiles (B in (8, 16] columns an SM)
])
def test_k3_matches_plain(T, B):
    """K3 forward and backward (gx and gdecay) bit-equal to autograd through
    the plain version; T off and on the chunk length, B off the tile width
    and off 16-byte rows (the kernel's 4-byte copies)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(T * B)
    x = torch.randn((T, B), generator=gen, device=dev)
    decay = torch.rand((T, B), generator=gen, device=dev)
    w = torch.randn((T, B), generator=gen, device=dev)
    res = []
    for fn in (k3.discounted_sum, k3.discounted_sum_plain):
        xg, dg = x.clone().requires_grad_(), decay.clone().requires_grad_()
        before = k3.launches
        out = fn(xg, dg)
        res.append((out, *torch.autograd.grad((out * w).sum(), (xg, dg)),
                    k3.launches - before))
    torch.cuda.synchronize()
    (out, gx, gd, n), (out_p, gx_p, gd_p, n_p) = res
    assert (n, n_p) == (2, 0)
    assert torch.equal(out, out_p) and torch.equal(gx, gx_p) and torch.equal(gd, gd_p)


def test_k3_wrapper_never_takes_the_plain_version(monkeypatch):
    """CUDA inputs launch the kernel, forward and backward, or raise; they
    never reach the plain version."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((255, 60), generator=gen, device=dev)
    decay = torch.rand((255, 60), generator=gen, device=dev)
    want = k3.discounted_sum_plain(x, decay)

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(k3, "discounted_sum_plain", plain)
    before = k3.launches
    xg = x.clone().requires_grad_()
    out = k3.discounted_sum(xg, decay)
    (gx,) = torch.autograd.grad(out.sum(), xg)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.isfinite(gx).all()
    assert k3.launches == before + 2


def test_k3_wrapper_checks_inputs():
    x = torch.zeros((9, 4), device=_cuda())
    for bad in ((x, torch.zeros((9, 5), device="cuda")), (x.t(), x.t()), (x, x.half()),
                (x, x.cpu())):
        with pytest.raises(ValueError):
            k3.launch_discounted_sum(*bad)
    with pytest.raises(ValueError):
        k3.launch_discounted_sum(x, x, forward_in_time=False, y=x)


def test_advantages_gpu_match_cpu():
    """puff_advantage and the TD(λ) targets with their gradient on the GPU
    (through K3) against the CPU (the plain version): same float ops."""
    from metta_tpu_torch.rl import advantage as adv

    rng = np.random.default_rng(3)
    v, r, imp = (torch.from_numpy(rng.normal(size=(40, 70)).astype(np.float32)) for _ in range(3))
    d = torch.from_numpy((rng.random((40, 70)) < 0.1).astype(np.float32))
    out = []
    for dev in ("cpu", _cuda()):
        vg = v.to(dev).requires_grad_()
        a = adv.puff_advantage(vg.detach(), r.to(dev), d.to(dev), imp.to(dev).abs(), 0.99, 0.95)
        dl = adv.compute_delta_lambda(vg, r.to(dev), d.to(dev), 0.99, 0.95)
        (g,) = torch.autograd.grad((dl * r.to(dev)).sum(), vg)
        out.append([t.detach().cpu() for t in (a, dl, g)])
    for c, g in zip(*out):
        torch.testing.assert_close(g, c, rtol=1e-6, atol=1e-6)


def test_multitask_trainer_update_on_gpu():
    """A tiny multi-task ``Trainer.update`` on the card: the rollout renders
    through K4 (E=10 fails ``pick_eps``), the set never fuses (K2 idle), K3
    as in the single-task learner."""
    from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped, make_curriculum
    from metta_tpu_torch.models.vit import ViTConfig
    from metta_tpu_torch.rl.config import TrainerConfig
    from metta_tpu_torch.rl.trainer import Trainer

    base = make_arena_basic_easy_shaped(6)
    base.game.map_builder.seed = 5
    cfgs = [t.get_env_cfg() for t in make_curriculum(base).active_tasks()[:3]]
    tr = Trainer(None, TrainerConfig(num_envs=10, bptt_horizon=16, minibatch_size=96,
                                     track_env_stats=True),
                 ViTConfig(latent_dim=32, actor_hidden=32, critic_hidden=32, max_tokens=32,
                           core_num_latents=4, core_num_heads=2, core="lstm"),
                 device=_cuda(), task_cfgs=cfgs)
    ts = tr.init_state()
    p0 = ts.params.clone()
    counts = (k1.launches, k2.launches, k3.launches, k4.launches)
    ts, metrics = tr.update(ts)
    torch.cuda.synchronize()
    runs = [n - c for n, c in zip((k1.launches, k2.launches, k3.launches, k4.launches), counts)]
    assert runs == [0, 0, 1 + 2 * tr.n_minibatches, tr.T]
    assert all(torch.isfinite(m) for m in metrics.values())
    assert float((ts.params - p0).abs().max()) > 0


def test_trainer_update_on_gpu():
    """A tiny ``Trainer.update`` on the card: the rollout goes through K1 and
    K2, the advantages and the GTD(λ) critic through K3, forward and backward."""
    from metta_tpu_torch.models.vit import ViTConfig
    from metta_tpu_torch.rl.config import TrainerConfig
    from metta_tpu_torch.rl.trainer import Trainer

    cfg = make_arena(A)
    cfg.game.map_builder.seed = 5
    tr = Trainer(cfg, TrainerConfig(num_envs=2, bptt_horizon=16, minibatch_size=96),
                 ViTConfig(latent_dim=32, actor_hidden=32, critic_hidden=32, max_tokens=32,
                           core_num_latents=4, core_num_heads=2, core="lstm"),
                 device=_cuda())
    ts = tr.init_state()
    p0 = ts.params.clone()
    counts = (k1.launches, k2.launches, k3.launches)
    ts, metrics = tr.update(ts)
    torch.cuda.synchronize()
    runs = [n - c for n, c in zip((k1.launches, k2.launches, k3.launches), counts)]
    assert runs == [tr.T, tr.T, 1 + 2 * tr.n_minibatches]
    assert all(torch.isfinite(m) for m in metrics.values())
    assert float((ts.params - p0).abs().max()) > 0


def _seq_env(device, n_envs, renderer="pl", make=make_combat, agents=A, **obs):
    """The sequential env (the default step mode) with ``obs_renderer``."""
    cfg = make(agents)
    cfg.game.map_builder.seed = 1234
    for k, v in obs.items():
        setattr(cfg.game.obs, k, v)
    env = MettaGridEnv(cfg, num_envs=n_envs, seed=0, device=device)
    env.tables.obs_renderer = renderer
    return env


def _k5_inputs(env, steps=4):
    env.reset()
    gen = torch.Generator(device=env.device).manual_seed(steps)
    for _ in range(steps):
        env.step(torch.randint(0, env.tables.n_actions, (env.num_envs, env.num_agents),
                               generator=gen, device=env.device))
    s, t = env.state.env, env.tables
    return (k5.prep_obs1(s, t, s.executed_action, s.reward),
            (t.obs_scan, t.num_obs_tokens, t.obs_height // 2, t.obs_width // 2))


@pytest.mark.parametrize("n_envs,make,agents,obs", [
    (1, make_combat, A, {}), (64, make_combat, A, {}), (3, make_arena, 30, {}),
    (5, make_combat, A, dict(num_tokens=24)), (2, make_combat, A, dict(width=17, height=17)),
    (4097, make_combat, A, {}), (5, make_combat, A, dict(num_tokens=25)),
], ids=["combat_E1", "combat_E64", "arena30", "budget24", "window17", "combat_E4097",
        "budget25"])
def test_k5_matches_plain(n_envs, make, agents, obs):
    """K5 byte-equal to its plain version on the sequential env's inputs:
    E=1 (fewer agents than a block has warps), E=4097 (not a multiple of the
    grid), arena30 (149 block ids), rows of 72 and of 75 bytes (T=24, 25: a
    row that is no multiple of 4 bytes, so rows start at every byte offset
    of a word) and a 17x17 window (289 cells, three passes)."""
    args, extra = _k5_inputs(_seq_env(_cuda(), n_envs, make=make, agents=agents, **obs))
    before = k5.launches
    got = k5.render_obs1(*args, *extra)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert torch.equal(got, k5.render_obs1_plain(*args, *extra))


def _synthetic_render1(E, A, T, G=5, K=4, g_all=None, seed=0, device="cuda"):
    """K5's inputs made from numpy: two planes of a 20x23 map (agents at
    about one cell in ten, 15 static block ids after the agents'), counts up
    to K + 2 (past K
    the cell's slots stay 255), block 0 (outside the map) with tokens of its
    own, an 11x11 window past the map's edges, 0-G global tokens a agent or
    ``g_all`` (more than G or T)."""
    rng = np.random.default_rng(seed)
    H, W, NB, half = 20, 23, A + 16, 5
    offs = sorted(((dr, dc) for dr in range(-half, half + 1) for dc in range(-half, half + 1)),
                  key=lambda d: (abs(d[0]) + abs(d[1]), d))
    agent_grid = np.where(rng.random((E, H, W)) < 0.1, rng.integers(1, A + 1, (E, H, W)), 0)
    sblock = np.where(rng.random((E, H, W)) < 0.4, rng.integers(A + 1, NB, (E, H, W)), 0)
    rc = np.stack([rng.integers(0, H, (E, A)), rng.integers(0, W, (E, A))], -1)
    g_count = (rng.integers(0, G + 1, (E, A)) if g_all is None else np.full((E, A), g_all))
    arrays = (agent_grid, sblock, rng.integers(0, 256, (E, NB, K, 2)),
              rng.integers(0, K + 3, (E, NB)), rc, g_count, rng.integers(0, 256, (E, A, G, 3)),
              np.array(offs))
    dtypes = (torch.int32, torch.int32, torch.uint8, torch.int32, torch.int32, torch.int32,
              torch.uint8, torch.int32)
    args = tuple(torch.as_tensor(x).to(dt).contiguous().to(device)
                 for x, dt in zip(arrays, dtypes))
    return args, (T, half, half)


@pytest.mark.parametrize("E,A,T,G,g_all", [
    (1, 24, 200, 5, None),       # one env: fewer agents than the grid has warps
    (4097, 24, 30, 5, None),     # not a multiple of the grid; cuts inside cells
    (16, 24, 7, 5, None),        # rows of 21 bytes, no multiple of 4
    (8, 24, 3, 5, 5),            # more global tokens than T
    (8, 24, 50, 5, 9),           # more global tokens than G: slots G..8 stay 255
    (6, 40, 25, 40, None),       # 40 agents; global tokens past a warp's first 32 bytes
], ids=["E1", "E4097", "T7", "globals_over_T", "globals_over_G", "A40"])
def test_k5_matches_plain_on_synthetic_inputs(E, A, T, G, g_all):
    """K5 byte-equal to its plain version where the persistent schedule, the
    two planes' merge, counts past K, block 0's own tokens, the global
    tokens past G or T and the word stores meet their edges."""
    _cuda()
    args, extra = _synthetic_render1(E, A, T, G, g_all=g_all)
    before = k5.launches
    got = k5.render_obs1(*args, *extra)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert torch.equal(got, k5.render_obs1_plain(*args, *extra))


def test_k5_wrapper_never_takes_the_plain_version(monkeypatch):
    """A CUDA input launches the kernel or raises; it never reaches the
    plain version."""
    args, extra = _k5_inputs(_seq_env(_cuda(), 2), steps=1)
    want = k5.render_obs1_plain(*args, *extra)

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(k5, "render_obs1_plain", plain)
    before = k5.launches
    assert torch.equal(k5.render_obs1(*args, *extra), want)
    assert k5.launches == before + 1
    for i, bad in ((0, lambda x: x.to(torch.int64)), (2, lambda x: x.cpu()),
                   (4, lambda x: x[:, :-1])):
        changed = list(args)
        changed[i] = bad(changed[i])
        with pytest.raises(ValueError):
            k5.render_obs1(*changed, *extra)
    assert k5.launches == before + 1


def test_sequential_env_gpu_matches_cpu():
    """The sequential env with ``obs_renderer="pl"`` (K5 on the GPU, its
    plain version on the CPU) on both devices, byte for byte, through
    auto-reset; K5 renders every step and no other render kernel runs."""
    envs = [_seq_env(_cuda(), E), _seq_env("cpu", E)]
    rng = np.random.default_rng(3)
    desync = rng.integers(1, 12, E)
    obs = [env.reset(desync_step=desync) for env in envs]
    assert torch.equal(obs[0].cpu(), obs[1])
    before = (k1.launches, k2.launches, k4.launches, k5.launches)
    for _ in range(12):
        acts = rng.integers(0, envs[1].tables.n_actions, (E, A))
        perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(E)]))
        outs = [env.step(acts, perm=perm) for env in envs]
        for g, c in zip(*outs):
            assert torch.equal(g.cpu(), c)
    after = (k1.launches, k2.launches, k4.launches, k5.launches)
    assert [b - a for a, b in zip(before, after)] == [0, 0, 0, 12]


# ---- the analysis path: S5, S4 (K1's and K4's ablations), S3, S2, S1 ----

def _ablation_inputs(steps=3):
    env = _env(_cuda())
    args, extra3 = _inputs(env, steps=steps)
    t = env.tables
    extra2 = (k4.rank_table(t.obs_scan, t.obs_width), t.num_obs_tokens, t.obs_height,
              t.obs_width)
    return args, extra3, extra2


@pytest.mark.parametrize("which", ["k1", "k4"])
def test_ablation_variants_match_plain(which):
    """Every variant of K1's and K4's ablation equals its plain version in
    the bytes it defines; ``none`` equals the production kernel."""
    from metta_tpu_torch.ops import ablate_obs as ab

    args, extra3, extra2 = _ablation_inputs()
    if which == "k1":
        sections, kernel, plain = ab.SECTIONS3, ab.render_obs3_ablated, ab.render_obs3_ablated_plain
        extra, production = extra3, k1.render_obs3(*args, *extra3)
    else:
        sections, kernel, plain = ab.SECTIONS2, ab.render_obs2_ablated, ab.render_obs2_ablated_plain
        extra, production = extra2, k4.render_obs2(*args, *extra2)
    for v in ab.variants(sections):
        skips = ab.skips_of(v, sections)
        got = kernel(skips, *args, *extra)
        want, defined = plain(skips, *args, *extra)
        torch.cuda.synchronize()
        assert not bool(((got != want) & defined).any()), v
        if not skips:
            assert torch.equal(got, production)


def test_ablation_wrapper_checks_inputs():
    from metta_tpu_torch.ops import ablate_obs as ab

    args, extra3, _ = _ablation_inputs(steps=1)
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError):
        ab.render_obs3_ablated(set(), *bad, *extra3)
    with pytest.raises(ValueError):
        ab.render_obs3_ablated({"antidiag"}, *args, *extra3)
    out = torch.zeros(args[0].shape[0], A, extra3[1], 3, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        ab.render_obs3_ablated(set(), *args, *extra3, out=out[:, :-1])


SMOKE_SIM_PATTERNS = ("script", "equal", "distinct", "extreme")


def smoke_sim_inputs(pattern, agents, rows, n_envs, seed=0):
    """S3's inputs as numpy int32, r [agents, n_envs] and inv [rows, agents,
    n_envs]: the script's draw (r in [0, 5), inv in [0, 3)), or an
    adversarial one: every agent of an env equal, every agent distinct, or r
    from the int32 extremes and small negatives; inv then in [-3, 3], times
    2^24 in every other env, so that sums run above 7 and below 0 (and stay
    inside int32, where numpy's int64 sum and torch's int32 sum agree)."""
    rng = np.random.default_rng(seed)
    if pattern == "script":
        return (rng.integers(0, 5, (agents, n_envs), dtype=np.int32),
                rng.integers(0, 3, (rows, agents, n_envs), dtype=np.int32))
    if pattern == "equal":
        r = np.broadcast_to(rng.integers(-2 ** 31, 2 ** 31, (1, n_envs)), (agents, n_envs))
    elif pattern == "distinct":
        r = rng.integers(-2 ** 31, 2 ** 31 - agents, (1, n_envs)) + np.arange(agents)[:, None]
    else:
        r = rng.choice(np.array([-2 ** 31, 2 ** 31 - 1, -2 ** 31 + 1, -1, 0, 1, -7]),
                       (agents, n_envs))
    inv = rng.integers(-3, 4, (rows, agents, n_envs))
    inv[..., ::2] *= 2 ** 24
    return np.ascontiguousarray(r, dtype=np.int32), inv.astype(np.int32)


@pytest.mark.parametrize("n_envs", [1, 31, 32, 33, 256, 257, 4096])
def test_smoke_sim_matches_plain(n_envs):
    """S3 bit-equal to its plain version, one launch counted a call, on the
    script's inputs and the adversarial ones at 1, 24 and 32 agents and 0 and
    10 inventory rows: E around a warp and the kernel's 4-env blocks, the
    phase 13 sizes and a full grid."""
    from metta_tpu_torch.ops import smoke_sim as s3

    _cuda()
    for pattern in SMOKE_SIM_PATTERNS:
        for agents in (1, 24, 32):
            for rows in (0, 10):
                r, inv = (torch.as_tensor(v, device="cuda") for v in
                          smoke_sim_inputs(pattern, agents, rows, n_envs, seed=n_envs))
                before = s3.launches
                got = s3.smoke_sim(r, inv)
                torch.cuda.synchronize()
                assert s3.launches == before + 1
                want = s3.smoke_sim_plain(r, inv)
                case = (pattern, agents, rows)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), case


@pytest.mark.parametrize("n_envs", [1, 128, 300, 4096])
def test_pairmat_cases_match_plain(n_envs):
    """S2's nine cases and its two extras byte-equal to their plain versions,
    one launch counted a call: odd E leaves a partial block in both layouts
    (a thread per element, a warp per env)."""
    from metta_tpu_torch.ops import ubench_pairmat as s2

    x = torch.as_tensor(np.random.default_rng(1).integers(0, 24, (s2.A, n_envs),
                                                           dtype=np.int32), device=_cuda())
    for case in s2.CASES + s2.EXTRAS:
        before = s2.launches
        got = s2.run(case, x)
        torch.cuda.synchronize()
        assert s2.launches == before + 1, case
        assert torch.equal(got, s2.plain(case, x)), case


@pytest.mark.parametrize("n_envs", [300, 4096])
def test_pairmat_tdiv_is_exact_across_its_domain(n_envs):
    """tdiv's reciprocal route bit-equal to the plain version's IEEE divide
    over x drawn across the stated domain (|x + i| < TDIV_LIMIT at every
    rep), its edges included, and on negative x."""
    from metta_tpu_torch.ops import ubench_pairmat as s2

    _cuda()
    lo, hi = -s2.TDIV_LIMIT + 1, s2.TDIV_LIMIT - s2.TDIV_REPS
    x = np.random.default_rng(n_envs).integers(lo, hi, (s2.A, n_envs))
    x[0, :4] = [lo, hi - 1, -s2.TDIV_REPS // 2, 0]
    x = torch.as_tensor(x.astype(np.int32), device="cuda")
    got = s2.run("tdiv", x)
    torch.cuda.synchronize()
    assert torch.equal(got, s2.plain("tdiv", x))


def tdiv_edges():
    """x that S2's tdiv must take, as int64: both edges of the reciprocal
    route's domain (-2^23 < x, x + 255 < 2^23) and the 8 x beside each on
    either side; INT_MIN and INT_MAX - 255 (whose reps wrap past INT_MAX)
    and the 7 x above each, one for every n = (x & 7) + 1."""
    from metta_tpu_torch.ops import ubench_pairmat as s2

    lim, reps = s2.TDIV_LIMIT, s2.TDIV_REPS
    return np.array([e + d for e in (-lim + 1, -lim, lim - reps, lim - reps + 1)
                     for d in range(-8, 9)]
                    + [e + k for e in (-2 ** 31, 2 ** 31 - 1 - (reps - 1)) for k in range(8)])


@pytest.mark.parametrize("n_envs", [300, 4096])
def test_pairmat_tdiv_matches_plain_across_int32(n_envs):
    """tdiv bit-equal to the card's plain version over x drawn from all of
    int32, both domain edges, INT_MIN and INT_MAX - 255 among them: the
    reciprocal route inside the domain, the IEEE route outside it, each
    element's choice made in the kernel."""
    from metta_tpu_torch.ops import ubench_pairmat as s2

    _cuda()
    x = np.random.default_rng(n_envs).integers(-2 ** 31, 2 ** 31, (s2.A, n_envs))
    edges = tdiv_edges()
    x.reshape(-1)[:len(edges)] = edges
    x = torch.as_tensor(x.astype(np.int32), device="cuda")
    before = s2.launches
    got = s2.run("tdiv", x)
    torch.cuda.synchronize()
    assert s2.launches == before + 1
    assert torch.equal(got, s2.plain("tdiv", x))


@pytest.mark.parametrize("case", ["M5", "M1", "M1b", "M2", "M3", "M4", "M6a", "M6b", "M6c",
                                  "M7"])
def test_mosaic_case_matches_plain(case):
    from metta_tpu_torch.ops import ubench_mosaic as s1
    from metta_tpu_torch.scripts.ubench_mosaic import check

    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = s1.make_inputs(case, 8, 2, seed=3, device="cuda")
    got = s1.run(case, inputs, 3)
    torch.cuda.synchronize()
    check(case, got, s1.plain(case, inputs, 3))


@pytest.mark.parametrize("case", ["M1", "M1b"])
@pytest.mark.parametrize("reps", [1, 16])
def test_mosaic_fold_is_bit_equal(case, reps):
    """The fold through its shared-memory ring at G=3, bit-equal to its plain
    version (slots and checksum): M1b at eps 1 holds 33,792 elements a g,
    eight whole chunks and a short one; M1 132 whole chunks."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    inputs = s1.make_inputs(case, 3, 1, seed=7, device="cuda")
    n = inputs[0][0].numel()
    assert (n % s1.FOLD_CHUNK != 0) == (case == "M1b")
    before = s1.launches
    slots, cks = s1.run(case, inputs, reps)
    torch.cuda.synchronize()
    assert s1.launches == before + 1
    want_slots, want_cks = s1.plain(case, inputs, reps)
    assert torch.equal(slots.view(torch.int32), want_slots.view(torch.int32))
    assert torch.equal(cks, want_cks)


@pytest.mark.parametrize("G,n", [
    (1024, 264 * 128),           # phase 13's shape
    (5, 1_003),                  # G n % 4 = 3: the scalar tail
], ids=["phase13", "tail"])
def test_mosaic_tiny_is_bit_equal(G, n):
    """M5 bit-equal to its plain version (reps 16), 16-byte vectors and the
    partial last vector alike."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    rng = np.random.default_rng(G + n)
    x = ((torch.as_tensor(rng.integers(0, 256, (G, n), dtype=np.uint8)).float() + 0.5) / 128
         ).to("cuda")
    before = s1.launches
    got, _ = s1.run("M5", (x,), 16)
    torch.cuda.synchronize()
    assert s1.launches == before + 1
    want, _ = s1.plain("M5", (x,), 16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_mosaic_tiny_refuses_misaligned_input():
    """M5's 16-byte loads need a 16-byte aligned x: one that is not is
    refused by name before any launch."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    x = torch.ones(4 * 1000 + 1, device="cuda")[1:].view(4, 1000)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = s1.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        s1.run("M5", (x,), 16)
    assert s1.launches == before


@pytest.mark.parametrize("G,eps", [(2, 1), (1024, 4)], ids=["G2", "phase13"])
def test_mosaic_compact_is_bit_equal(G, eps):
    """M7, the compaction network in registers, bit-equal to its plain
    version (slots and checksum) at G=2 and at phase 13's G=1024, eps 4,
    reps 16."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    inputs = s1.make_inputs("M7", G, eps, seed=5, device="cuda")
    before = s1.launches
    slots, cks = s1.run("M7", inputs, 16)
    torch.cuda.synchronize()
    assert s1.launches == before + 1
    want_slots, want_cks = s1.plain("M7", inputs, 16)
    assert torch.equal(slots.view(torch.int32), want_slots.view(torch.int32))
    assert torch.equal(cks, want_cks)


def _wide(rng, shape):
    """float32 in [2^24, 2^25), all mantissa bits drawn: sums round, so the
    order of the adds shows."""
    m = rng.integers(0, 2 ** 23, size=shape, dtype=np.uint32)
    return torch.from_numpy((m | np.uint32(151 << 23)).view(np.float32)).to("cuda")


@pytest.mark.parametrize("case,G,eps,reps", [
    ("M4", 1024, 4, 16), ("M4", 3, 4, 1), ("M4", 3, 4, 16),
    ("M2", 1024, 4, 16), ("M2", 3, 4, 1), ("M2", 3, 4, 16), ("M2", 3, 1, 16),
    ("M2", 3, 2, 16),
], ids=["M4-phase13", "M4-G3-rep1", "M4-G3", "M2-phase13", "M2-G3-rep1", "M2-G3",
        "M2-rows24", "M2-rows48"])
def test_mosaic_relayout_is_bit_equal(case, G, eps, reps):
    """M4 (one load a rep into 11 chains) and M2 (the tile through shared
    memory) bit-equal to their plain versions (slots and M4's checksum), a
    launch counted: at phase 13's shape on the script's inputs, and at G=3
    with reps 1 and 16 (M2 also at rows 24 and 48) on values past 2^24,
    where the order of the adds shows."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    inputs = s1.make_inputs(case, G, eps, seed=11, device="cuda")
    if G == 3:
        inputs = (_wide(np.random.default_rng(eps + reps), tuple(inputs[0].shape)),)
    before = s1.launches
    slots, cks = s1.run(case, inputs, reps)
    torch.cuda.synchronize()
    assert s1.launches == before + 1
    want_slots, want_cks = s1.plain(case, inputs, reps)
    assert torch.equal(slots.view(torch.int32), want_slots.view(torch.int32))
    if case == "M4":
        assert torch.equal(cks, want_cks)
    else:
        assert cks is None and want_cks is None


@pytest.mark.parametrize("case,shape", [("M2", (2, 24, 128)), ("M4", (2, 264, 128))])
def test_mosaic_relayout_refuses_misaligned_input(case, shape):
    """M2's and M4's 16-byte loads need a 16-byte aligned x: one that is not
    is refused by name before any launch."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    x = torch.ones(int(np.prod(shape)) + 1, device="cuda")[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = s1.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        s1.run(case, (x,), 16)
    assert s1.launches == before


@pytest.mark.parametrize("case,bad", [("M2", (2, 24, 64)), ("M2", (2, 300, 128)),
                                      ("M4", (2, 100))])
def test_mosaic_relayout_never_takes_the_plain_version(monkeypatch, case, bad):
    """For CUDA tensors M2's and M4's wrappers launch their kernels or raise:
    a shape the kernel does not take (M2's rows of other than 128 floats or
    past its shared-memory tile, M4's n not a multiple of 128) is refused,
    never handed to the plain version."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(s1, "plain", plain)
    before = s1.launches
    with pytest.raises(ValueError):
        s1.run(case, (torch.ones(bad, device="cuda"),), 2)
    assert s1.launches == before
    s1.run(case, s1.make_inputs(case, 2, 1, seed=0, device="cuda"), 2)
    torch.cuda.synchronize()
    assert s1.launches == before + 1


@pytest.mark.parametrize("G,reps", [(1024, 1), (1024, 16), (1024, 30), (3, 16), (3, 30)],
                         ids=["phase13-rep1", "phase13", "phase13-rep30", "G3", "G3-rep30"])
def test_mosaic_droll_is_bit_equal(G, reps):
    """M3 (x[g] staged in shared memory, eight chains a thread) bit-equal to
    its plain version, a launch counted: at phase 13's G=1024 on the
    script's inputs with reps 1, 16 and 30 (past the wrap of the 24
    shifts), and at an odd G=3 on values past 2^24, where the order of the
    adds shows."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    inputs = s1.make_inputs("M3", G, 4, seed=13, device="cuda")
    if G == 3:
        inputs = (_wide(np.random.default_rng(reps), tuple(inputs[0].shape)), inputs[1])
    before = s1.launches
    slots, cks = s1.run("M3", inputs, reps)
    torch.cuda.synchronize()
    assert s1.launches == before + 1 and cks is None
    want, _ = s1.plain("M3", inputs, reps)
    assert torch.equal(slots.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape,misaligned", [((2, 24, 128), False), ((2, 80, 128), False),
                                              ((2, 16, 64), False), ((2, 16, 128), True)],
                         ids=["rows24", "rows80", "width64", "misaligned"])
def test_mosaic_droll_refuses_shapes_it_does_not_take(monkeypatch, shape, misaligned):
    """M3's wrapper launches its kernel or raises: rows that are not a
    multiple of 16 or past 64, rows of other than 128 floats and a
    misaligned x are refused by name before any launch, never handed to the
    plain version."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(s1, "plain", plain)
    n = int(np.prod(shape))
    x = (torch.ones(n + 1, device="cuda")[1:] if misaligned
         else torch.ones(n, device="cuda")).view(shape)
    shifts = torch.zeros((1, s1.NSHIFT), dtype=torch.int32, device="cuda")
    before = s1.launches
    with pytest.raises(ValueError, match="16-byte aligned" if misaligned else "M3 takes"):
        s1.run("M3", (x, shifts), 2)
    assert s1.launches == before


# ---- the redesigned kernels: K1 (persistent, word stores) and S1's GEMMs (TMA + wgmma) ----

def _synthetic_render(E, A, T, G=5, g_all=None, seed=0, device="cuda", K=4):
    """Random render inputs from numpy: a 20x23 grid with 30 block ids of up
    to K tokens (block 0 none), an 11x11 window in center-out order, agents
    anywhere (windows past the map's edges), G global tokens of which each
    agent has 0-G (or ``g_all``)."""
    rng = np.random.default_rng(seed)
    H, W, NB, half = 20, 23, 30, 5
    offs = sorted(((dr, dc) for dr in range(-half, half + 1) for dc in range(-half, half + 1)),
                  key=lambda d: (abs(d[0]) + abs(d[1]), d))
    sb = rng.integers(0, NB, (E, H, W))
    sb[rng.random((E, H, W)) < 0.7] = 0
    counts = rng.integers(0, K + 1, (E, NB))
    counts[:, 0] = 0
    rc = np.stack([rng.integers(0, H, (E, A)), rng.integers(0, W, (E, A))], -1)
    g_count = (rng.integers(0, G + 1, (E, A)) if g_all is None else np.full((E, A), g_all))
    arrays = (sb, rng.integers(0, 256, (E, NB, K, 2)), counts, rc, g_count,
              rng.integers(0, 256, (E, A, G, 3)), np.array(offs))
    dtypes = (torch.int32, torch.uint8, torch.int32, torch.int32, torch.int32, torch.uint8,
              torch.int32)
    args = tuple(torch.as_tensor(x).to(dt).contiguous().to(device)
                 for x, dt in zip(arrays, dtypes))
    return args[:6] + (args[6],), (T, half, half)


def _cut_inside_a_cell(args, T):
    """Whether some agent's cut at T falls inside a window cell's tokens."""
    sb, _, counts, rc, g_count, _, scan = (x.cpu().long() for x in args)
    E, H, W = sb.shape
    rr, cc = rc[..., 0:1] + scan[:, 0], rc[..., 1:2] + scan[:, 1]
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    b = sb.reshape(E, -1).gather(1, (rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1))
                                 .reshape(E, -1)).reshape(rr.shape) * inb
    n = counts.gather(1, b.reshape(E, -1)).reshape(b.shape) * inb
    end = g_count[..., None] + n.cumsum(-1)
    return bool(((end - n < T) & (end > T)).any())


@pytest.mark.parametrize("E,A,T,G,g_all", [
    (6, 40, 50, 5, None),        # more agents than a warp-per-agent block of the old design
    (1, 24, 200, 5, None),       # one env: fewer agents than the grid has warps
    (4097, 24, 30, 5, None),     # not a multiple of the grid
    (16, 24, 7, 5, None),        # rows of 21 bytes; A*T*3 = 504, not a multiple of 16
    (8, 24, 3, 5, 5),            # more global tokens than T
], ids=["A40", "E1", "E4097", "T7", "globals_over_T"])
def test_k1_matches_plain_on_synthetic_inputs(E, A, T, G, g_all):
    """K1 byte-equal to its plain version where the persistent schedule and
    the word stores meet their edges; S5's ``none`` (the ablation's launch of
    mask 0) byte-equal to it on the same inputs."""
    from metta_tpu_torch.ops import ablate_obs as ab

    args, extra = _synthetic_render(E, A, T, G, g_all, device=_cuda())
    if T == 7:
        assert _cut_inside_a_cell(args, T)
    before = k1.launches
    got = k1.render_obs3(*args, *extra)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert torch.equal(got, k1.render_obs3_plain(*args, *extra))
    assert torch.equal(ab.render_obs3_ablated(set(), *args, *extra), got)


@pytest.mark.parametrize("T,g_all", [(200, None), (7, None), (3, 5)],
                         ids=["T200", "T7", "globals_over_T"])
def test_k1_ablation_masks_match_plain_on_synthetic_inputs(T, g_all):
    """Every S5 mask of K1 equal to its plain version in the bytes it
    defines at E=8, windows past the map's edges: rows of 600 bytes, of 21
    (word offsets 0-3, where the stubbed token words and fill start), and
    more global tokens than T; ``none`` byte-equal to the render."""
    from metta_tpu_torch.ops import ablate_obs as ab

    args, extra = _synthetic_render(8, 24, T, 5, g_all, seed=11, device=_cuda())
    render = k1.render_obs3(*args, *extra)
    for v in ab.variants(ab.SECTIONS3):
        skips = ab.skips_of(v, ab.SECTIONS3)
        before = ab.launches_obs3
        got = ab.render_obs3_ablated(skips, *args, *extra)
        torch.cuda.synchronize()
        assert ab.launches_obs3 == before + 1
        want, defined = ab.render_obs3_ablated_plain(skips, *args, *extra)
        assert not bool(((got != want) & defined).any()), v
        if not skips:
            assert bool(defined.all()) and torch.equal(got, render)


def _rank_args(args, extra):
    """K4's arguments for the synthetic inputs: the scan's rank table and the
    window's height and width in place of the scan and its half widths."""
    T, ohr, owr = extra
    return args[:6], (k4.rank_table(args[6], 2 * owr + 1), T, 2 * ohr + 1, 2 * owr + 1)


@pytest.mark.parametrize("E,A,T,G,g_all,K", [
    (6, 40, 50, 5, None, 4),     # more agents than a warp per agent of a block
    (1, 24, 200, 5, None, 4),    # one env: fewer agents than the grid has warps
    (4097, 24, 30, 5, None, 4),  # not a multiple of the grid
    (16, 24, 7, 5, None, 4),     # rows of 21 bytes, a cut inside a cell
    (8, 24, 3, 5, 5, 4),         # more global tokens than T
    (16, 24, 200, 5, None, 5),   # odd K: 16-bit token loads, cells past four tokens
    (16, 24, 200, 5, None, 6),   # even K: 32-bit pairs, cells past four tokens
], ids=["A40", "E1", "E4097", "T7", "globals_over_T", "K5", "K6"])
def test_k4_matches_plain_on_synthetic_inputs(E, A, T, G, g_all, K):
    """K4 byte-equal to its plain version and to K1's where the persistent
    schedule, the preloaded tokens and the word stores meet their edges;
    S4's ``none`` (the ablation's launch of mask 0) byte-equal to it on the
    same inputs where the window takes one pass."""
    from metta_tpu_torch.ops import ablate_obs as ab

    args3, extra3 = _synthetic_render(E, A, T, G, g_all, device=_cuda(), K=K)
    if T == 7:
        assert _cut_inside_a_cell(args3, T)
    args, extra = _rank_args(args3, extra3)
    before = k4.launches
    got = k4.render_obs2(*args, *extra)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    assert torch.equal(got, k4.render_obs2_plain(*args, *extra))
    assert torch.equal(got, k1.render_obs3_plain(*args3, *extra3))
    assert torch.equal(ab.render_obs2_ablated(set(), *args, *extra), got)


@pytest.mark.parametrize("T,g_all", [(200, None), (7, None), (3, 5)],
                         ids=["T200", "T7", "globals_over_T"])
def test_k4_ablation_masks_match_plain_on_synthetic_inputs(T, g_all):
    """Every S4 mask of K4 equal to its plain version in the bytes it
    defines at E=8, windows past the map's edges: rows of 600 bytes, of 21
    (word offsets 0-3, where the stubbed token words and fill start), and
    more global tokens than T; ``none`` byte-equal to the render."""
    from metta_tpu_torch.ops import ablate_obs as ab

    args, extra = _rank_args(*_synthetic_render(8, 24, T, 5, g_all, seed=11, device=_cuda()))
    render = k4.render_obs2(*args, *extra)
    for v in ab.variants(ab.SECTIONS2):
        skips = ab.skips_of(v, ab.SECTIONS2)
        before = ab.launches_obs2
        got = ab.render_obs2_ablated(skips, *args, *extra)
        torch.cuda.synchronize()
        assert ab.launches_obs2 == before + 1
        want, defined = ab.render_obs2_ablated_plain(skips, *args, *extra)
        assert not bool(((got != want) & defined).any()), v
        if not skips:
            assert bool(defined.all()) and torch.equal(got, render)


def test_k4_ablation_masks_match_plain_on_combat():
    """Every S4 mask equal to its plain version in the bytes it defines on
    combat at E=64 after a few random steps; ``none`` byte-equal to K4."""
    from metta_tpu_torch.ops import ablate_obs as ab

    cfg = make_combat(A)
    cfg.game.map_builder.seed = 1234
    env = MettaGridEnv(cfg, num_envs=64, seed=0, track_stats=False, step_mode="batched",
                       device=_cuda())
    env.reset()
    gen = torch.Generator(device="cuda").manual_seed(4)
    t = env.tables
    for _ in range(3):
        env.step(torch.randint(0, t.n_actions, (64, A), generator=gen, device="cuda"))
    s = env.state.env
    args = k1.prep_env3(s, t, s.executed_action, s.reward)
    extra = (k4.rank_table(t.obs_scan, t.obs_width), t.num_obs_tokens, t.obs_height,
             t.obs_width)
    render = k4.render_obs2(*args, *extra)
    for v in ab.variants(ab.SECTIONS2):
        skips = ab.skips_of(v, ab.SECTIONS2)
        got = ab.render_obs2_ablated(skips, *args, *extra)
        want, defined = ab.render_obs2_ablated_plain(skips, *args, *extra)
        torch.cuda.synchronize()
        assert not bool(((got != want) & defined).any()), v
        if not skips:
            assert bool(defined.all()) and torch.equal(got, render)


def test_k4_ablation_refuses_windows_past_one_pass():
    """S4's stubs take one pass: a 13x13 window (169 cells, which K4 itself
    renders in two) is refused by name before any launch."""
    from metta_tpu_torch.ops import ablate_obs as ab

    args, (_, T, _, _) = _rank_args(*_synthetic_render(2, 24, 40, device=_cuda()))
    rank = torch.arange(13 * 13, dtype=torch.int32, device="cuda")
    before = ab.launches_obs2
    with pytest.raises(ValueError, match="window cells"):
        ab.render_obs2_ablated(set(), *args, rank, T, 13, 13)
    assert ab.launches_obs2 == before


def test_k4_matches_plain_on_the_curriculum_tables():
    """K4 at the curriculum learner's E=170 on the 16 tasks' stacked tables
    (each env reads its own task's), byte-equal to its plain version and to
    S4's ``none`` (mask 0 through the ablation's launch) over a few steps."""
    from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped, make_curriculum
    from metta_tpu_torch.engine.tables import tables_at
    from metta_tpu_torch.engine.taskset import MultiTaskEnv
    from metta_tpu_torch.ops import ablate_obs as ab

    base = make_arena_basic_easy_shaped(A)
    base.game.map_builder.seed = 1234
    cfgs = [t.get_env_cfg() for t in make_curriculum(base).active_tasks()]
    env = MultiTaskEnv(cfgs, num_envs=170, seed=0, track_stats=True, device=_cuda())
    env.reset()
    gen = torch.Generator(device="cuda").manual_seed(2)
    t = env.tables
    extra = (k4.rank_table(t.obs_scan, t.obs_width), t.num_obs_tokens, t.obs_height,
             t.obs_width)
    for _ in range(3):
        env.step(torch.randint(0, env.compiled.n_actions, (170, A), generator=gen, device="cuda"))
        st = env.state
        s = st.env
        args = k1.prep_env3(s, tables_at(env.tsdata.tables, st.task_id), s.executed_action,
                            s.reward)
        got = k4.render_obs2(*args, *extra)
        torch.cuda.synchronize()
        assert torch.equal(got, k4.render_obs2_plain(*args, *extra))
        assert torch.equal(ab.render_obs2_ablated(set(), *args, *extra), got)
    assert len(set(env.state.task_id.tolist())) > 1


def test_k4_wrapper_never_takes_the_plain_version(monkeypatch):
    """A CUDA input launches the kernel or raises; it never reaches the plain
    version."""
    args, extra = _rank_args(*_synthetic_render(3, 24, 40, device=_cuda()))
    want = k4.render_obs2_plain(*args, *extra)

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(k4, "render_obs2_plain", plain)
    before = k4.launches
    assert torch.equal(k4.render_obs2(*args, *extra), want)
    assert k4.launches == before + 1
    shape = k4.launch_shape(extra[2] * extra[3], extra[1])
    assert shape["per_sm"] >= 1 and shape["sms"] >= 1
    assert shape["smem"] == k4.render2_smem_bytes(extra[2] * extra[3], extra[1])


def test_k4_wrapper_refuses_sizes_beyond_its_maxima():
    """A window over ``MAX_CELLS`` cells or a row over ``MAX_TOKENS`` tokens
    is refused by name before any launch."""
    args, (rank, T, wh, ww) = _rank_args(*_synthetic_render(2, 24, 40, device=_cuda()))
    before = k4.launches
    big = torch.arange(17 * 17, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="window cells"):
        k4.render_obs2(*args, big, T, 17, 17)
    with pytest.raises(ValueError, match="num_tokens"):
        k4.render_obs2(*args, rank, k4.MAX_TOKENS + 1, wh, ww)
    assert k4.launches == before


def test_k1_wrapper_never_takes_the_plain_version(monkeypatch):
    """A CUDA input launches the kernel or raises; it never reaches the plain
    version."""
    args, extra = _synthetic_render(3, 24, 40, device=_cuda())
    want = k1.render_obs3_plain(*args, *extra)

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(k1, "render_obs3_plain", plain)
    before = k1.launches
    assert torch.equal(k1.render_obs3(*args, *extra), want)
    assert k1.launches == before + 1
    shape = k1.launch_shape(args[6].shape[0], extra[0])
    assert shape["per_sm"] >= 1 and shape["sms"] >= 1


def _bf16(rng, *shape):
    u = torch.as_tensor(rng.integers(0, 256, size=shape, dtype=np.uint8)).float()
    return ((2 * u - 255) / 128).to(torch.bfloat16).to("cuda")


@pytest.mark.parametrize("case", ["M6a", "M6b", "M6c"])
def test_gemm_at_default_depth(case):
    """The GEMMs at the JAX scripts' default depth (72, and 288 at eps 4)
    with F=384 rows, within ``check``'s tolerance of the plain version."""
    from metta_tpu_torch.ops import ubench_mosaic as s1
    from metta_tpu_torch.scripts.ubench_mosaic import check

    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    if case == "M6a":
        inputs = _bf16(rng, 3, 4, 384, 72), _bf16(rng, 3, 4, 72, 128)
    else:
        inputs = _bf16(rng, 3, 384, 288), _bf16(rng, 3, 288, 128)
    before = s1.launches_gemm
    got = s1.run(case, inputs, 1)
    torch.cuda.synchronize()
    assert s1.launches_gemm == before + 1
    check(case, got, s1.plain(case, inputs, 1))


def test_gemm_boxes_match_the_kernel():
    """The built library picks the depth boxes ``gemm_boxes`` mirrors."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    for Kd in range(8, 513, 8):
        assert s1.gemm_boxes_built(Kd) == [(c, w) for c, w, _ in s1.gemm_boxes(Kd)], Kd
    shape = s1.gemm_launch_shape(4, 72)
    assert shape["stages"] == s1.gemm_stages(4, 72) and shape["per_sm"] == 1


def test_gemm_wrapper_checks_inputs(monkeypatch):
    """The GEMM wrapper refuses a depth that is not a multiple of 8 and rows
    that are not a multiple of 128, and never reaches the plain version."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    _cuda()
    rng = np.random.default_rng(1)

    def plain(*_):
        raise AssertionError("the plain version ran on CUDA inputs")
    monkeypatch.setattr(s1, "_gemm_plain", plain)
    monkeypatch.setattr(s1, "plain", plain)
    before = s1.launches_gemm
    for a, b in ((_bf16(rng, 2, 384, 140), _bf16(rng, 2, 140, 128)),
                 (_bf16(rng, 2, 320, 144), _bf16(rng, 2, 144, 128))):
        with pytest.raises(ValueError):
            s1.run("M6b", (a, b), 1)
    with pytest.raises(ValueError):
        s1.run("M6a", (_bf16(rng, 2, 2, 384, 68), _bf16(rng, 2, 2, 68, 128)), 1)
    assert s1.launches_gemm == before
    s1.run("M6c", (_bf16(rng, 2, 384, 144), _bf16(rng, 2, 144, 128)), 1)
    assert s1.launches_gemm == before + 1
