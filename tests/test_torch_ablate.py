"""The port's render ablations (``ops/ablate_obs.py``) against the JAX scripts'.

S5 ablates the production K1 (``csrc/obs_render3.cu``), S4 the production
K4 (``csrc/obs_render2.cu``), whose plain version is K1's on the walk of its
rank table. The unablated variant (``none``) of
each plain version must equal the JAX script's own Pallas kernel in
interpret mode, byte for byte, on the same combat state: K1's
(``scripts/ablate_obs3.py:make_kernel``, wired as its ``call_variant`` wires
it) at E=8 with EPS=8, and K4's (``scripts/ablate_obs.py:make_kernel``) at
E=4 with EPS=1. The scripts are loaded by file path; nothing under
``scripts/`` changes. Every stubbed variant must differ from ``none``
somewhere in the bytes it defines (a stub that changes nothing measures
nothing), the wrappers take the plain versions for CPU tensors, K4's
refuses a window past one pass, the masks are the kernels' section bits,
and both CLIs run with ``--device cpu``. The
CUDA kernels themselves are held to these plain versions on a GPU by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import importlib.util
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from metta_tpu.builder.envs import make_combat
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu_torch.convert import state_from_numpy, tables_from_compiled
from metta_tpu_torch.ops import ablate_obs as ab
from metta_tpu_torch.ops import obs_render2 as k4
from metta_tpu_torch.ops import obs_render3 as k1

REPO = pathlib.Path(__file__).resolve().parents[1]
A, E = 24, 8


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def combat():
    """The JAX combat env (map seed 1234, as the scripts build it) reset at
    E=8, and the port's render inputs of the same state."""
    cfg = make_combat(num_agents=A)
    cfg.game.map_builder.seed = 1234
    env = MettaGridEnv(cfg, num_envs=E, desync_episodes=True, track_stats=False,
                       step_mode="batched")
    vstate, _ = env.reset_fn(jax.random.PRNGKey(0))
    st = vstate.env
    tables = tables_from_compiled(env.compiled, env._init)
    state = state_from_numpy({f.name: np.asarray(getattr(st, f.name))
                              for f in dataclasses.fields(st)})
    args = k1.prep_env3(state, tables, state.executed_action, state.reward)
    return env, st, tables, args


def _extra3(t):
    return (t.obs_scan, t.num_obs_tokens, t.obs_height // 2, t.obs_width // 2)


def _extra2(t):
    return (k4.rank_table(t.obs_scan, t.obs_width), t.num_obs_tokens, t.obs_height, t.obs_width)


def test_k1_none_matches_jax_script_kernel(combat):
    """``none`` of K1's ablation against ``scripts/ablate_obs3.py``'s kernel
    with no section stubbed, in interpret mode (E=8, EPS=8)."""
    env, st, tables, args = combat
    s5 = _script("ablate_obs3")
    jt = env.tables
    sbp, cqt, rc, gcnt, g3p = jax.jit(jax.vmap(
        lambda s, ea, rw: s5.prep_env3(s, jt, ea, rw)))(st, st.executed_action, st.reward)
    gcnt_t, g3p_t = jnp.transpose(gcnt, (1, 0, 2)), jnp.transpose(g3p, (1, 0, 2))
    EPS, T, K = 8, jt.num_obs_tokens, jt.max_tokens_per_cell
    NQ, WH = (K + 1) // 2, int(jt.obs_height)
    Hp, Gp = jt.height + 2 * (WH // 2), int(g3p.shape[2])
    Tp = max(((T + 127) // 128) * 128, 256)
    G1 = A * s5.RW
    stt = s5._statics3(jt, A, EPS)
    statics = (stt["bsel"], stt["wrcol"], stt["hlane"], stt["lane16"], stt["spw"], stt["tid"],
               stt["locr"], stt["trilT"], jnp.arange(Tp, dtype=jnp.int32)[None, None, :])
    kern = s5.make_kernel(set(), A=A, T=T, K=K, NQ=NQ, Hp=Hp, Gp=Gp, WH=WH, EPS=EPS, Tp=Tp)
    zero3 = lambda i: (0, 0, 0)  # noqa: E731
    vmem = pltpu.VMEM
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((A, 3, E, T), jnp.uint8),
        grid=(E // EPS,),
        in_specs=[
            pl.BlockSpec((EPS, Hp, 128), lambda i: (i, 0, 0), memory_space=vmem),
            pl.BlockSpec((EPS, NQ + 1, 128), lambda i: (i, 0, 0), memory_space=vmem),
            pl.BlockSpec((EPS, A, 2), lambda i: (i, 0, 0), memory_space=vmem),
            pl.BlockSpec((A, EPS, 1), lambda i: (0, i, 0), memory_space=vmem),
            pl.BlockSpec((A, EPS, Gp), lambda i: (0, i, 0), memory_space=vmem),
            pl.BlockSpec((1, EPS * G1, EPS * A), zero3, memory_space=vmem),
            pl.BlockSpec((1, EPS * G1, 1), zero3, memory_space=vmem),
            *[pl.BlockSpec((1, 1, 128), zero3, memory_space=vmem)] * 5,
            pl.BlockSpec((1, 128, 128), zero3, memory_space=vmem),
            pl.BlockSpec((1, 1, Tp), zero3, memory_space=vmem),
        ],
        out_specs=pl.BlockSpec((A, 3, EPS, T), lambda i: (0, 0, i, 0), memory_space=vmem),
        interpret=True,
    )(sbp, cqt, rc, gcnt_t, g3p_t, *statics)
    want = np.asarray(out).transpose(2, 0, 3, 1)                      # (E, A, T, 3)
    got, defined = ab.render_obs3_ablated_plain(set(), *args, *_extra3(tables))
    assert bool(defined.all())
    np.testing.assert_array_equal(want, got.numpy())


def test_k4_none_matches_jax_script_kernel(combat):
    """``none`` of K4's ablation against ``scripts/ablate_obs.py``'s kernel
    with no section stubbed, in interpret mode (the first 4 envs, EPS=1)."""
    env, st, tables, args = combat
    s4 = _script("ablate_obs")
    n, EPS = 4, 1
    st4 = jax.tree.map(lambda x: x[:n], st)
    jt = env.tables
    sbp, comp_plus, rc, gcnt, g3 = jax.jit(jax.vmap(
        lambda s, ea, rw: s4.o2.prep_env(s, jt, ea, rw)))(st4, st4.executed_action, st4.reward)
    T, K, WIN = jt.num_obs_tokens, jt.max_tokens_per_cell, int(jt.obs_height)
    Hp, Wp = jt.height + 2 * (WIN // 2), jt.width + 2 * (int(jt.obs_width) // 2)
    NB, Gp = int(comp_plus.shape[1]), int(g3.shape[3])
    Tp = ((T + 127) // 128) * 128
    SP, F, C = s4.SP, A * s4.SP, 2 * K + 1
    mperm = jnp.asarray(s4._rank_tril(jt))[None]
    stat = jnp.asarray(s4._static_cols(jt, A))[None]
    bsel = jnp.asarray(np.arange(F)[:, None] // SP == np.arange(A)[None, :]).astype(
        jnp.bfloat16)[None]
    lane = jnp.arange(128, dtype=jnp.float32)[None, None, :]
    tlane = jnp.arange(Tp, dtype=jnp.float32)[None, None, :]
    kern = s4.make_kernel(set(), A=A, S=WIN * WIN, T=T, K=K, NB=NB, Hp=Hp, Wp=Wp, Gp=Gp,
                          WIN=WIN, EPS=EPS, Tp=Tp)
    zero3 = lambda i: (0, 0, 0)  # noqa: E731
    vmem = pltpu.VMEM
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((n, 3, A, T), jnp.uint8),
        grid=(n // EPS,),
        in_specs=[
            pl.BlockSpec((EPS, Hp, Wp), lambda i: (i, 0, 0), memory_space=vmem),
            pl.BlockSpec((EPS, NB, C), lambda i: (i, 0, 0), memory_space=vmem),
            pl.BlockSpec((EPS, A, 2), lambda i: (i, 0, 0), memory_space=vmem),
            pl.BlockSpec((EPS, A, 1), lambda i: (i, 0, 0), memory_space=vmem),
            pl.BlockSpec((EPS, 3, A, Gp), lambda i: (i, 0, 0, 0), memory_space=vmem),
            pl.BlockSpec((1, SP, SP), zero3, memory_space=vmem),
            pl.BlockSpec((1, F, 3), zero3, memory_space=vmem),
            pl.BlockSpec((1, F, A), zero3, memory_space=vmem),
            pl.BlockSpec((1, 1, 128), zero3, memory_space=vmem),
            pl.BlockSpec((1, 1, Tp), zero3, memory_space=vmem),
        ],
        out_specs=pl.BlockSpec((EPS, 3, A, T), lambda i: (i, 0, 0, 0), memory_space=vmem),
        interpret=True,
    )(sbp, comp_plus, rc, gcnt, g3, mperm, stat, bsel, lane, tlane)
    want = np.asarray(out).transpose(0, 2, 3, 1)                      # (E, A, T, 3)
    args4 = tuple(x[:n] for x in args)
    got, defined = ab.render_obs2_ablated_plain(set(), *args4, *_extra2(tables))
    assert bool(defined.all())
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("variant", ab.variants(ab.SECTIONS3)[1:])
def test_k1_stub_changes_defined_bytes(combat, variant):
    _, _, tables, args = combat
    ref = k1.render_obs3_plain(*args, *_extra3(tables))
    got, defined = ab.render_obs3_ablated_plain(ab.skips_of(variant, ab.SECTIONS3), *args,
                                                *_extra3(tables))
    assert bool(((got != ref) & defined).any()), variant


@pytest.mark.parametrize("variant", ab.variants(ab.SECTIONS2)[1:])
def test_k4_stub_changes_defined_bytes(combat, variant):
    _, _, tables, args = combat
    ref = k4.render_obs2_plain(*args, *_extra2(tables))
    got, defined = ab.render_obs2_ablated_plain(ab.skips_of(variant, ab.SECTIONS2), *args,
                                                *_extra2(tables))
    assert bool(((got != ref) & defined).any()), variant


def test_none_plains_match_production_plains(combat):
    _, _, tables, args = combat
    ref = k1.render_obs3_plain(*args, *_extra3(tables))
    assert torch.equal(ab.render_obs3_ablated_plain(set(), *args, *_extra3(tables))[0], ref)
    assert torch.equal(ab.render_obs2_ablated_plain(set(), *args, *_extra2(tables))[0], ref)


def test_cpu_wrappers_take_plain_versions(combat):
    """On CPU tensors the wrappers return the plain versions' output and
    launch nothing; unknown sections are refused."""
    _, _, tables, args = combat
    before = ab.launches_obs3, ab.launches_obs2
    skips = {"copy", "fill"}
    got3 = ab.render_obs3_ablated(skips, *args, *_extra3(tables))
    got2 = ab.render_obs2_ablated({"scan"}, *args, *_extra2(tables))
    assert torch.equal(got3, ab.render_obs3_ablated_plain(skips, *args, *_extra3(tables))[0])
    assert torch.equal(got2, ab.render_obs2_ablated_plain({"scan"}, *args,
                                                          *_extra2(tables))[0])
    assert (ab.launches_obs3, ab.launches_obs2) == before
    with pytest.raises(ValueError):
        ab.skips_of("copy+antidiag", ab.SECTIONS3)


def test_k4_ablation_refuses_windows_past_one_pass(combat):
    """K4's stubs are written for one pass of 128 window cells: a 13x13
    window is refused by name, by the wrapper and by the plain version."""
    _, _, tables, args = combat
    rank = torch.arange(13 * 13, dtype=torch.int32)
    before = ab.launches_obs2
    for fn in (ab.render_obs2_ablated, ab.render_obs2_ablated_plain):
        with pytest.raises(ValueError, match="window cells"):
            fn(set(), *args, rank, tables.num_obs_tokens, 13, 13)
    assert ab.launches_obs2 == before


def test_walk_of_rank_inverts_rank_table(combat):
    """The walk that K4's rank table describes is K1's scan, row for row."""
    _, _, tables, _ = combat
    rank, _, wh, ww = _extra2(tables)
    assert torch.equal(ab.walk_of_rank(rank, wh, ww), tables.obs_scan.to(torch.int32))


def test_masks_are_the_kernels_bits():
    """The wrappers' masks follow the k* constants of the CUDA sources."""
    src3 = (REPO / "metta_tpu_torch" / "csrc" / "obs_render3.cu").read_text()
    src2 = (REPO / "metta_tpu_torch" / "csrc" / "obs_render2.cu").read_text()
    for sections, src in ((ab.SECTIONS3, src3), (ab.SECTIONS2, src2)):
        for i, name in enumerate(sections):
            assert f"constexpr int k{name.capitalize()} = {1 << i};" in src, name
        assert f"constexpr int kAll = {(1 << len(sections)) - 1};" in src


@pytest.mark.parametrize("script", ["ablate_obs3", "ablate_obs"])
def test_cli_runs_on_cpu(script):
    out = subprocess.run(
        [sys.executable, "-m", f"metta_tpu_torch.scripts.{script}", "--device", "cpu",
         "--num-envs", "2", "--steps", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("skip ")]
    sections = ab.SECTIONS3 if script == "ablate_obs3" else ab.SECTIONS2
    assert len(lines) == len(ab.variants(sections))
