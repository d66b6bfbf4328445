"""Kernel K5, the v1 per-env render: its plain version against the TPU kernel.

``metta_tpu_torch.ops.obs_render.render_obs1_plain`` on the port's prep of a
state (``prep_obs1``) must equal the JAX package's Pallas kernel,
``render_obs_pallas(..., interpret=True)`` under ``vmap``, byte for byte, on
real states of two configs, as ``tests/test_obs_pallas.py`` runs the kernel.
The port's ``render_observations`` with ``obs_renderer="pl"`` (K5's path)
must equal its ``"ref"`` renderer, and the plain version must equal K1's on
inputs that cut a cell's tokens at T and wrap the location byte. The CUDA
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.builder.envs import make_arena, make_combat
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.ops.obs_render import render_obs_pallas
from metta_tpu_torch.convert import state_from_numpy, tables_from_compiled
from metta_tpu_torch.engine.obs import render_observations
from metta_tpu_torch.ops import obs_render as k5
from metta_tpu_torch.ops.obs_render3 import render_obs3_plain
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

E, STEPS = 2, 3


def _args(t):
    return t.obs_scan, t.num_obs_tokens, t.obs_height // 2, t.obs_width // 2


@pytest.mark.parametrize("maker,agents", [(make_arena, 6), (make_combat, 8)],
                         ids=["arena6", "combat8"])
def test_plain_matches_pallas_kernel(maker, agents):
    cfg = maker(num_agents=agents)
    cfg.game.map_builder.seed = 77
    env = MettaGridEnv(cfg, num_envs=E, seed=3, desync_episodes=False, step_mode="sequential")
    env.tables.obs_renderer = "ref"            # the fast XLA renderer steps the env
    tables = env.tables
    pal = jax.jit(jax.vmap(lambda s: render_obs_pallas(
        s, tables, s.executed_action, s.reward, interpret=True)))
    ptables = tables_from_compiled(env.compiled, env._init)
    vstate, _ = env.reset_fn(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    for t in range(STEPS):
        s = vstate.env
        pstate = state_from_numpy({f.name: np.asarray(getattr(s, f.name))
                                   for f in dataclasses.fields(s)})
        got = k5.render_obs1_plain(*k5.prep_obs1(pstate, ptables, pstate.executed_action,
                                                 pstate.reward), *_args(ptables))
        np.testing.assert_array_equal(np.asarray(pal(s)), got.numpy(), err_msg=f"step {t}")
        acts = rng.integers(0, env.compiled.n_actions, (E, env.num_agents)).astype(np.int32)
        vstate, *_ = env.step_fn(vstate, jnp.asarray(acts))


def test_pl_renderer_matches_ref():
    """``render_observations`` by ``obs_renderer``: "pl" (K5's plain version
    on the CPU) equals "ref" on stepped combat states."""
    from metta_tpu_torch.builder.envs import make_combat as make
    from metta_tpu_torch.engine.env import MettaGridEnv as Env

    cfg = make(24)
    cfg.game.map_builder.seed = 1234
    env = Env(cfg, num_envs=3, seed=0, device="cpu")
    env.reset()
    rng = np.random.default_rng(4)
    for _ in range(4):
        env.step(rng.integers(0, env.tables.n_actions, (3, 24)))
    s, t = env.state.env, env.tables
    outs = {}
    for renderer in ("pl", "ref", "mm"):
        t.obs_renderer = renderer
        outs[renderer] = render_observations(s, t, s.executed_action, s.reward)
    t.obs_renderer = "mm"
    assert torch.equal(outs["pl"], outs["ref"]) and torch.equal(outs["mm"], outs["ref"])
    assert int((outs["pl"][..., 0] != 255).sum(-1).min()) > 3


@pytest.mark.parametrize("T,window", [(200, 11), (24, 11), (40, 17)],
                         ids=["combat", "cut_at_T", "loc_wraps"])
def test_plain_matches_k1_plain(T, window):
    """K5's formulation (two planes merged per cell, scan-order prefix sums,
    a scatter) against K1's (merged grid, searchsorted gather) on random
    inputs: agents on random cells, up to K tokens a block, cells cut at T,
    a 17-wide window whose location byte wraps."""
    rng = np.random.default_rng(T + window)
    En, H, W, A, NB, K, G = 3, 14, 19, 7, 30, 5, 3
    half = window // 2
    d = np.arange(-half, half + 1)
    dr, dc = np.meshgrid(d, d, indexing="ij")
    order = np.argsort(np.abs(dr).ravel() + np.abs(dc).ravel(), kind="stable")
    scan = torch.as_tensor(np.stack([dr.ravel()[order], dc.ravel()[order]], 1).astype(np.int32))
    agent_grid = np.zeros((En, H, W), np.int32)
    rc = np.zeros((En, A, 2), np.int32)
    for e in range(En):
        cells = rng.choice(H * W, A, replace=False)
        rc[e] = np.stack([cells // W, cells % W], 1)
        agent_grid[e].flat[cells] = np.arange(1, A + 1)
    sblock = np.where(rng.random((En, H, W)) < 0.3, rng.integers(A + 1, NB, (En, H, W)), 0)
    counts = rng.integers(0, K + 1, (En, NB)).astype(np.int32)
    counts[:, 0] = 0
    tok = rng.integers(0, 256, (En, NB, K, 2)).astype(np.uint8)
    g_count = rng.integers(0, G + 1, (En, A)).astype(np.int32)
    g_tok = rng.integers(0, 256, (En, A, G, 3)).astype(np.uint8)
    args = [torch.as_tensor(x) for x in (agent_grid, sblock.astype(np.int32), tok, counts, rc,
                                         g_count, g_tok)]
    got = k5.render_obs1_plain(*args, scan, T, half, half)
    merged = torch.where(args[0] > 0, args[0], args[1])
    want = render_obs3_plain(merged, *args[2:], scan, T, half, half)
    assert torch.equal(got, want)
    assert k5.render_obs1(*args, scan, T, half, half).equal(want)   # CPU: the plain version
    assert int((got[..., 0] != 255).sum(-1).max()) == T or T == 200


def test_kernel_module_imports_without_nvcc():
    code = ("import metta_tpu_torch.ops.obs_render as m; "
            "assert m._lib is None and m.launches == 0; print('ok')")
    env = {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=pathlib.Path(k5.__file__).resolve().parents[2],
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
