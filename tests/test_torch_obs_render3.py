"""The port's obs prep + render against ``metta_tpu``'s renderers.

``render_obs3_plain`` on the port's ``prep_env3`` must equal the JAX
``render_observations_mm`` (the renderer the JAX env runs on the CPU, byte-
identical to the Pallas v3 kernel, see ``tests/test_obs_pallas3.py``) on
rolled combat states, byte for byte: also under a tiny token budget, and on
a window outside the TPU kernel's limits, against the JAX gather renderer
``render_observations_ref``. The wrapper takes the plain version for CPU
tensors; the CUDA kernel itself is held against it on a GPU by
``tests/test_torch_cuda.py`` (skipped without one) and by ``chip_smoke.py``.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metta_tpu.builder.envs import make_combat
from metta_tpu.engine.compiler import compile_game
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.engine.obs import render_observations_ref
from metta_tpu.engine.obs_mm import render_observations_mm
from metta_tpu.engine.tables import Tables, attach_static_block_grid
from metta_tpu.ops.obs_render3 import supports_v3
from metta_tpu_torch.convert import state_from_numpy, tables_from_compiled
from metta_tpu_torch.ops import obs_render3 as pk

E, A = 4, 24


def _cfg(**obs):
    cfg = make_combat(num_agents=A)
    cfg.game.map_builder.seed = 1234
    for k, v in obs.items():
        setattr(cfg.game.obs, k, v)
    return cfg


@pytest.fixture(scope="module")
def rolled():
    """The JAX combat env and its states after 0, 3 and 8 random steps."""
    env = MettaGridEnv(_cfg(), num_envs=E, desync_episodes=False,
                       track_stats=True, step_mode="batched")
    key = jax.random.PRNGKey(5)
    vstate, _ = env.reset_fn(key)
    states = {0: vstate.env}
    for i in range(8):
        acts = jax.random.randint(jax.random.fold_in(key, i), (E, A), 0,
                                  len(env.action_names), dtype=jnp.int32)
        vstate, *_ = env.step_fn(vstate, acts)
        states[i + 1] = vstate.env
    env.render_mm = _jax_render(render_observations_mm, env.tables)
    return env, states


def _jax_tables(env, **obs):
    """JAX tables of the same map with another obs config."""
    cfg = _cfg(**obs)
    compiled, init = compile_game(cfg.game, env.game_map)
    tables = Tables(compiled, track_stats=True)
    attach_static_block_grid(tables, env._template[0])
    return compiled, init, tables


def _port_render(compiled, init, jstate):
    tables = tables_from_compiled(compiled, init)
    state = state_from_numpy({f.name: np.asarray(getattr(jstate, f.name))
                              for f in dataclasses.fields(jstate)})
    args = pk.prep_env3(state, tables, state.executed_action, state.reward)
    return pk.render_obs3(*args, tables.obs_scan, tables.num_obs_tokens,
                          tables.obs_height // 2, tables.obs_width // 2).numpy()


def _jax_render(fn, tables):
    """Jitted batched JAX render of a state with its own actions and rewards."""
    render = jax.jit(jax.vmap(lambda s_, a, r: fn(s_, tables, a, r)))
    return lambda s: np.asarray(render(s, s.executed_action, s.reward))


@pytest.mark.parametrize("steps", [0, 3, 8])
def test_render_matches_mm(rolled, steps):
    env, states = rolled
    s = states[steps]
    want = env.render_mm(s)
    np.testing.assert_array_equal(want, _port_render(env.compiled, env._init, s))


@pytest.mark.parametrize("obs", [
    dict(num_tokens=24),                         # truncation order (test_pl3_truncation_budget)
    dict(width=13, height=13, num_tokens=256),   # 169 cells > the v3 kernel's 128
], ids=["budget24", "window13"])
def test_render_other_obs_configs(rolled, obs):
    env, states = rolled
    compiled, init, tables = _jax_tables(env, **obs)
    s = states[8]
    if "width" in obs:
        assert not supports_v3(tables)
        want = _jax_render(render_observations_ref, tables)(s)
    else:
        want = _jax_render(render_observations_mm, tables)(s)
    got = _port_render(compiled, init, s)
    assert got.shape == (E, A, compiled.num_obs_tokens, 3)
    np.testing.assert_array_equal(want, got)


def test_cpu_wrapper_takes_plain_version(rolled):
    """On CPU tensors the wrapper computes the plain version and launches
    nothing."""
    env, states = rolled
    before = pk.launches
    _port_render(env.compiled, env._init, states[3])
    assert pk.launches == before


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel module builds nothing (no nvcc is needed until a
    CUDA tensor reaches the wrapper)."""
    code = ("import metta_tpu_torch.ops.obs_render3 as m, "
            "metta_tpu_torch.ops.build as b; "
            "assert m._lib is None and m.launches == 0; print('ok')")
    env = {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=pathlib.Path(pk.__file__).resolve().parents[2],
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
