"""The whole env: the port's ``MettaGridEnv`` against ``metta_tpu``'s.

Combat with 24 agents, E=4, desync on and ``max_steps=12`` so auto-reset
fires within the run. ``step_mode="batched"`` with ``track_stats=True`` (the
torch-ops step) and ``track_stats=False`` (the fused span's path); the
default step mode, the sequential step, with the port's default renderer
and with ``obs_renderer="pl"`` (K5's path); and arena with a shared limit
group over laser and armor, which both packages take from
``step_mode="batched"`` into the sequential step. Each step's agent order
is derived from the JAX state's key exactly as both JAX steps draw it
(``metta_tpu/engine/step_batched.py:149-157``, ``step.py:160-169``) and
handed to the port as ``perm``; the JAX env's desync draws are handed to the
port's reset. Observations, rewards, done and truncated must be
byte-identical every step, and so must the whole state at the end.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.builder.envs import make_arena as jax_make_arena
from metta_tpu.builder.envs import make_combat as jax_make_combat
from metta_tpu.config.mettagrid_config import ResourceLimitsConfig as JaxLimits
from metta_tpu.engine.env import MettaGridEnv as JaxEnv
from metta_tpu_torch.builder.envs import make_arena, make_combat
from metta_tpu_torch.config.mettagrid_config import ResourceLimitsConfig
from metta_tpu_torch.convert import state_to_numpy
from metta_tpu_torch.engine.env import MettaGridEnv

E, A, STEPS = 4, 24, 25


def _cfg(make):
    cfg = make(A)
    cfg.game.map_builder.seed = 1234
    cfg.game.max_steps = 12
    return cfg


@pytest.fixture(scope="module")
def make_envs():
    """(JAX env, port env) with one ``track_stats``, each pair built once."""
    built = {}

    def make(track_stats=True):
        if track_stats not in built:
            built[track_stats] = (
                JaxEnv(_cfg(jax_make_combat), num_envs=E, seed=3, desync_episodes=True,
                       track_stats=track_stats, step_mode="batched"),
                MettaGridEnv(_cfg(make_combat), num_envs=E, seed=3, desync_episodes=True,
                             track_stats=track_stats, step_mode="batched", device="cpu"),
            )
        return built[track_stats]
    return make


@functools.partial(jax.jit, static_argnums=1)
def _key_perms(keys, n_agents):
    return jax.vmap(lambda k: jax.random.permutation(jax.random.split(k, 4)[1], n_agents))(keys)


def _perms(vstate):
    """The agent order either JAX step draws from each env's key."""
    return np.asarray(_key_perms(vstate.env.key, vstate.env.agent_r.shape[1]))


def _fields(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def _run_both(jenv, penv, no_reset=False, steps=STEPS):
    """Step both envs from the JAX reset with the same actions and orders;
    every output equal every step, the whole state equal at the end.
    Returns the number of episode ends."""
    vstate, jobs = jenv.reset_fn(jax.random.PRNGKey(3))
    pobs = penv.reset(desync_step=np.asarray(vstate.desync_step))
    np.testing.assert_array_equal(np.asarray(jobs), pobs.numpy())
    jstep = jenv._step_no_reset_fn if no_reset else jenv._step_fn
    pstep = penv.step_no_reset if no_reset else penv.step
    rng = np.random.default_rng(0)
    resets = 0
    for i in range(steps):
        acts = rng.integers(0, len(jenv.action_names), (E, jenv.num_agents)).astype(np.int32)
        perm = torch.from_numpy(_perms(vstate).copy())
        vstate, *jout = jstep(vstate, jnp.asarray(acts))
        pout = pstep(acts, perm=perm)
        for name, j, p in zip(("obs", "reward", "done", "truncated"), jout, pout):
            np.testing.assert_array_equal(np.asarray(j), p.numpy(), err_msg=f"step {i}: {name}")
        resets += int(np.asarray(jout[2] | jout[3]).sum())
    want, want_env = _fields(vstate), _fields(vstate.env)
    got = state_to_numpy(penv.state)
    for name, x in got["env"].items():
        np.testing.assert_array_equal(want_env[name].reshape(x.shape), x, err_msg=name)
    for name in ("desync_step", "episode_len", "last_episode_reward", "last_episode_gained"):
        np.testing.assert_array_equal(want[name], got[name], err_msg=name)
    return resets


@pytest.mark.parametrize("no_reset,track_stats", [(False, True), (True, True), (False, False)],
                         ids=["auto_reset", "no_reset", "auto_reset_no_stats"])
def test_env_byte_identical(make_envs, no_reset, track_stats):
    jenv, penv = make_envs(track_stats)
    resets = _run_both(jenv, penv, no_reset)
    if not no_reset:
        assert resets >= E      # desync and max_steps both ended episodes


@pytest.fixture(scope="module")
def jax_sequential():
    """The JAX env built without a step mode: its default, the sequential
    step (the XLA gather renderer steps it, byte-identical to its default
    one-hot renderer and faster on the CPU)."""
    jenv = JaxEnv(_cfg(jax_make_combat), num_envs=E, seed=3, desync_episodes=True)
    assert jenv.step_mode == "sequential"
    jenv.tables.obs_renderer = "ref"
    return jenv


@pytest.mark.parametrize("renderer", ["mm", "pl"])
def test_default_env_is_the_sequential_step(jax_sequential, renderer):
    """``MettaGridEnv(cfg)`` without a step mode takes the sequential step
    in both packages; byte-identical over 25 steps with auto-reset and
    desync, with the port's default renderer and with K5's ("pl")."""
    penv = MettaGridEnv(_cfg(make_combat), num_envs=E, seed=3, desync_episodes=True,
                        device="cpu")
    assert penv.step_mode == "sequential"
    penv.tables.obs_renderer = renderer
    assert _run_both(jax_sequential, penv) >= E


def _gear(cfg, limits):
    cfg.game.agent.inventory.limits["gear"] = limits(limit=2, resources=["laser", "armor"])
    cfg.game.map_builder.seed = 6
    cfg.game.max_steps = 12
    return cfg


def test_coupled_limits_fall_back_to_the_sequential_step():
    """Arena with a shared limit group over laser and armor
    (``inv_vector_ok`` False): asked for the batched step, both packages
    take the sequential one, byte-identical over 25 steps."""
    jenv = JaxEnv(_gear(jax_make_arena(12), JaxLimits), num_envs=E, seed=3,
                  desync_episodes=True, step_mode="batched")
    jenv.tables.obs_renderer = "ref"
    penv = MettaGridEnv(_gear(make_arena(12), ResourceLimitsConfig), num_envs=E, seed=3,
                        desync_episodes=True, step_mode="batched", device="cpu")
    assert not penv.tables.inv_vector_ok
    assert jenv.step_mode == penv.step_mode == "sequential"
    assert _run_both(jenv, penv) >= E


def test_generator_drives_the_step(make_envs):
    """Without ``perm`` the port draws agent orders and desync steps from its
    own generator: two envs with one seed agree."""
    _, penv = make_envs()
    twin = MettaGridEnv(_cfg(make_combat), num_envs=E, seed=3, desync_episodes=True,
                        track_stats=True, step_mode="batched", device="cpu")
    outs = []
    for env in (penv, twin):
        env.generator.manual_seed(11)
        env.reset()
        rng = np.random.default_rng(1)
        for _ in range(3):
            obs, *_ = env.step(rng.integers(0, len(env.action_names), (E, A)))
        outs.append((obs, env.state.desync_step))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
