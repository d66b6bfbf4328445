"""The whole slice: the port's ``MettaGridEnv`` against ``metta_tpu``'s.

Combat with 24 agents, E=4, ``step_mode="batched"``, desync on and
``max_steps=12`` so auto-reset fires within the run; ``track_stats=True``
(the torch-ops step) and ``track_stats=False`` (the fused span's path). Each
step's agent order is derived from the JAX state's key exactly as
``metta_tpu/engine/step_batched.py:149-157`` does and handed to the port as
``perm``; the JAX env's desync draws are handed to the port's reset.
Observations, rewards, done and truncated must be byte-identical every step,
and so must the whole state at the end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.builder.envs import make_combat as jax_make_combat
from metta_tpu.engine.env import MettaGridEnv as JaxEnv
from metta_tpu_torch.builder.envs import make_combat
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
                             track_stats=track_stats, device="cpu"),
            )
        return built[track_stats]
    return make


@jax.jit
def _key_perms(keys):
    return jax.vmap(lambda k: jax.random.permutation(jax.random.split(k, 4)[1], A))(keys)


def _perms(vstate):
    """The agent order step_env_batched draws from each env's key."""
    return np.asarray(_key_perms(vstate.env.key))


def _fields(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


@pytest.mark.parametrize("no_reset,track_stats", [(False, True), (True, True), (False, False)],
                         ids=["auto_reset", "no_reset", "auto_reset_no_stats"])
def test_env_byte_identical(make_envs, no_reset, track_stats):
    jenv, penv = make_envs(track_stats)
    vstate, jobs = jenv.reset_fn(jax.random.PRNGKey(3))
    pobs = penv.reset(desync_step=np.asarray(vstate.desync_step))
    np.testing.assert_array_equal(np.asarray(jobs), pobs.numpy())
    jstep = jenv._step_no_reset_fn if no_reset else jenv._step_fn
    pstep = penv.step_no_reset if no_reset else penv.step
    rng = np.random.default_rng(0)
    resets = 0
    for i in range(STEPS):
        acts = rng.integers(0, len(jenv.action_names), (E, A)).astype(np.int32)
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
    if not no_reset:
        assert resets >= E      # desync and max_steps both ended episodes


def test_generator_drives_the_step(make_envs):
    """Without ``perm`` the port draws agent orders and desync steps from its
    own generator: two envs with one seed agree."""
    _, penv = make_envs()
    twin = MettaGridEnv(_cfg(make_combat), num_envs=E, seed=3, desync_episodes=True,
                        track_stats=True, device="cpu")
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
