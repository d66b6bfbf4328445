"""The port's batched step against ``metta_tpu``'s ``step_env_batched``.

From the same state, actions and agent order (``perm``), one step of
``metta_tpu_torch.engine.step_batched.step_env_batched`` must equal the JAX
``vmap(step_env_batched(..., render="defer"))`` byte for byte in every
``EnvState`` field (the port keeps no PRNG key) and in the rewards the
observations see. States are the combat map (E=4) with seeded inventories and
vibes, so attacks, freezes, swaps, loot and crafting all fire.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.builder.envs import make_combat
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.engine.step_batched import step_env_batched as jstep
from metta_tpu_torch.convert import state_from_numpy, state_to_numpy, tables_from_compiled
from metta_tpu_torch.engine.step_batched import step_env_batched as pstep

E, A = 4, 24


@pytest.fixture(scope="module")
def setup():
    cfg = make_combat(num_agents=A)
    cfg.game.map_builder.seed = 1234
    env = MettaGridEnv(cfg, num_envs=E, seed=0, desync_episodes=False,
                       track_stats=True, step_mode="batched")
    tables = env.tables
    step = jax.jit(jax.vmap(
        lambda s, a, p: jstep(s, a, tables, render="defer", perm=p)
    ))
    ptables = tables_from_compiled(env.compiled, env._init, track_stats=True)
    vstate, _ = env.reset_fn(jax.random.PRNGKey(0))
    return env, step, ptables, vstate.env


def _to_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def _seeded(state, seed):
    """Reset state with seeded inventories, vibes (a third show the attack
    vibe "gear") and a few frozen agents."""
    rng = np.random.default_rng(seed)
    gear = 17
    return state.replace(
        agent_inv=jnp.asarray(rng.integers(0, 4, (E, A, 10)), jnp.int32),
        agent_vibe=jnp.asarray(rng.choice([0, gear, gear, 3], (E, A)), jnp.int32),
        agent_frozen=jnp.asarray(rng.choice([0] * 9 + [3], (E, A)), jnp.int32),
    )


@pytest.mark.parametrize("seed", [2, 4])
def test_step_byte_identical(setup, seed):
    env, step, ptables, state0 = setup
    rng = np.random.default_rng(100 + seed)
    jstate = _seeded(state0, seed)
    attacks = created = 0
    for i in range(30):
        acts = rng.choice([0, 1, 2, 3, 4, 1, 2, 3, 4, 17], (E, A)).astype(np.int32)
        perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
        pstate = state_from_numpy(_to_numpy(jstate))
        jstate, jrew = step(jstate, jnp.asarray(acts), jnp.asarray(perm))
        pstate, prew = pstep(pstate, torch.as_tensor(acts), ptables,
                             perm=torch.as_tensor(perm))
        want = _to_numpy(jstate)
        got = state_to_numpy(pstate)
        for name, x in got.items():
            w = want[name].reshape(x.shape)
            assert w.dtype == x.dtype, name
            np.testing.assert_array_equal(w, x, err_msg=f"step {i}: {name}")
        np.testing.assert_array_equal(np.asarray(jrew), prew.numpy())
        attacks += int((got["agent_frozen"] == 10).sum())
        created = int(got["game_asm_created"].sum())
    # the run exercised the combat path and the assembler phase
    assert attacks > 0 and created > 0


def test_random_order_from_generator(setup):
    """Without ``perm`` the order comes from the caller's generator: the same
    seed gives the same step."""
    env, _, ptables, state0 = setup
    pstate = state_from_numpy(_to_numpy(_seeded(state0, 2)))
    acts = torch.as_tensor(np.random.default_rng(2).integers(0, 5, (E, A)))
    outs = [pstep(pstate, acts, ptables, generator=torch.Generator().manual_seed(7))[0]
            for _ in range(2)]
    for a, b in zip(state_to_numpy(outs[0]).values(), state_to_numpy(outs[1]).values()):
        np.testing.assert_array_equal(a, b)


def test_inventory_ops_match_jax():
    """``trunc_div`` and the clamped ``inv_update`` (shared limit groups and
    modifiers included) against ``metta_tpu/engine/inventory.py``."""
    from metta_tpu.engine.inventory import inv_update as j_update, trunc_div as j_div
    from metta_tpu_torch.engine.inventory import inv_update as p_update, trunc_div as p_div

    rng = np.random.default_rng(0)
    a = rng.integers(-50, 50, 200).astype(np.int32)
    b = rng.integers(0, 7, 200).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(j_div(jnp.asarray(a), jnp.asarray(b))),
                                  p_div(torch.as_tensor(a), torch.as_tensor(b)).numpy())

    C, R, N = 3, 6, 64
    res_group = rng.integers(0, 3, (C, R)).astype(np.int32)
    group_base = rng.integers(0, 20, (C, R)).astype(np.int32)
    group_mod = rng.integers(0, 3, (C, R, R)).astype(np.int32)
    cls = rng.integers(0, C, N).astype(np.int32)
    inv = rng.integers(0, 12, (N, R)).astype(np.int32)
    delta = rng.integers(-15, 15, N).astype(np.int32)
    jt = tuple(jnp.asarray(x) for x in (res_group, group_base, group_mod))
    pt = tuple(torch.as_tensor(x) for x in (res_group, group_base, group_mod))
    for r in range(R):
        j_new, j_act = jax.vmap(lambda c, i, d: j_update(jt, c, i, r, d))(
            jnp.asarray(cls), jnp.asarray(inv), jnp.asarray(delta))
        p_new, p_act = p_update(pt, torch.as_tensor(cls), torch.as_tensor(inv), r,
                                torch.as_tensor(delta))
        np.testing.assert_array_equal(np.asarray(j_new), p_new.numpy())
        np.testing.assert_array_equal(np.asarray(j_act), p_act.numpy())
