"""The port's exact sequential step against ``metta_tpu``'s ``step_env``.

From the same batch of states and actions, ``metta_tpu_torch.engine.step.
step_env`` must equal ``jax.vmap(metta_tpu.engine.step.step_env)`` byte for
byte, in every ``EnvState`` field (the port keeps no PRNG key) and in the
observations, every step of a short run. Each env's agent order is the one
the JAX step draws from that env's key, derived as
``tests/test_torch_env.py:_perms`` derives it, so every env has its own
order. States start from the JAX reset with seeded inventories (over some
limits), vibes (the configs' attack and transfer vibes on many agents) and a
few frozen agents, so attacks, freezes, swaps, loot, transfers, assembler
uses and the clamps all fire. The configs: navigation, arena, combat,
cooperation, and arena with a shared limit group over laser and armor
(``inv_vector_ok`` False: the per-resource path and ``shared_update``),
once more with a limit modifier (``enforce_limits``). ``shared_update`` and
``enforce_limits`` are also held to the JAX functions on random inputs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.builder import envs as jenvs
from metta_tpu.config.mettagrid_config import ResourceLimitsConfig
from metta_tpu.engine.compiler import compile_game
from metta_tpu.engine.step import make_reset_batch, make_reset_template
from metta_tpu.engine.step import step_env as jstep
from metta_tpu.engine.tables import Tables
from metta_tpu_torch.convert import state_from_numpy, state_to_numpy, tables_from_compiled
from metta_tpu_torch.engine.step import step_env

E, STEPS = 3, 10


def _gear(cfg, modifiers=None):
    cfg.game.agent.inventory.limits["gear"] = ResourceLimitsConfig(
        limit=2, resources=["laser", "armor"], modifiers=modifiers or {})
    return cfg


# name: (builder, map seed)
CONFIGS = {
    "navigation": (lambda: jenvs.make_navigation(2), 11),
    "arena": (lambda: jenvs.make_arena(12), 6),
    "combat": (lambda: jenvs.make_combat(24), 1234),
    "cooperation": (lambda: jenvs.make_cooperation(24), 1234),
    "arena_gear": (lambda: _gear(jenvs.make_arena(12)), 6),
    # each battery held raises the gear limit; spending one drops the excess
    "arena_gear_mods": (lambda: _gear(jenvs.make_arena(12), {"battery_red": 1}), 6),
}


@functools.partial(jax.jit, static_argnums=1)
def _key_perms(keys, A):
    return jax.vmap(lambda k: jax.random.permutation(jax.random.split(k, 4)[1], A))(keys)


def _perms(keys, A):
    """The agent order step_env draws from each env's key."""
    return np.array(_key_perms(keys, A))


def _to_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def _seeded(state, compiled, rng):
    """Inventories 0-3 of every resource, vibes drawn from {0, 3} and the
    attack and transfer vibes, one agent in ten frozen."""
    shape = np.asarray(state.agent_vibe).shape
    vibes = [0, 3] + [int(v) for m in (compiled.attack_vibe_mask, compiled.transfer_vibe_mask)
                      for v in np.flatnonzero(m)] * 2
    vibes = [v for v in vibes if v < compiled.num_vibes]
    return state.replace(
        agent_inv=jnp.asarray(rng.integers(0, 4, np.asarray(state.agent_inv).shape), jnp.int32),
        agent_vibe=jnp.asarray(rng.choice(vibes, shape), jnp.int32),
        agent_frozen=jnp.asarray(rng.choice([0] * 9 + [2], shape), jnp.int32),
    )


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_env_byte_identical(name):
    make, map_seed = CONFIGS[name]
    cfg = make()
    cfg.game.map_builder.seed = map_seed
    compiled, init = compile_game(cfg.game, cfg.game.map_builder.create().build())
    # the JAX package's gather renderer: byte-identical to its default one-hot
    # renderer (tests/test_obs_mm.py) and much faster on the CPU
    tables = Tables(compiled, track_stats=True, obs_renderer="ref")
    ptables = tables_from_compiled(compiled, init, track_stats=True)
    assert ptables.inv_vector_ok == (not name.startswith("arena_gear"))
    assert ptables.has_mods == (name == "arena_gear_mods")
    A = compiled.num_agents
    step = jax.jit(jax.vmap(lambda s, a: jstep(s, a, tables)))
    rng = np.random.default_rng(7)
    jstate, _ = make_reset_batch(tables, init, jax.random.split(jax.random.PRNGKey(5), E),
                                 template=make_reset_template(tables, init))
    jstate = _seeded(jstate, compiled, rng)
    pstate = state_from_numpy(_to_numpy(jstate))
    moves = [i for i, k in enumerate(compiled.action_kind) if k == 1]
    orders_differ = False
    for i in range(STEPS):
        acts = np.where(rng.random((E, A)) < 0.6, rng.choice(moves, (E, A)),
                        rng.integers(-1, compiled.n_actions + 1, (E, A))).astype(np.int32)
        perm = _perms(jstate.key, A)
        orders_differ |= len({tuple(p) for p in perm}) > 1
        jstate, jobs = step(jstate, jnp.asarray(acts))
        pstate, pobs = step_env(pstate, torch.as_tensor(acts), ptables,
                                perm=torch.as_tensor(perm))
        np.testing.assert_array_equal(np.asarray(jobs), pobs.numpy(), err_msg=f"step {i}: obs")
        want = _to_numpy(jstate)
        for field, x in state_to_numpy(pstate).items():
            w = want[field].reshape(x.shape)
            assert w.dtype == x.dtype, field
            np.testing.assert_array_equal(w, x, err_msg=f"step {i}: {field}")
    assert orders_differ                                  # each env its own order


def test_step_env_from_generator():
    """Without ``perm`` each env's order comes from the caller's generator:
    the step equals the step with the orders that generator draws."""
    from metta_tpu_torch.builder.envs import make_combat
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.engine.step_batched import random_perm

    cfg = make_combat(24)
    cfg.game.map_builder.seed = 1234
    env = MettaGridEnv(cfg, num_envs=2, device="cpu")
    state = env.reset_state()[0].env
    acts = torch.as_tensor(np.random.default_rng(2).integers(0, 20, (2, 24)))
    perm = random_perm(2, 24, torch.Generator().manual_seed(7))
    drawn = step_env(state, acts, env.tables, generator=torch.Generator().manual_seed(7))
    given = step_env(state, acts, env.tables, perm=perm)
    assert torch.equal(drawn[1], given[1])
    for field, x in state_to_numpy(drawn[0]).items():
        np.testing.assert_array_equal(x, state_to_numpy(given[0])[field], err_msg=field)


def test_unsupported_names_what_the_sequential_step_lacks():
    """``unsupported()`` still names the assembler chest search, bump
    handlers, damage and AOE for the sequential step, each with its JAX
    source, and no longer names chests, regen, the clipper, the step mode or
    shared limit groups, which the port now runs."""
    from types import SimpleNamespace

    from metta_tpu_torch.engine.step_batched import check_supported, unsupported

    on = SimpleNamespace(inv_vector_ok=False, chest_search_distance=2, has_bump_handlers=True,
                         has_chests=True, has_regen=True, has_damage=True, has_aoe=True,
                         clipper_enabled=True)
    seq = unsupported(on, "sequential")
    for want in ("chest search", "bump_handlers_seq", "apply_damage", "apply_aoe"):
        assert any(want in name for name in seq), want
    for gone in ("chest_use", "_chest_phase", "apply_regen", "clipper_step", "limit groups",
                 "step_mode"):
        assert not any(gone in name for name in seq), gone
    batched = unsupported(on, "batched")
    assert any("limit groups" in name for name in batched)
    assert not any("_chest_phase" in name or "apply_regen" in name or "clipper" in name
                   for name in batched)
    off = SimpleNamespace(inv_vector_ok=False, chest_search_distance=0, has_bump_handlers=False,
                          has_chests=True, has_regen=True, has_damage=False, has_aoe=False,
                          clipper_enabled=True)
    assert unsupported(off, "sequential") == []
    check_supported(off, "sequential")
    with pytest.raises(NotImplementedError, match="limit groups"):
        check_supported(off, "batched")


def test_task_set_refuses_the_sequential_step():
    """A task set keeps the batched step: ``step_mode="sequential"`` names
    the JAX task set's sequential step, still to port."""
    from metta_tpu_torch.builder.envs import make_arena
    from metta_tpu_torch.engine.taskset import MultiTaskEnv

    cfg = make_arena(4)
    cfg.game.map_builder.seed = 3
    with pytest.raises(NotImplementedError, match="taskset.py:144-147"):
        MultiTaskEnv([cfg], num_envs=2, step_mode="sequential", device="cpu")


def test_shared_update_matches_jax():
    """The port's ``shared_update`` (the slots' amounts, clamps and free
    space read once, per-slot deltas out) against the JAX fixpoint over
    inventory rows, on random rows, limits, deltas and masks."""
    from metta_tpu.engine.inventory import shared_update as j_shared
    from metta_tpu_torch.engine.inventory import shared_update as p_shared

    rng = np.random.default_rng(3)
    N, L = 400, 8
    inv = rng.integers(0, 9, (N, L)).astype(np.int32)
    cap = rng.integers(0, 9, (N, L)).astype(np.int32)       # some below the amount held
    delta = rng.integers(-30, 31, N).astype(np.int32)
    valid = rng.random((N, L)) < 0.7
    do = rng.random(N) < 0.8

    def one(inv, cap, delta, valid, do):
        def update(st, i, d):
            new = jnp.clip(st[i] + d, 0, cap[i])
            actual = jnp.where(do, new - st[i], 0)
            return st.at[i].add(actual), actual
        return j_shared(lambda st, i: st[i], lambda st, i: jnp.maximum(cap[i] - st[i], 0),
                        delta, update, inv, valid)

    j_inv, j_used = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (inv, cap, delta, valid,
                                                                      do)))
    t = [torch.as_tensor(x) for x in (inv, cap, delta, valid, do)]
    d, used = p_shared(t[0], t[1], (t[1] - t[0]).clamp(min=0), t[2], t[3], t[4])
    moved = torch.where(t[3] & t[4][:, None], (t[0] + d).clamp(min=0).minimum(t[1]) - t[0], 0)
    np.testing.assert_array_equal(np.asarray(j_inv), (t[0] + moved).numpy())
    np.testing.assert_array_equal(np.asarray(j_used), used.numpy())


def test_enforce_limits_matches_jax():
    """``enforce_limits`` with shared groups and modifiers against the JAX
    function, on random classes and inventories over their limits."""
    from metta_tpu.engine.inventory import enforce_limits as j_enforce
    from metta_tpu_torch.engine.inventory import enforce_limits as p_enforce

    rng = np.random.default_rng(5)
    C, R, N = 3, 6, 300
    res_group = rng.integers(0, 3, (C, R)).astype(np.int32)
    group_base = rng.integers(0, 12, (C, R)).astype(np.int32)
    group_mod = (rng.random((C, R, R)) < 0.2) * rng.integers(1, 4, (C, R, R))
    cls = rng.integers(0, C, N).astype(np.int32)
    inv = rng.integers(0, 15, (N, R)).astype(np.int32)
    jt = tuple(jnp.asarray(x, jnp.int32) for x in (res_group, group_base, group_mod))
    pt = tuple(torch.as_tensor(x.astype(np.int32)) for x in (res_group, group_base, group_mod))
    j_inv, j_drop = jax.jit(jax.vmap(lambda c, i: j_enforce(jt, c, i)))(jnp.asarray(cls),
                                                                        jnp.asarray(inv))
    p_inv, p_drop = p_enforce(pt, torch.as_tensor(cls), torch.as_tensor(inv))
    assert int(p_drop.sum()) > 0
    np.testing.assert_array_equal(np.asarray(j_inv), p_inv.numpy())
    np.testing.assert_array_equal(np.asarray(j_drop), p_drop.numpy())
