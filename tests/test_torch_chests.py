"""Chests, inventory regen and the clipper: the port against ``metta_tpu``.

Each function of the port is held byte for byte to its JAX counterpart,
``vmap``ped over a batch of envs, from the same seeded states: ``apply_regen``
(the vector update and the per-resource loop over coupled groups), the
clipper with the JAX draws fed in (``clipper_step``'s trial, Gumbel vector
and unclip protocol, split from each env's key as the JAX step splits them),
the start-clipped reset, ``refs.chest_update`` and ``ref_update`` with chest
refs, ``inventory_vec.chest_update_multi`` and ``shared_update_multi`` over
mixed agent and chest refs, and the sequential ``chest_use`` (vector and per
resource). Then the batched step with chests, regen and the clipper
(``step_env_batched`` with ``track_stats=True``, the fused step's plain span
with ``track_stats=False``) against the JAX ``step_env_batched``, and the one
case of the JAX package's Pallas K2 in interpret mode with chests, which its
own tests never run, against that XLA step. Every test asserts that its
subject fired: a regen tick, a clip, a chest transfer, an unclip protocol
drawn.

The configs: ``make_mission("basic")`` of ``cogames/missions.py`` with the
catalog's chest station (``CvCChestConfig``, vibe transfers as
``TrainingVariant`` sets them), on a small map dense with stations, with and
without the clipper (singleton limits: the vector paths), and the catalog's
``training_facility.harvest`` and ``.repair`` (coupled "cargo" and "gear"
groups: the per-resource paths; start-clipped stations).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.engine.compiler import compile_game
from metta_tpu.engine.state import KIND_CHEST, KIND_EMPTY
from metta_tpu.engine.tables import Tables
from metta_tpu_torch.convert import state_from_numpy, state_to_numpy, tables_from_compiled
from metta_tpu_torch.engine.clipper import ClipDraws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

E = 6


def chest_cfg(with_clipper=False, size=10, chests=6, seed=3):
    """``make_mission("basic")`` of the JAX package with the catalog's chest
    station placed ``chests`` times on a ``size`` x ``size`` map: the JAX
    counterpart of the port's ``scripts/common.py:chest_mission``, with the
    clipper as an option of the tests."""
    from metta_tpu.cogames import missions, stations, variants

    cfg = missions.make_mission("basic", width=size, height=size, with_clipper=with_clipper)
    cfg.game.objects["chest"] = stations.CvCChestConfig().station_cfg()
    variants.TrainingVariant().modify_env(None, cfg)
    cfg.game.map_builder.instance.objects["chest"] = chests
    cfg.game.map_builder.seed = seed
    return cfg


def tiny_chest_cfg():
    """The interpret-mode case's config: :func:`chest_cfg` cut to one
    assembler, two chests, four vibes and three of the chest's transfers,
    so that the Pallas kernel's unrolled sections stay small."""
    cfg = chest_cfg(size=6, chests=2)
    objects = cfg.game.objects
    cfg.game.objects = {k: objects[k] for k in ("wall", "assembler", "chest")}
    cfg.game.map_builder.instance.objects = {"assembler": 1, "chest": 2}
    cfg.game.actions.change_vibe.vibes = [v for v in cfg.game.actions.change_vibe.vibes
                                          if v.name in ("default", "carbon_a", "carbon_b",
                                                        "heart_b")]
    chest = cfg.game.objects["chest"]
    chest.vibe_transfers = {k: chest.vibe_transfers[k] for k in ("carbon_a", "carbon_b",
                                                                 "heart_b")}
    return cfg


def mission_cfg(name, pkg="metta_tpu"):
    return importlib.import_module(f"{pkg}.cogames.catalog").get_mission(name).make_env()


def _compile(cfg, track_stats=True, clip_period=None):
    compiled, init = compile_game(cfg.game, cfg.game.map_builder.create().build())
    if clip_period is not None:
        compiled = dataclasses.replace(compiled, clip_period=clip_period)
    return (compiled, init, Tables(compiled, track_stats=track_stats, obs_renderer="ref"),
            tables_from_compiled(compiled, init, track_stats=track_stats))


@functools.lru_cache(maxsize=None)
def world(name, track_stats=True, clip_period=None):
    """(compiled, init, JAX tables, port tables) of a named config."""
    cfgs = {"chests": lambda: chest_cfg(), "chests_clipper": lambda: chest_cfg(with_clipper=True),
            "tiny_chests": tiny_chest_cfg,
            "harvest": lambda: mission_cfg("training_facility.harvest"),
            "repair": lambda: mission_cfg("training_facility.repair")}
    return _compile(cfgs[name](), track_stats, clip_period)


def _fields(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def seeded_state(name, rng, keys_seed=5, **kw):
    """A JAX batch of E envs from the reset, with seeded inventories (agents
    0-30 of each resource, chests 0-40), vibes drawn from every vibe and a
    few clipped stations."""
    from metta_tpu.engine.step import make_reset_batch, make_reset_template

    compiled, init, jt, _ = world(name, **kw)
    jstate, _ = make_reset_batch(jt, init, jax.random.split(jax.random.PRNGKey(keys_seed), E),
                                 template=make_reset_template(jt, init))
    inv = jstate.agent_inv.shape
    return jstate.replace(
        agent_inv=jnp.asarray(rng.integers(0, 31, inv), jnp.int32),
        agent_vibe=jnp.asarray(rng.integers(0, compiled.num_vibes, inv[:2]), jnp.int32),
        chest_inv=jnp.asarray(rng.integers(0, 41, jstate.chest_inv.shape), jnp.int32),
        asm_clipped=jnp.asarray(rng.random(jstate.asm_clipped.shape) < 0.3) & jstate.asm_valid,
    )


def assert_states_equal(jstate, pstate, what=""):
    want = _fields(jstate)
    for field, x in state_to_numpy(pstate).items():
        w = want[field].reshape(x.shape)
        assert w.dtype == x.dtype, field
        np.testing.assert_array_equal(w, x, err_msg=f"{what}{field}")


@functools.partial(jax.jit, static_argnums=(1, 2))
def _clip_draws(keys, clip_period, n_unclip):
    """The clipper's draws from each env's step key, as ``step_env`` and
    ``step_env_batched`` split them (``k_clip``, then trial, pick, protocol)."""
    def one(k):
        k_trial, k_pick, k_proto = jax.random.split(jax.random.split(k, 4)[3], 3)
        return (jax.random.randint(k_trial, (), 1, clip_period + 1) == 1,
                k_pick, jax.random.randint(k_proto, (), 0, max(n_unclip, 1)))
    return jax.vmap(one)(keys)


def clip_draws(keys, tables):
    """``ClipDraws`` of the JAX step that starts from ``keys`` [E, 2]."""
    trial, k_pick, proto = _clip_draws(keys, tables.clip_period, tables.n_unclip_protocols)
    NA = tables.n_assembler_slots
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (NA,)))(k_pick)
    return ClipDraws(*(torch.as_tensor(np.array(x)) for x in (trial, gumbel, proto)))


def step_perms(keys, A):
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(jax.random.split(k, 4)[1], A))(
        keys))


def test_chest_mission_builds_like_jax():
    """The port's ``chest_mission`` (K2's chest config on the card) compiles
    to the tables of the same construction with the JAX package's modules."""
    from metta_tpu_torch.engine.compiler import compile_game as pcompile
    from metta_tpu_torch.scripts.common import chest_mission

    jcfg, pcfg = chest_cfg(size=32, chests=2, seed=1234), chest_mission(seed=1234)
    jmap, pmap = (c.game.map_builder.create().build() for c in (jcfg, pcfg))
    np.testing.assert_array_equal(jmap.grid, pmap.grid)
    (jc, _), (pc, _) = compile_game(jcfg.game, jmap), pcompile(pcfg.game, pmap)
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(pc, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert pc.chest_vibe_has.sum() == 9 and (jmap.grid == "chest").sum() == 2


# ---------------------------------------------------------------------------
# regen
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["chests", "harvest"], ids=["vector", "per_resource"])
def test_regen_matches_jax(name):
    """``apply_regen``: the vector update (singleton limits) and the
    per-resource loop (coupled groups), every env ticking (interval 1)."""
    from metta_tpu.engine.rewards import apply_regen as japply
    from metta_tpu_torch.engine.rewards import apply_regen

    compiled, _, jt, pt = world(name)
    assert pt.has_regen and pt.inv_vector_ok == (name == "chests")
    jstate = seeded_state(name, np.random.default_rng(1))
    jstate = jstate.replace(agent_inv=jstate.agent_inv.at[:, :, 0].set(  # energy below its cap
        jnp.asarray(np.random.default_rng(2).integers(0, 120, jstate.agent_r.shape), jnp.int32)))
    pstate = state_from_numpy(_fields(jstate))
    after = jax.jit(jax.vmap(lambda s: japply(s, jt)))(jstate)
    got = apply_regen(pstate, pt)
    assert_states_equal(after, got, "regen: ")
    assert (got.agent_inv != pstate.agent_inv).any()                      # a regen tick


# ---------------------------------------------------------------------------
# the clipper and the start-clipped reset
# ---------------------------------------------------------------------------


def test_clipper_matches_jax():
    """``clipper_step`` with the JAX draws fed in: weighted picks over the
    border and uniform picks where no station is clipped; clip_period 2 so
    that half the trials come up."""
    from metta_tpu.engine.clipper import clipper_step as jclip
    from metta_tpu_torch.engine.clipper import clipper_step

    compiled, _, jt, pt = world("chests_clipper", clip_period=2)
    n = 64
    rng = np.random.default_rng(4)
    base = seeded_state("chests_clipper", rng, clip_period=2)
    one = jax.tree.map(lambda x: x[:1], base)
    jstate = jax.tree.map(lambda x: jnp.repeat(x, n, 0), one)
    clipped = (rng.random((n, compiled.n_assembler_slots)) < 0.2) & np.asarray(jstate.asm_valid)
    clipped[: n // 4] = False                                        # no border: uniform picks
    jstate = jstate.replace(asm_clipped=jnp.asarray(clipped),
                            step=jnp.asarray(rng.integers(1, 50, n), jnp.int32))
    keys = jax.random.split(jax.random.PRNGKey(9), n)
    pstate = state_from_numpy(_fields(jstate))
    after = jax.jit(jax.vmap(lambda s, k: jclip(s, jt, k)))(
        jstate, jax.vmap(lambda k: jax.random.split(k, 4)[3])(keys))
    got = clipper_step(pstate, pt, clip_draws(keys, pt))
    assert_states_equal(after, got, "clipper: ")
    new = got.asm_clipped & ~pstate.asm_clipped
    assert new[: n // 4].any() and new[n // 4:].any()                  # clips of both kinds


def test_start_clipped_reset_matches_jax():
    """``training_facility.repair`` starts its hub stations clipped: the
    template takes the JAX template's unclip protocols and each env of the
    batch its own, drawn from its key (``step.py:36-44``, ``:124-133``)."""
    from metta_tpu.engine.step import make_reset_batch as jreset
    from metta_tpu.engine.step import make_reset_template as jtemplate
    from metta_tpu_torch.engine.step import make_initial_state, make_reset_batch

    compiled, init, jt, pt = world("repair")
    assert init["asm_start_clipped"].any() and pt.clipper_enabled
    NA, nup = compiled.n_assembler_slots, max(compiled.n_unclip_protocols, 1)
    keys = jax.random.split(jax.random.PRNGKey(7), E)
    jstate, jobs = jreset(jt, init, keys, template=jtemplate(jt, init))
    k_clip = jax.random.split(jnp.zeros((2,), jnp.uint32))[1]
    template_protos = np.asarray(jax.random.randint(k_clip, (NA,), 0, nup))
    protos = np.asarray(jax.vmap(
        lambda k: jax.random.randint(jax.random.split(k)[1], (NA,), 0, nup))(keys))
    from metta_tpu_torch.engine.step import initial_observations

    template = make_initial_state(pt, init, unclip_proto=template_protos)
    state, obs = make_reset_batch((template, initial_observations(template, pt)), E,
                                  unclip_proto=protos)
    assert_states_equal(jstate, state, "reset: ")
    np.testing.assert_array_equal(np.asarray(jobs), obs.numpy())
    assert state.asm_clipped.any() and (state.asm_unclip_proto >= 0).any()
    assert len({tuple(p) for p in state.asm_unclip_proto.tolist()}) > 1  # each env its own


# ---------------------------------------------------------------------------
# chest inventories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["chests", "harvest"])
def test_chest_update_matches_jax(name):
    """``refs.chest_update`` of each resource, with the game stats, on
    random deltas (over the limits and below zero) and masks; and
    ``ref_update`` over agent and chest refs."""
    from metta_tpu.engine.refs import chest_update as jchest
    from metta_tpu.engine.refs import ref_update as jref
    from metta_tpu_torch.engine.refs import REF_CHEST, chest_update, ref_update

    compiled, _, jt, pt = world(name)
    rng = np.random.default_rng(5)
    jstate = seeded_state(name, rng)
    pstate = state_from_numpy(_fields(jstate))
    NC, A, R = compiled.n_chest_slots, compiled.num_agents, compiled.num_resources
    moved = 0
    for r in range(R):
        i = rng.integers(0, NC, E).astype(np.int32)
        delta = rng.integers(-60, 70, E).astype(np.int32)
        do = rng.random(E) < 0.8
        jstate, jact = jax.vmap(lambda s, i, d, m: jchest(s, jt, i, r, d, m))(
            jstate, i, delta, do)
        pstate, pact = chest_update(pstate, pt, torch.as_tensor(i), r, torch.as_tensor(delta),
                                    torch.as_tensor(do))
        np.testing.assert_array_equal(np.asarray(jact), pact.numpy())
        moved += int((pact != 0).sum())
        kind = rng.integers(0, 2, E).astype(np.int32)
        idx = np.where(kind == REF_CHEST, rng.integers(0, NC, E), rng.integers(0, A, E))
        jstate, jact = jax.vmap(lambda s, k, i, d, m: jref(s, jt, k, i, r, d, m))(
            jstate, kind, idx.astype(np.int32), delta, do)
        pstate, pact = ref_update(pstate, pt, torch.as_tensor(idx), r, torch.as_tensor(delta),
                                  torch.as_tensor(do), kind=torch.as_tensor(kind))
        np.testing.assert_array_equal(np.asarray(jact), pact.numpy())
    assert_states_equal(jstate, pstate, "chest_update: ")
    assert moved > 0 and (pstate.game_chest_withdrawn > 0).any()


def test_chest_rows_match_jax():
    """``chest_update_multi`` and ``shared_update_multi`` over mixed agent and
    chest refs (two distinct agents and two distinct chests an env)."""
    from metta_tpu.engine.inventory_vec import chest_update_multi as jmulti
    from metta_tpu.engine.inventory_vec import shared_update_multi as jshared
    from metta_tpu_torch.engine.inventory_vec import chest_update_multi, shared_update_multi

    compiled, _, jt, pt = world("chests")
    rng = np.random.default_rng(6)
    jstate = seeded_state("chests", rng)
    pstate = state_from_numpy(_fields(jstate))
    NC, A, R = compiled.n_chest_slots, compiled.num_agents, compiled.num_resources
    for _ in range(3):
        i = rng.integers(0, NC, E).astype(np.int32)
        deltas = rng.integers(-50, 60, (E, R)).astype(np.int32)
        do = rng.random(E) < 0.8
        jstate, jact = jax.vmap(lambda s, i, d, m: jmulti(s, jt, i, d, m))(jstate, i, deltas, do)
        pstate, pact = chest_update_multi(pstate, pt, torch.as_tensor(i), torch.as_tensor(deltas),
                                          torch.as_tensor(do))
        np.testing.assert_array_equal(np.asarray(jact), pact.numpy())
    kinds = np.tile(np.array([0, 1, 0, 1], np.int32), (E, 1))
    idxs = np.stack([np.concatenate([rng.choice(A, 2, replace=False)[[0]],
                                     rng.choice(NC, 2, replace=False)[[0]],
                                     rng.choice(A, 2, replace=False)[[1]],
                                     rng.choice(NC, 2, replace=False)[[1]]]) for _ in range(E)])
    idxs[:, 2] = np.where(idxs[:, 2] == idxs[:, 0], (idxs[:, 0] + 1) % A, idxs[:, 2])
    idxs[:, 3] = np.where(idxs[:, 3] == idxs[:, 1], (idxs[:, 1] + 1) % NC, idxs[:, 3])
    idxs = idxs.astype(np.int32)
    valid = rng.random((E, 4)) < 0.85
    deltas = rng.integers(-80, 80, (E, R)).astype(np.int32)
    do = rng.random(E) < 0.9
    jstate, jcons = jax.jit(jax.vmap(lambda s, k, i, v, d, m: jshared(s, jt, k, i, v, d, m)))(
        jstate, kinds, idxs, valid, deltas, do)
    pstate, pcons = shared_update_multi(pstate, pt, torch.as_tensor(idxs), torch.as_tensor(valid),
                                        torch.as_tensor(deltas), torch.as_tensor(do),
                                        kinds=torch.as_tensor(kinds))
    np.testing.assert_array_equal(np.asarray(jcons), pcons.numpy())
    assert_states_equal(jstate, pstate, "chest rows: ")
    assert (pstate.game_chest_deposited > 0).any() and (pstate.game_chest_withdrawn > 0).any()


@pytest.mark.parametrize("name", ["chests", "harvest"], ids=["vector", "per_resource"])
def test_chest_use_matches_jax(name):
    """The sequential ``chest_use`` (``actions.py:187``): agents bump chests
    with vibes drawn from every vibe (the chest's deposit and withdraw
    vibes among them), ten rounds."""
    from metta_tpu.engine.actions import chest_use as juse
    from metta_tpu_torch.engine.actions import chest_use

    compiled, _, jt, pt = world(name)
    rng = np.random.default_rng(8)
    jstate = seeded_state(name, rng)
    pstate = state_from_numpy(_fields(jstate))
    vibes = np.flatnonzero(compiled.chest_vibe_has.any(0))
    uses = 0
    step = jax.jit(jax.vmap(lambda s, a, i, m: juse(s, jt, a, i, m)))
    for _ in range(10):
        a = rng.integers(0, compiled.num_agents, E).astype(np.int32)
        i = rng.integers(0, compiled.n_chest_slots, E).astype(np.int32)
        mask = rng.random(E) < 0.9
        vibe = rng.choice(vibes, E).astype(np.int32)
        jstate = jstate.replace(agent_vibe=jstate.agent_vibe.at[jnp.arange(E), a].set(vibe))
        pstate = pstate.replace(agent_vibe=torch.as_tensor(np.asarray(jstate.agent_vibe)))
        jok, jstate = step(jstate, a, i, mask)
        pok, pstate = chest_use(pstate, pt, torch.as_tensor(a), torch.as_tensor(i),
                                torch.as_tensor(mask))
        np.testing.assert_array_equal(np.asarray(jok), pok.numpy())
        uses += int(pok.sum())
    assert_states_equal(jstate, pstate, "chest_use: ")
    assert uses > 0 and (pstate.agent_chest_deposited > 0).any()


# ---------------------------------------------------------------------------
# the batched step with chests, regen and the clipper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batched():
    """The JAX batched step of the chest config with the clipper, one jitted
    step per ``track_stats``."""
    from metta_tpu.engine.step_batched import step_env_batched as jstep

    steps = {}

    def get(track_stats):
        if track_stats not in steps:
            _, _, jt, pt = world("chests_clipper", track_stats, clip_period=4)
            steps[track_stats] = (jax.jit(jax.vmap(
                lambda s, a: jstep(s, a, jt, render="defer"))), pt)
        return steps[track_stats]
    return get


@pytest.mark.parametrize("track_stats", [True, False], ids=["stats", "no_stats"])
def test_batched_chests_match_jax(batched, track_stats):
    """The batched step with the chest phase (``_chest_phase``), regen and
    the clipper against the JAX ``step_env_batched``, 20 steps, the JAX
    step's order and clipper draws fed in: ``step_env_batched`` with
    ``track_stats=True`` (the chest stats), the fused step's plain span
    with ``track_stats=False`` (``supports_fused`` holds)."""
    from metta_tpu_torch.engine.step_batched import step_env_batched
    from metta_tpu_torch.ops.sim_fused import fused_step_full, supports_fused

    step, pt = batched(track_stats)
    assert supports_fused(pt) == (not track_stats) and pt.has_chests and pt.has_regen
    compiled = pt._cfg
    rng = np.random.default_rng(10)
    jstate = seeded_state("chests_clipper", rng, track_stats=track_stats, clip_period=4)
    jstate = jstate.replace(agent_vibe=jnp.asarray(rng.choice(
        np.flatnonzero(compiled.chest_vibe_has.any(0)), jstate.agent_vibe.shape), jnp.int32))
    pstate = state_from_numpy(_fields(jstate))
    pstep = step_env_batched if track_stats else fused_step_full
    A = compiled.num_agents
    moves = [i for i, k in enumerate(compiled.action_kind) if k == 1]
    transfers = clips = 0
    for i in range(20):
        acts = np.where(rng.random((E, A)) < 0.8, rng.choice(moves, (E, A)),
                        rng.integers(0, compiled.n_actions, (E, A))).astype(np.int32)
        perm, draws = step_perms(jstate.key, A), clip_draws(jstate.key, pt)
        before = pstate
        jstate, jrew = step(jstate, jnp.asarray(acts))
        pstate, prew = pstep(pstate, torch.as_tensor(acts), pt, perm=torch.as_tensor(perm),
                             clip_draws=draws)
        assert_states_equal(jstate, pstate, f"step {i}: ")
        np.testing.assert_array_equal(np.asarray(jrew), prew.numpy())
        transfers += int((pstate.chest_inv != before.chest_inv).any(-1).sum())
        clips += int((pstate.asm_clipped & ~before.asm_clipped).sum())
    assert transfers > 0 and clips > 0


def test_pallas_k2_with_chests_matches_xla():
    """The one interpret-mode case: the JAX package's Pallas K2
    (``ops/sim_fused.py:fused_step_full``) with its chest phase, at E=2 over
    two steps, against the XLA ``step_env_batched`` it mirrors, and the
    port's plain span against both. Agents stand beside chests showing
    deposit and withdraw vibes and move into them."""
    from metta_tpu.engine.step_batched import step_env_batched as jstep
    from metta_tpu.ops.sim_fused import fused_step_full as jfused
    from metta_tpu_torch.ops.sim_fused import fused_step_full

    n = 2
    compiled, init, jt, pt = world("tiny_chests", track_stats=False)
    jstate = jax.tree.map(lambda x: x[:n], seeded_state("tiny_chests", np.random.default_rng(11),
                                                        track_stats=False))
    jstate, acts = beside_chests(jstate, compiled, np.random.default_rng(12))
    pstate = state_from_numpy(_fields(jstate))
    xla = jax.jit(jax.vmap(lambda s, a: jstep(s, a, jt, render="defer")))
    pallas = jax.jit(lambda s, a: jfused(s, a, jt, interpret=True))
    used = 0
    for i in range(2):
        perm = step_perms(jstate.key, compiled.num_agents)
        ref_state, ref_rew = xla(jstate, acts)
        k_state, k_rew = pallas(jstate, acts)
        assert_states_equal(ref_state, state_from_numpy(_fields(k_state)), f"pallas step {i}: ")
        np.testing.assert_array_equal(np.asarray(ref_rew), np.asarray(k_rew))
        before = pstate
        pstate, prew = fused_step_full(pstate, torch.as_tensor(np.asarray(acts)), pt,
                                       perm=torch.as_tensor(perm))
        assert_states_equal(ref_state, pstate, f"port step {i}: ")
        np.testing.assert_array_equal(np.asarray(ref_rew), prew.numpy())
        used += int((pstate.chest_inv != before.chest_inv).any(-1).sum())
        jstate = ref_state
    assert used > 0


STEPS4 = (("move_north", -1, 0), ("move_south", 1, 0), ("move_west", 0, -1),
          ("move_east", 0, 1))


def beside_chests(jstate, compiled, rng):
    """The state with each chest's first free neighbour cell taken by an
    agent (as many as there are agents) showing a chest vibe, and the
    actions that move those agents into their chests (noops for the rest)."""
    kind = np.asarray(jstate.static_kind)
    r, c = np.array(jstate.agent_r), np.array(jstate.agent_c)
    vibe = np.array(jstate.agent_vibe)
    n, A = r.shape
    names = compiled.action_names
    acts = np.full((n, A), names.index("noop"), np.int32)
    vibes = np.flatnonzero(compiled.chest_vibe_has.any(0))
    for e in range(n):
        a = 0
        taken = {(int(x), int(y)) for x, y in zip(r[e], c[e])}
        for cr, cc in np.argwhere(kind[e] == KIND_CHEST):
            for name, dr, dc in STEPS4:
                rr, c2 = cr - dr, cc - dc
                if a < A and kind[e, rr, c2] == KIND_EMPTY and (rr, c2) not in taken:
                    taken.discard((int(r[e, a]), int(c[e, a])))
                    r[e, a], c[e, a] = rr, c2
                    taken.add((int(rr), int(c2)))
                    acts[e, a] = names.index(name)
                    vibe[e, a] = rng.choice(vibes)
                    a += 1
                    break
    H, W = kind.shape[1:]
    grid = np.zeros((n, H, W), np.int32)
    for e in range(n):
        grid[e, r[e], c[e]] = np.arange(1, A + 1)
    state = jstate.replace(agent_r=jnp.asarray(r), agent_c=jnp.asarray(c),
                           agent_prev_r=jnp.asarray(r), agent_prev_c=jnp.asarray(c),
                           agent_vibe=jnp.asarray(vibe), agent_grid=jnp.asarray(grid))
    return state, jnp.asarray(acts)
