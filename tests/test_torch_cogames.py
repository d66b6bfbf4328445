"""Cogs vs Clips: the port's missions against ``metta_tpu``'s.

The port keeps its own copy of ``metta_tpu/cogames`` (stations, mission,
variants, sites, evals, catalog, missions) and of the mapgen scenes the
missions build (``mapgen/scenes_structures.py``). Held here:

- the catalog: the same mission names in the same order; for every mission
  whose site the port builds, the same config, a byte-equal map and equal
  compiled tables and init arrays; the simple missions of
  ``make_mission`` likewise;
- the hello-world and machina sites (their maps unseeded here; seeded, they
  are held map for map in ``tests/test_torch_machina.py``) build maps of
  their sizes, and the assembler chest search of
  ``AssemblerDrawsFromChestsVariant`` takes the sequential step, the batched
  step refusing it by name;
- the port's ``MettaGridEnv`` on two missions against the JAX env, 24 steps
  of the sequential step (the one the missions' coupled limit groups take)
  with auto-reset (``max_steps=12``, desync on), every step's agent order,
  clipper draws and reset unclip protocols derived from the JAX state's keys
  as the JAX env draws them: ``training_facility.harvest`` (chests, regen,
  transfers; a chest transfer must happen) and ``training_facility.repair``
  (its hub stations start clipped, the clipper runs; an unclip must
  happen). Observations, rewards, done and truncated byte-identical every
  step, the whole state at the end.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.cogames import catalog as jcatalog
from metta_tpu.cogames import missions as jmissions
from metta_tpu.engine.compiler import compile_game as jcompile
from metta_tpu_torch.cogames import catalog as pcatalog
from metta_tpu_torch.cogames import missions as pmissions
from metta_tpu_torch.convert import state_to_numpy
from metta_tpu_torch.engine.clipper import ClipDraws
from metta_tpu_torch.engine.compiler import compile_game as pcompile
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARENA_SITES = ("hello_world", "machina_1")
PORTED = [m.full_name() for m in jcatalog.get_missions() if m.site.name not in ARENA_SITES]


def test_catalog_names_match_jax():
    """``get_missions`` lists the JAX catalog's missions, names and order."""
    assert ([m.full_name() for m in pcatalog.get_missions()]
            == [m.full_name() for m in jcatalog.get_missions()])
    assert len(PORTED) >= 25
    assert pcatalog.get_mission("harvest").full_name() == "training_facility.harvest"


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _assert_builds_alike(jcfg, pcfg):
    # the serialized map builder names its module (metta_tpu vs the port)
    assert (jcfg.model_dump(exclude={"game": {"map_builder"}})
            == pcfg.model_dump(exclude={"game": {"map_builder"}}))
    jmap, pmap = (cfg.game.map_builder.create().build() for cfg in (jcfg, pcfg))
    np.testing.assert_array_equal(jmap.grid, pmap.grid)
    (jc, jinit), (pc, pinit) = jcompile(jcfg.game, jmap), pcompile(pcfg.game, pmap)
    for f in dataclasses.fields(jc):
        _assert_same(getattr(jc, f.name), getattr(pc, f.name), f.name)
    assert sorted(jinit) == sorted(pinit)
    for k in jinit:
        _assert_same(jinit[k], pinit[k], f"init[{k}]")


@pytest.mark.parametrize("name", PORTED)
def test_mission_builds_like_jax(name):
    """The mission's config, map and compiled tables equal the JAX ones."""
    _assert_builds_alike(jcatalog.get_mission(name).make_env(),
                         pcatalog.get_mission(name).make_env())


@pytest.mark.parametrize("name", ["basic", "clipped"])
def test_make_mission_builds_like_jax(name):
    jcfg, pcfg = jmissions.MISSIONS[name](), pmissions.MISSIONS[name]()
    for cfg in (jcfg, pcfg):
        cfg.game.map_builder.seed = 1234
    _assert_builds_alike(jcfg, pcfg)


@pytest.mark.parametrize("site", ARENA_SITES)
def test_unported_sites_raise_by_name(site):
    """The hello-world and machina sites, whose maps the port once refused
    by the names of the scene files, keep their missions and now build
    their procedural arena maps (``MachinaArena``) at the site's size."""
    names = [m for m in pcatalog.get_missions() if m.site.name == site]
    assert names
    cfg = names[0].make_env()
    grid = cfg.game.map_builder.create().build().grid
    size = {"hello_world": 100, "machina_1": 88}[site] + 2       # the border
    assert grid.shape == (size, size) and (grid == "assembler").any()


def test_chest_search_refused_by_name():
    """``AssemblerDrawsFromChestsVariant`` sets the assembler chest search:
    the env takes the sequential step for it (as the JAX env does), and the
    batched step refuses it by name."""
    from metta_tpu_torch.cogames.variants import AssemblerDrawsFromChestsVariant
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.engine.step_batched import check_supported

    mission = pcatalog.get_mission("training_facility.harvest")
    cfg = mission.with_variants([AssemblerDrawsFromChestsVariant()]).make_env()
    env = MettaGridEnv(cfg, num_envs=1, step_mode="batched", device="cpu")
    assert env.step_mode == "sequential" and env.tables.chest_search_distance == 2
    with pytest.raises(NotImplementedError, match="assembler chest search"):
        check_supported(env.tables, "batched")


# ---------------------------------------------------------------------------
# the sequential env on the missions
# ---------------------------------------------------------------------------

E, STEPS = 8, 24

# mission: ({resource: amount} every agent starts with, the stations the
# agents start just below, the event that must happen)
MISSION_RUNS = {
    "training_facility.harvest": ({"carbon": 5, "oxygen": 5, "germanium": 5, "silicon": 5,
                                   "heart": 1}, ("chest",),
                                  "chest transfer"),
    "training_facility.repair": ({"decoder": 1, "modulator": 1, "resonator": 1,
                                  "scrambler": 1}, ("carbon_extractor", "oxygen_extractor"),
                                 "unclip"),
}


def _cfg(catalog, name):
    cfg = catalog.get_mission(name).make_env()
    cfg.game.max_steps = 12
    cfg.game.map_builder.seed = 2
    return cfg


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _key_draws(keys, A, NA, clip_period, n_unclip):
    """What the JAX sequential step and auto-reset draw from each env's
    pre-step key: the agent order, the clipper's trial, Gumbel vector and
    protocol (``step.py:160``, ``clipper.py:18``) and the unclip protocols
    of a reset from the post-step key (``step.py:124-133``)."""
    nup = max(n_unclip, 1)

    def one(k):
        key, k_perm, _, k_clip = jax.random.split(k, 4)
        k_trial, k_pick, k_proto = jax.random.split(k_clip, 3)
        return (jax.random.permutation(k_perm, A),
                jax.random.randint(k_trial, (), 1, max(clip_period, 1) + 1) == 1,
                jax.random.gumbel(k_pick, (NA,)),
                jax.random.randint(k_proto, (), 0, nup),
                jax.random.randint(jax.random.split(key)[1], (NA,), 0, nup))
    return jax.vmap(one)(keys)


def _reset_protos(key, NA, n_unclip):
    keys = jax.random.split(key, E)
    return np.asarray(jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k)[1], (NA,), 0, max(n_unclip, 1)))(keys))


@pytest.mark.parametrize("name", sorted(MISSION_RUNS))
def test_mission_env_matches_jax(name):
    from metta_tpu.engine.env import MettaGridEnv as JaxEnv
    from metta_tpu_torch.engine.env import MettaGridEnv

    seed, stations, event = MISSION_RUNS[name]
    jenv = JaxEnv(_cfg(jcatalog, name), num_envs=E, seed=3, desync_episodes=True)
    jenv.tables.obs_renderer = "ref"          # byte-identical to its default, faster here
    # the JAX template's start-clipped protocols, drawn from a zero key
    # (step.py:make_reset_template)
    nup = max(jenv.tables.n_unclip_protocols, 1)
    k_clip = jax.random.split(jnp.zeros((2,), jnp.uint32))[1]
    penv = MettaGridEnv(_cfg(pcatalog, name), num_envs=E, seed=3, desync_episodes=True,
                        device="cpu", template_unclip_proto=np.asarray(jax.random.randint(
                            k_clip, (jenv.tables.n_assembler_slots,), 0, nup)))
    assert jenv.step_mode == penv.step_mode == "sequential"
    t = penv.tables
    A, NA, R = t.num_agents, t.n_assembler_slots, t.num_resources
    key = jax.random.PRNGKey(3)
    vstate, jobs = jenv.reset_fn(key)
    pobs = penv.reset(desync_step=np.asarray(vstate.desync_step),
                      unclip_proto=_reset_protos(key, NA, t.n_unclip_protocols))
    np.testing.assert_array_equal(np.asarray(jobs), pobs.numpy())

    # every agent starts with the mission's probe inventory, just below one
    # of its stations, in both envs
    names = penv.compiled.resource_names
    inv = np.array(vstate.env.agent_inv)
    for res, amount in seed.items():
        inv[..., names.index(res)] = amount
    grid = penv.game_map.grid
    cells = [tuple(np.argwhere(grid == s)[0] + (1, 0)) for s in stations]
    r = np.array([[cells[a % len(cells)][0] for a in range(A)]] * E, np.int32)
    c = np.array([[cells[a % len(cells)][1] for a in range(A)]] * E, np.int32)
    occ = np.zeros(np.asarray(vstate.env.agent_grid).shape, np.int32)
    occ[:, r[0], c[0]] = np.arange(1, A + 1)
    placed = dict(agent_inv=inv, agent_r=r, agent_c=c, agent_prev_r=r, agent_prev_c=c,
                  agent_grid=occ)
    vstate = vstate.replace(env=vstate.env.replace(
        **{k: jnp.asarray(v) for k, v in placed.items()}))
    penv._state = penv.state.replace(env=penv.state.env.replace(
        **{k: torch.as_tensor(v) for k, v in placed.items()}))

    # moves, and vibe changes to the vibes the chests act on
    rng = np.random.default_rng(4)
    compiled = penv.compiled
    moves = [i for i, k in enumerate(compiled.action_kind) if k == 1]
    vibes = [compiled.action_names.index(f"change_vibe_{compiled.vibe_names[v]}")
             for v in np.flatnonzero(compiled.chest_vibe_has.any(0))]
    events = resets = 0
    for i in range(STEPS):
        acts = np.where(rng.random((E, A)) < 0.9, rng.choice(moves, (E, A)),
                        rng.choice(vibes, (E, A))).astype(np.int32)
        perm, trial, gumbel, proto, protos = (torch.as_tensor(np.array(x)) for x in _key_draws(
            vstate.env.key, A, NA, t.clip_period, t.n_unclip_protocols))
        before = penv.state.env
        vstate, *jout = jenv._step_fn(vstate, jnp.asarray(acts))
        pout = penv.step(acts, perm=perm, clip_draws=ClipDraws(trial, gumbel, proto),
                         unclip_proto=protos)
        for what, j, p in zip(("obs", "reward", "done", "truncated"), jout, pout):
            np.testing.assert_array_equal(np.asarray(j), p.numpy(), err_msg=f"step {i}: {what}")
        ended = pout[2] | pout[3]
        after = penv.state.env
        if event == "chest transfer":
            events += int(((after.chest_inv != before.chest_inv).any(-1).any(-1) & ~ended).sum())
        else:
            events += int(((before.asm_clipped & ~after.asm_clipped).any(-1) & ~ended).sum())
        resets += int(ended.sum())
    want = {f.name: np.asarray(getattr(vstate.env, f.name))
            for f in dataclasses.fields(vstate.env)}
    for field, x in state_to_numpy(penv.state)["env"].items():
        np.testing.assert_array_equal(want[field].reshape(x.shape), x, err_msg=field)
    assert events > 0, f"no {event} in {STEPS} steps"
    assert resets >= E
