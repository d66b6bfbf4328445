"""The hello-world and machina sites in the port against ``metta_tpu``.

- Maps: every catalog mission on ``hello_world`` and ``machina_1``
  (``MachinaArena`` over the terrain scenes), the procedural variants
  (``MapSeedVariant``, ``BaseHubVariant``, ``MachinaArenaVariant``) and the
  difficulty levels on ``machina_1.open_world``, five map seeds each: the
  same config and a byte-equal map from the port's copies of
  ``mapgen/scenes*.py``, ``cogames/procedural.py`` and ``difficulty.py``;
  the core scenes of ``mapgen/scenes.py`` one by one.
- The assembler chest search in the sequential step: ``assembler_use`` on
  ``machina_1.open_world_with_chests`` (chests within 2 cells feed the
  assembler) against the JAX function ``vmap``ped over envs, from seeded
  states with agents around the hub's assembler and stocked chests,
  byte-identical, with uses that drew from a chest required.
- ``ScriptedBaselineAgent`` on ``machina_1.open_world`` with 4 cogs, 100
  steps of each package's env with its own agent, the JAX env's draws fed
  to the port's: the same actions and observations every step.
- What stays refused, by name: the chest search in a task set (the task
  set's sequential step).
"""

import dataclasses
import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.cogames import catalog as jcatalog
from metta_tpu_torch.cogames import catalog as pcatalog
from metta_tpu_torch.convert import state_from_numpy, state_to_numpy, tables_from_compiled
from metta_tpu_torch.engine.clipper import ClipDraws
from metta_tpu_torch.engine.state import KIND_CHEST
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SITES = ("hello_world", "machina_1")
MISSIONS = [m.full_name() for m in jcatalog.get_missions() if m.site.name in SITES]
SEEDS = range(5)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _grid(cfg, seed):
    cfg.game.map_builder.seed = seed
    return cfg.game.map_builder.create().build().grid


def _dump(cfg) -> str:
    return json.dumps(cfg.model_dump(), sort_keys=True, default=str)


def _assert_same_maps(make):
    """``make(pkg)`` -> a config; the same config dump and a byte-equal map
    over :data:`SEEDS` in both packages."""
    jcfg, pcfg = make("metta_tpu"), make("metta_tpu_torch")
    assert _dump(jcfg) == _dump(pcfg).replace("metta_tpu_torch.", "metta_tpu.")
    for seed in SEEDS:
        jg, pg = _grid(jcfg.model_copy(deep=True), seed), _grid(pcfg.model_copy(deep=True), seed)
        assert jg.dtype == pg.dtype
        np.testing.assert_array_equal(jg, pg, err_msg=f"seed {seed}")


def test_every_site_mission_is_listed():
    assert len(MISSIONS) == 8
    assert [m.full_name() for m in pcatalog.get_missions()] == [
        m.full_name() for m in jcatalog.get_missions()]


@pytest.mark.parametrize("name", MISSIONS)
def test_site_maps_match_jax(name):
    _assert_same_maps(lambda pkg: _mod(pkg, "cogames.catalog").get_mission(name).make_env())


def _with(pkg, variant):
    mission = _mod(pkg, "cogames.catalog").get_mission("machina_1.open_world")
    return mission.with_variants([variant(pkg)]).make_env()


PROCEDURAL = {
    "map_seed": lambda pkg: _mod(pkg, "cogames.procedural").MapSeedVariant(seed=17),
    "base_hub": lambda pkg: _mod(pkg, "cogames.procedural").BaseHubVariant(
        updates={"spawn_count": 6, "cross_distance": 5}),
    "machina_arena": lambda pkg: _mod(pkg, "cogames.procedural").MachinaArenaVariant(
        updates={"building_coverage": 0.05}),
}


@pytest.mark.parametrize("name", sorted(PROCEDURAL))
def test_procedural_variant_maps_match_jax(name):
    _assert_same_maps(lambda pkg: _with(pkg, PROCEDURAL[name]))


@pytest.mark.parametrize("name", [d.name for d in importlib.import_module(
    "metta_tpu.cogames.difficulty").DIFFICULTY_VARIANTS])
def test_difficulty_levels_match_jax(name):
    _assert_same_maps(lambda pkg: _with(
        pkg, lambda p: _mod(p, "cogames.difficulty").get_difficulty(name)))


SCENES = {
    "maze": lambda m: m.Maze.Config(),
    "room_grid": lambda m: m.RoomGrid.Config(rows=2, columns=3),
    "bsp": lambda m: m.BSP.Config(depth=3),
    "make_connected": lambda m: m.MakeConnected.Config(),
    "inline_ascii": lambda m: m.InlineAscii.Config(data="#.#\n_c@\n..#"),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_core_scenes_match_jax(name):
    """Each scene of ``mapgen/scenes.py`` alone on a 23x19 map (on a random
    wall scatter for ``MakeConnected``)."""
    def make(pkg):
        scenes = _mod(pkg, "mapgen.scenes")
        mapgen = _mod(pkg, "mapgen.mapgen").MapGen
        cfg = _mod(pkg, "cogames.missions").make_mission("basic", width=23, height=19)
        inst = SCENES[name](scenes)
        if name == "make_connected":
            inst = scenes.Random.Config(objects={"wall": 120}, children=[{"scene": inst}])
        cfg.game.map_builder = mapgen.Config(width=23, height=19, instance=inst)
        return cfg
    _assert_same_maps(make)


# ---------------------------------------------------------------------------
# the assembler chest search (sequential step)
# ---------------------------------------------------------------------------

E = 6


@functools.lru_cache(maxsize=None)
def chests_world():
    """(compiled, init, JAX tables, port tables) of ``open_world_with_chests``
    with 4 cogs."""
    from metta_tpu.engine.compiler import compile_game
    from metta_tpu.engine.tables import Tables

    mission = jcatalog.get_mission("machina_1.open_world_with_chests")
    cfg = mission.with_variants([_mod("metta_tpu", "cogames.mission").NumCogsVariant(
        num_cogs=4)]).make_env()
    cfg.game.map_builder.seed = 3
    compiled, init = compile_game(cfg.game, cfg.game.map_builder.create().build())
    return compiled, init, Tables(compiled), tables_from_compiled(compiled, init)


def _fields(s):
    return {f.name: np.array(getattr(s, f.name)) for f in dataclasses.fields(s)}


def test_chest_search_assembler_use_matches_jax():
    """Ten rounds of ``assembler_use`` by an agent of each env at the hub's
    assembler, its neighbours and the chests within reach stocked from a
    seeded draw, vibes drawn from those its protocols key on."""
    from metta_tpu.engine.assembler import assembler_use as juse
    from metta_tpu.engine.step import make_reset_batch, make_reset_template
    from metta_tpu_torch.engine.assembler import assembler_use

    compiled, init, jt, pt = chests_world()
    assert pt.chest_search_distance == 2 and not pt.inv_vector_ok
    jstate, _ = make_reset_batch(jt, init, jax.random.split(jax.random.PRNGKey(5), E),
                                 template=make_reset_template(jt, init))
    s = _fields(jstate)
    asm = int(compiled.object_type_names.index("assembler"))
    i = int(np.flatnonzero((s["asm_type"][0] == asm) & s["asm_valid"][0])[0])
    r0, c0 = int(s["asm_r"][0, i]), int(s["asm_c"][0, i])
    # the map's chest stands farther than 2 cells from it: it is put on an
    # empty cell 2 away too (the search reads the static grids; each cell a
    # distinct chest, as on a map)
    NC = compiled.n_chest_slots
    ring = [(r0 + dr, c0 + dc) for dr in range(-2, 3) for dc in range(-2, 3)
            if max(abs(dr), abs(dc)) == 2 and s["static_kind"][0, r0 + dr, c0 + dc] == 0]
    for j, (r, c) in enumerate(ring[:NC]):
        s["static_kind"][:, r, c] = KIND_CHEST
        s["static_idx"][:, r, c] = j
    assert s["chest_valid"].all()
    rng = np.random.default_rng(3)
    A = compiled.num_agents
    free = [(r0 + dr, c0 + dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
            if (dr or dc) and s["static_kind"][0, r0 + dr, c0 + dc] == 0]
    s["agent_grid"][:] = 0
    for e in range(E):
        spots = rng.permutation(len(free))[:A]
        for a, k in enumerate(spots):
            r, c = free[k]
            s["agent_r"][e, a] = s["agent_prev_r"][e, a] = r
            s["agent_c"][e, a] = s["agent_prev_c"][e, a] = c
            s["agent_grid"][e, r, c] = a + 1
    s["agent_inv"][:] = rng.integers(0, 8, s["agent_inv"].shape)
    s["chest_inv"][:] = rng.integers(0, 60, s["chest_inv"].shape)
    # each env's agents show one of the vibe sets the assembler's protocols
    # key on (the others the default vibe), or a set none keys on
    patterns = [[compiled.vibe_names.index(v) for v in p] for p in (
        ("heart_a",), ("heart_a", "heart_a"), ("gear", "carbon_a"), ("gear", "silicon_a"),
        ("carbon_a",))]
    jstate = jstate.replace(**{k: jnp.asarray(v) for k, v in s.items()})
    pstate = state_from_numpy(s)
    step = jax.jit(jax.vmap(lambda st, a, j, m: juse(st, jt, a, j, m)))
    uses = drew = 0
    for _ in range(10):
        vibe = np.zeros((E, A), np.int32)
        for e in range(E):
            pattern = patterns[rng.integers(len(patterns))]
            vibe[e, rng.permutation(A)[:len(pattern)]] = pattern
        jstate = jstate.replace(agent_vibe=jnp.asarray(vibe), step=jstate.step + 50)
        pstate = pstate.replace(agent_vibe=torch.as_tensor(vibe), step=pstate.step + 50)
        a = rng.integers(0, A, E).astype(np.int32)
        idx = np.full(E, i, np.int32)
        before = pstate.chest_inv
        jok, jstate = step(jstate, a, idx, np.ones(E, bool))
        pok, pstate = assembler_use(pstate, pt, torch.as_tensor(a), torch.as_tensor(idx),
                                    torch.ones(E, dtype=torch.bool))
        np.testing.assert_array_equal(np.asarray(jok), pok.numpy())
        uses += int(pok.sum())
        drew += int(((pstate.chest_inv < before).flatten(1).any(1) & pok).sum())
    want = _fields(jstate)
    for field, x in state_to_numpy(pstate).items():
        np.testing.assert_array_equal(want[field].reshape(x.shape), x, err_msg=field)
    assert uses > 0 and drew > 0, (uses, drew)


def test_task_set_refuses_chest_search_by_name():
    """A task set with the chest search would take the task set's sequential
    step, which is not ported: refused by name."""
    from metta_tpu_torch.engine.taskset import MultiTaskEnv

    cfg = pcatalog.get_mission("machina_1.open_world_with_chests").make_env()
    cfg.game.map_builder.seed = 1
    with pytest.raises(NotImplementedError, match="sequential step of a task set"):
        MultiTaskEnv([cfg, cfg.model_copy(deep=True)], num_envs=2, device="cpu")


# ---------------------------------------------------------------------------
# the scripted baseline on machina_1
# ---------------------------------------------------------------------------

PLAY_STEPS = 100


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _key_draws(keys, A, NA, clip_period, n_unclip):
    """The agent order and the clipper's draws the JAX sequential step splits
    from each env's pre-step key (``step.py:160``, ``clipper.py:18``)."""
    def one(k):
        _, k_perm, _, k_clip = jax.random.split(k, 4)
        k_trial, k_pick, k_proto = jax.random.split(k_clip, 3)
        return (jax.random.permutation(k_perm, A),
                jax.random.randint(k_trial, (), 1, max(clip_period, 1) + 1) == 1,
                jax.random.gumbel(k_pick, (NA,)),
                jax.random.randint(k_proto, (), 0, max(n_unclip, 1)))
    return jax.vmap(one)(keys)


def test_scripted_agent_matches_jax():
    from metta_tpu.cogames.scripted import ScriptedBaselineAgent as JaxAgent
    from metta_tpu.engine.env import MettaGridEnv as JaxEnv
    from metta_tpu_torch.cogames.scripted import ScriptedBaselineAgent
    from metta_tpu_torch.engine.env import MettaGridEnv

    def cfg(pkg):
        mission = _mod(pkg, "cogames.catalog").get_mission("machina_1.open_world")
        c = mission.with_variants([_mod(pkg, "cogames.mission").NumCogsVariant(
            num_cogs=4)]).make_env()
        c.game.map_builder.seed = 7
        c.desync_episodes = False
        return c

    jenv = JaxEnv(cfg("metta_tpu"), num_envs=1, track_stats=True)
    jenv.tables.obs_renderer = "ref"          # byte-identical to its default, faster here
    penv = MettaGridEnv(cfg("metta_tpu_torch"), num_envs=1, device="cpu")
    assert jenv.step_mode == penv.step_mode == "sequential"
    jobs, pobs = np.asarray(jenv.reset(seed=0)), penv.reset()
    np.testing.assert_array_equal(jobs, pobs.numpy())
    jagent, pagent = JaxAgent(jenv, seed=0), ScriptedBaselineAgent(penv, seed=0)
    t = penv.tables
    acted = set()
    for i in range(PLAY_STEPS):
        ja = np.asarray(jagent.step_batch(jobs[0]))
        pa = pagent.step_batch(pobs[0])
        np.testing.assert_array_equal(ja, pa.numpy(), err_msg=f"step {i}: actions")
        acted |= set(ja.tolist())
        perm, trial, gumbel, proto = (torch.as_tensor(np.array(x)) for x in _key_draws(
            jenv.state.env.key, t.num_agents, t.n_assembler_slots, t.clip_period,
            t.n_unclip_protocols))
        jobs, *jout = (np.asarray(x) for x in jenv.step_no_reset(ja[None]))
        pobs, *pout = penv.step_no_reset(pa[None], perm=perm,
                                         clip_draws=ClipDraws(trial, gumbel, proto))
        np.testing.assert_array_equal(jobs, pobs.numpy(), err_msg=f"step {i}: obs")
        for name, j, p in zip(("reward", "done", "truncated"), jout, pout):
            np.testing.assert_array_equal(j, p.numpy(), err_msg=f"step {i}: {name}")
    assert len(acted) > 3, acted
