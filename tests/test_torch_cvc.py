"""Cogs vs Clips in a task set: the port's ``MultiTaskEnv`` against ``metta_tpu``'s.

- Three CvC task sets, each built the same way in both packages, whose tasks
  differ in a leaf that their subsystem reads, E=5, 4 cogs, ``max_steps``
  9 and desync on, 48 steps with auto-reset, ``track_stats`` on and off
  (``RUNS``):
  ``regen`` (the recipe's mission, ``recipes/prod/cogs_v_clips.py``, on 24x24:
  the heart reward and the energy regen amount differ), ``chests`` (the basic
  mission with the catalog's chest station: the chest's vibe transfers
  differ) and ``clipped`` (the clipped mission with a clip every few steps:
  which extractors start clipped and which are clip-immune differ). Every
  step's agent orders, clipper draws, task draws and reset unclip protocols
  come from the JAX state's keys as the JAX env splits them; observations,
  rewards, done, truncated and the task ids are byte-identical every step,
  the whole state at the end, and each run must show its subsystem at work
  (a regen tick, a chest transfer, a clip and start-clipped resets).
- The stacking verdicts: configs that differ only in ``max_steps`` (and in
  each Python-int static the subsystems add) are refused with ValueError by
  both packages; the heart-reward bucket alone stacks in both.
- K4's plain version against ``render_obs_pallas2(..., interpret=True)``
  under ``jax.jit`` on the ``chests`` stack, byte for byte.
- ``set_task`` replaces a slot's start-clipped mask with its template.
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

from metta_tpu.engine.taskset import MultiTaskEnv as JaxMultiTaskEnv
from metta_tpu.engine.taskset import build_task_set as jax_build_task_set
from metta_tpu_torch.convert import state_to_numpy
from metta_tpu_torch.engine.clipper import ClipDraws
from metta_tpu_torch.engine.state import KIND_CHEST, KIND_EMPTY
from metta_tpu_torch.engine.taskset import MultiTaskEnv, build_task_set
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

E, A, STEPS, MAX_STEPS = 5, 4, 48, 9
SETS = ("regen", "chests", "clipped")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def recipe_cfg(pkg="metta_tpu_torch", mission="training_grounds"):
    """The recipe's ``mettagrid()`` in either package."""
    if pkg == "metta_tpu":
        return importlib.import_module("recipes.prod.cogs_v_clips").mettagrid(mission)
    return _mod(pkg, "recipes.prod.cogs_v_clips").mettagrid(mission)


def _chest_cfg(pkg, size=10, chests=6):
    missions, stations, variants = (_mod(pkg, f"cogames.{m}")
                                    for m in ("missions", "stations", "variants"))
    cfg = missions.make_mission("basic", width=size, height=size)
    cfg.game.objects["chest"] = stations.CvCChestConfig().station_cfg()
    variants.TrainingVariant().modify_env(None, cfg)
    cfg.game.map_builder.instance.objects["chest"] = chests
    return cfg


def set_cfgs(kind, pkg="metta_tpu_torch"):
    """Three task configs of set ``kind`` (map seeds 11, 12, 13)."""
    cfgs = []
    for k in range(3):
        if kind == "regen":
            c = recipe_cfg(pkg)
            c.game.agent.rewards.inventory["heart"] = (0.5, 1.0, 0.5)[k]
            c.game.agent.inventory.regen_amounts["default"]["energy"] = (1, 1, 3)[k]
            c.game.agent.inventory.initial["energy"] = 6
        elif kind == "chests":
            c = _chest_cfg(pkg)
            c.game.objects["chest"].vibe_transfers["carbon_b"] = {"carbon": (10, 2, 10)[k]}
            c.game.objects["chest"].vibe_transfers["oxygen_a"] = {"oxygen": (-10, -10, -1)[k]}
        else:
            c = _mod(pkg, "cogames.missions").make_mission("clipped", width=12, height=12,
                                                           with_clipper=True)
            c.game.clipper.clip_period = 3
            c.game.objects["carbon_extractor"].start_clipped = k != 1
            c.game.objects["oxygen_extractor"].start_clipped = k == 2
            c.game.objects["germanium_extractor"].clip_immune = k == 1
        c.game.max_steps = MAX_STEPS
        c.game.map_builder.seed = 11 + k
        cfgs.append(c)
    return cfgs


# the leaves each set's tasks must differ in
VARIED = {"regen": {"agent_regen", "stat_w"},
          "chests": {"chest_vibe_delta"},
          "clipped": {"type_start_clipped", "type_clip_immune", "clipper_infection_w"}}


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _key_draws(keys, weights, NA, clip_period, n_unclip):
    """What the JAX task set draws from each env's pre-step key: the agent
    order and the clipper's trial, Gumbel vector and protocol
    (``step_batched.py:149``, ``clipper.py:18``), the task of a reset and
    its unclip protocols from the post-step key (``taskset.py:170-183,
    256-258``)."""
    logw = jnp.log(jnp.maximum(weights, 1e-9))
    nup = max(n_unclip, 1)

    def one(k):
        key, k_perm, _, k_clip = jax.random.split(k, 4)
        k_trial, k_pick, k_proto = jax.random.split(k_clip, 3)
        return (jax.random.permutation(k_perm, A),
                jax.random.randint(k_trial, (), 1, max(clip_period, 1) + 1) == 1,
                jax.random.gumbel(k_pick, (NA,)),
                jax.random.randint(k_proto, (), 0, nup),
                jax.random.categorical(jax.random.fold_in(key, 7), logw),
                jax.random.randint(jax.random.split(key)[1], (NA,), 0, nup))
    return jax.vmap(one)(keys)


def jax_draws(jenv, vstate):
    """(perm, ClipDraws, task draws, reset unclip protocols) of the next step."""
    t = jenv.tables
    perm, trial, gumbel, proto, tid, protos = (torch.as_tensor(np.array(x)) for x in _key_draws(
        vstate.env.key, jenv.tsdata.weights, t.n_assembler_slots, t.clip_period,
        t.n_unclip_protocols))
    return perm, ClipDraws(trial, gumbel, proto), tid, protos


def jax_reset(jenv, key):
    """(JAX state, obs) of ``reset_core`` and the port's reset arguments."""
    vstate, obs = jenv._reset_fn(key, jenv.tsdata)
    t = jenv.tables
    nup = max(t.n_unclip_protocols, 1)
    protos = np.asarray(jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k)[1], (t.n_assembler_slots,), 0, nup))(jax.random.split(key, E)))
    return vstate, obs, dict(task_id=np.asarray(vstate.task_id),
                             desync_step=np.asarray(vstate.desync_step), unclip_proto=protos)


def template_protos(jtables, K):
    """The JAX templates' start-clipped protocols: each drawn from a zero key
    (``step.py:make_reset_template``)."""
    k_clip = jax.random.split(jnp.zeros((2,), jnp.uint32))[1]
    one = np.asarray(jax.random.randint(k_clip, (jtables.n_assembler_slots,), 0,
                                        max(jtables.n_unclip_protocols, 1)))
    return np.stack([one] * K)


@functools.lru_cache(maxsize=None)
def env_pair(kind, track_stats):
    jenv = JaxMultiTaskEnv(set_cfgs(kind, "metta_tpu"), num_envs=E, seed=3,
                           desync_episodes=True, track_stats=track_stats)
    jenv.tsdata.tables.obs_renderer = "ref"     # byte-identical to its default, faster here
    penv = MultiTaskEnv(set_cfgs(kind), num_envs=E, seed=3, desync_episodes=True,
                        track_stats=track_stats, device="cpu",
                        template_unclip_proto=template_protos(jenv.tables, 3))
    return jenv, penv


def _prepare(penv, vstate, rng):
    """Both envs' first episodes with every agent holding 0-12 of each
    resource (the chests and the unclip protocols need items) and, where an
    env's map has chests, standing just below one (the cell empty)."""
    env = {f.name: np.asarray(getattr(vstate.env, f.name)).copy()
           for f in dataclasses.fields(vstate.env)}
    inv = env["agent_inv"]
    inv[..., 1:] = rng.integers(0, 13, inv[..., 1:].shape)
    kind = env["static_kind"]
    for e in range(E):
        cells = [(r + 1, c) for r, c in np.argwhere(kind[e] == KIND_CHEST)
                 if r + 1 < kind.shape[1] and kind[e, r + 1, c] == KIND_EMPTY
                 and env["agent_grid"][e, r + 1, c] == 0]
        for a, (r, c) in zip(range(A), cells):
            env["agent_grid"][e, env["agent_r"][e, a], env["agent_c"][e, a]] = 0
            env["agent_grid"][e, r, c] = a + 1
            for f in ("agent_r", "agent_prev_r"):
                env[f][e, a] = r
            for f in ("agent_c", "agent_prev_c"):
                env[f][e, a] = c
    placed = {k: env[k] for k in ("agent_inv", "agent_grid", "agent_r", "agent_c",
                                  "agent_prev_r", "agent_prev_c")}
    vstate = vstate.replace(env=vstate.env.replace(
        **{k: jnp.asarray(v) for k, v in placed.items()}))
    penv._state = penv.state.replace(env=penv.state.env.replace(
        **{k: torch.as_tensor(v) for k, v in placed.items()}))
    return vstate


def _actions(compiled, rng):
    """[E, A] actions: mostly moves, else a change to a vibe the chests act on."""
    moves = [i for i, k in enumerate(compiled.action_kind) if k == 1]
    vibes = [compiled.action_names.index(f"change_vibe_{compiled.vibe_names[v]}")
             for v in np.flatnonzero(compiled.chest_vibe_has.any(0))] or moves
    return np.where(rng.random((E, A)) < 0.8, rng.choice(moves, (E, A)),
                    rng.choice(vibes, (E, A))).astype(np.int32)


# each set with track_stats on and off would compile six JAX programs: the
# chest set runs with its chest stats, the regen set (the trainer test's)
# and the clipped set without stats; chip_smoke.py and the card tests add
# the regen set with stats
RUNS = [("regen", False), ("chests", True), ("clipped", False)]


@pytest.mark.parametrize("kind,track_stats", RUNS,
                         ids=[f"{k}-{'stats' if t else 'no_stats'}" for k, t in RUNS])
def test_cvc_task_set_byte_identical(kind, track_stats):
    jenv, penv = env_pair(kind, track_stats)
    t = penv.tables
    assert penv.step_mode == jenv.step_mode == "batched"
    assert t.has_regen and (t.has_chests or kind != "chests") and (
        t.clipper_enabled or kind != "clipped")
    assert VARIED[kind] <= penv.tsdata.tables.varying
    vstate, jobs, reset_args = jax_reset(jenv, jax.random.PRNGKey(3))
    np.testing.assert_array_equal(np.asarray(jobs), penv.reset(**reset_args))
    rng = np.random.default_rng(0)
    vstate = _prepare(penv, vstate, rng)
    events = {"regen": 0, "chest": 0, "clip": 0, "start_clipped": 0}
    energy = penv.compiled.resource_names.index("energy")
    for i in range(STEPS):
        acts = _actions(penv.compiled, rng)
        perm, clip, tid, protos = jax_draws(jenv, vstate)
        before = penv.state.env
        vstate, *jout = jenv._step_fn(vstate, jnp.asarray(acts), jenv.tsdata)
        pout = penv.step(acts, perm=perm, task_draws=tid, clip_draws=clip, unclip_proto=protos)
        for name, j, p in zip(("obs", "reward", "done", "truncated"), jout, pout):
            np.testing.assert_array_equal(np.asarray(j), p, err_msg=f"step {i}: {name}")
        for name in ("task_id", "last_episode_task", "episodes_done"):
            np.testing.assert_array_equal(np.asarray(getattr(vstate, name)),
                                          getattr(penv.state, name).numpy(),
                                          err_msg=f"step {i}: {name}")
        after, live = penv.state.env, ~torch.as_tensor(pout[2] | pout[3])
        moved = after.agent_inv[..., energy] > before.agent_inv[..., energy]
        events["regen"] += int((moved.any(-1) & live).sum())
        events["chest"] += int(((after.chest_inv != before.chest_inv).flatten(1).any(1)
                                & live).sum())
        events["clip"] += int(((after.asm_clipped & ~before.asm_clipped).any(-1) & live).sum())
        events["start_clipped"] += int(((after.asm_unclip_proto >= 0).any(-1) & ~live).sum())
    want = {f.name: np.asarray(getattr(vstate.env, f.name))
            for f in dataclasses.fields(vstate.env)}
    for name, x in state_to_numpy(penv.state.env).items():
        np.testing.assert_array_equal(want[name].reshape(x.shape), x, err_msg=name)
    for name in ("desync_step", "episode_len", "last_episode_reward", "last_episode_gained"):
        np.testing.assert_array_equal(np.asarray(getattr(vstate, name)),
                                      getattr(penv.state, name).numpy(), err_msg=name)
    need = {"regen": ("regen",), "chests": ("regen", "chest"),
            "clipped": ("regen", "clip", "start_clipped")}[kind]
    assert all(events[k] > 0 for k in need), events


def _verdict(build, cfgs):
    try:
        build(cfgs)
        return "stacks"
    except ValueError:
        return "ValueError"


def _varied(base, path, values):
    """Copies of ``base`` with the dotted ``path`` set to each value."""
    out = []
    for v in values:
        c = base.model_copy(deep=True)
        obj = c
        *head, last = path.split(".")
        for p in head:
            obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
        if isinstance(obj, dict):
            obj[last] = v
        else:
            setattr(obj, last, v)
        c.game.map_builder.seed = 5
        out.append(c)
    return out


# (config maker, dotted path, two values, the verdict both packages give)
STACKS = {
    "max_steps": (recipe_cfg, "game.max_steps", (256, 512), "ValueError"),
    "heart_reward": (recipe_cfg, "game.agent.rewards.inventory.heart", (0.5, 1.0), "stacks"),
    "same_config": (recipe_cfg, "game.max_steps", (512, 512), "stacks"),
    "regen_interval": (recipe_cfg, "game.inventory_regen_interval", (1, 2), "ValueError"),
    "clip_period": (lambda pkg: set_cfgs("clipped", pkg)[0], "game.clipper.clip_period", (3, 5),
                    "ValueError"),
    "n_unclip_protocols": (lambda pkg: set_cfgs("clipped", pkg)[0],
                           "game.clipper.unclipping_protocols", (1, 2), "ValueError"),
}


@pytest.mark.parametrize("case", sorted(STACKS))
def test_stacking_verdicts_match_jax(case):
    make, path, values, want = STACKS[case]
    got = []
    for pkg, build in (("metta_tpu", lambda c: jax_build_task_set(c, track_stats=False)),
                       ("metta_tpu_torch", lambda c: build_task_set(c, track_stats=False))):
        base = make(pkg)
        vals = values
        if case == "n_unclip_protocols":
            protos = base.game.clipper.unclipping_protocols
            vals = (protos[:1], protos)
        got.append(_verdict(build, _varied(base, path, vals)))
    assert got == [want, want]


def test_k4_plain_matches_pallas2_on_a_cvc_stack():
    """K4's plain version on the port's prep of the ``chests`` set's states
    (each env on its own task, seeded inventories and vibes) against the JAX
    v2 kernel in interpret mode with the stacked tables, under ``jax.jit``."""
    from metta_tpu.ops.obs_render2 import render_obs_pallas2
    from metta_tpu_torch.convert import state_from_numpy
    from metta_tpu_torch.engine.tables import tables_at
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops.obs_render3 import prep_env3

    jts, jlist = jax_build_task_set(set_cfgs("chests", "metta_tpu"), track_stats=False)
    pts, _ = build_task_set(set_cfgs("chests"), track_stats=False)
    tid = np.array([0, 2, 1, 2], np.int32)
    rng = np.random.default_rng(7)
    state = jax.tree.map(lambda x: x[tid], jts.template)
    inv = rng.integers(0, 30, state.agent_inv.shape).astype(np.int32)
    vibe = rng.integers(0, jlist[0].num_vibes, state.agent_vibe.shape).astype(np.int32)
    chest = rng.integers(0, 30, state.chest_inv.shape).astype(np.int32)
    act = rng.integers(0, jlist[0].n_actions, state.agent_vibe.shape).astype(np.int32)
    rew = rng.normal(size=state.agent_vibe.shape).astype(np.float32)
    state = state.replace(agent_inv=jnp.asarray(inv), agent_vibe=jnp.asarray(vibe),
                          chest_inv=jnp.asarray(chest), executed_action=jnp.asarray(act),
                          reward=jnp.asarray(rew))
    render = jax.jit(lambda s, st, t: render_obs_pallas2(
        s, jlist[0], s.executed_action, s.reward, eps=1, interpret=True,
        stacked_tables=st, task_id=t))
    want = np.asarray(render(state, jts.tables, jnp.asarray(tid)))
    pstate = state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                               for f in dataclasses.fields(state)})
    view = tables_at(pts.tables, torch.as_tensor(tid))
    assert {"chest_vibe_delta", "obs_static_bg"} <= pts.tables.varying
    args = prep_env3(pstate, view, pstate.executed_action, pstate.reward)
    got = k4.render_obs2(*args, k4.rank_table(view.obs_scan, view.obs_width),
                         view.num_obs_tokens, view.obs_height, view.obs_width)
    np.testing.assert_array_equal(want, got.numpy())
    assert (want[..., 0] != 255).sum() > 0


def test_set_task_replaces_start_clipped():
    """``set_task`` puts the new task's start-clipped mask, template and obs
    in its slot: the set equals one built with that task in place."""
    cfgs = set_cfgs("clipped")
    protos = np.zeros((3, 0), np.int64)
    env = MultiTaskEnv(cfgs, num_envs=E, seed=1, device="cpu")
    NA = env.tables.n_assembler_slots
    protos = np.tile(np.arange(NA) % 2, (3, 1))
    env = MultiTaskEnv(cfgs, num_envs=E, seed=1, device="cpu", template_unclip_proto=protos)
    assert not torch.equal(env.tsdata.start_clipped[1], env.tsdata.start_clipped[0])
    env.set_task(1, set_cfgs("clipped")[0], template_unclip_proto=protos[0])
    ref = MultiTaskEnv([cfgs[0], set_cfgs("clipped")[0], cfgs[2]], num_envs=E, seed=1,
                       device="cpu", template_unclip_proto=protos)
    assert torch.equal(env.tsdata.start_clipped, ref.tsdata.start_clipped)
    assert torch.equal(env.tsdata.obs1, ref.tsdata.obs1)
    args = dict(task_id=[1, 0, 2, 1, 1], desync_step=np.zeros(E),
                unclip_proto=np.ones((E, NA), np.int64))
    np.testing.assert_array_equal(env.reset(**args), ref.reset(**args))
    for a, b in zip(dataclasses.astuple(env.state.env), dataclasses.astuple(ref.state.env)):
        assert torch.equal(a, b)


def test_cvc_multitask_trainer_update():
    """One multi-task ``Trainer.update`` on the ``regen`` set at a tiny size:
    its env half, stepped with the rollout's own actions and the JAX env's
    draws, equal to the JAX env step by step; finite metrics and moved
    parameters; then one minibatch of the rollout's CvC observations through
    the port's loss and gradient against the JAX trainer's
    (``tests/test_torch_trainer.py``'s tolerances)."""
    from metta_tpu.models.vit import ViTConfig as JViTConfig
    from metta_tpu.rl.config import TrainerConfig as JTrainerConfig
    from metta_tpu.rl.trainer import Trainer as JTrainer
    from metta_tpu_torch.models.vit import ViTConfig
    from metta_tpu_torch.rl.config import TrainerConfig
    from metta_tpu_torch.rl.trainer import Trainer
    from test_torch_trainer import ARCH, _jax_loss_and_grads, _port_loss_and_grads, _rel
    from metta_tpu_torch.convert import flax_to_state_dict

    jenv, _ = env_pair("regen", False)
    tc = dict(num_envs=E, bptt_horizon=8, batch_size=E * A * 8, minibatch_size=40)
    tr = Trainer(None, TrainerConfig(**tc), ViTConfig(**ARCH), task_cfgs=set_cfgs("regen"),
                 device="cpu")
    assert isinstance(tr.env, MultiTaskEnv) and tr.env.tables.has_regen
    reset, step = tr.env.reset_state, tr.env.step_state
    box = {"steps": 0}

    def reset_state():
        box["vs"], jobs, args = jax_reset(jenv, jax.random.PRNGKey(9))
        out = reset(**args)
        np.testing.assert_array_equal(np.asarray(jobs), out[1].numpy())
        return out

    def step_state(vstate, actions):
        perm, clip, tid, protos = jax_draws(jenv, box["vs"])
        box["vs"], *jout = jenv._step_fn(box["vs"], jnp.asarray(actions.numpy()), jenv.tsdata)
        out = step(vstate, actions, perm=perm, task_draws=tid, clip_draws=clip,
                   unclip_proto=protos)
        for name, j, p in zip(("obs", "reward", "done", "truncated"), jout, out[1:]):
            np.testing.assert_array_equal(np.asarray(j), p.numpy(), err_msg=name)
        box["steps"] += 1
        return out

    tr.env.reset_state, tr.env.step_state = reset_state, step_state
    trajs = []
    rollout = tr._rollout

    def spy(state):
        state, traj = rollout(state)
        trajs.append(traj)
        return state, traj

    tr._rollout = spy
    ts = tr.init_state(seed=3)
    p0 = ts.params.clone()
    ts, metrics = tr.update(ts)
    assert box["steps"] == tc["bptt_horizon"]
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert float((ts.params - p0).abs().max()) > 0

    traj, M = trajs[0], 6
    rng = np.random.default_rng(0)
    mb = dict(obs=traj.obs[:, :M].numpy(), actions=traj.actions[:, :M].numpy().astype(np.int32),
              logprob=traj.logprob[:, :M].numpy(), value=traj.value[:, :M].numpy(),
              reward=rng.normal(0, 0.5, (tr.T, M)).astype(np.float32),
              done=traj.done[:, :M].numpy().astype(np.float32),
              advantages=rng.normal(size=(tr.T, M)).astype(np.float32),
              rows=np.arange(M, dtype=np.int32))
    jcfg = set_cfgs("regen", "metta_tpu")[0]
    jtr = JTrainer(jcfg, JTrainerConfig(**tc), JViTConfig(**ARCH))
    assert jtr.env.compiled.n_actions == tr.env.compiled.n_actions
    hp = tr.default_hp()
    (jloss, jmetrics), jgrads = _jax_loss_and_grads(tr, jtr, ts, mb, hp)
    loss, pmetrics, grads = _port_loss_and_grads(tr, ts, mb, hp)
    _rel(loss.item(), float(jloss), "loss")
    for k in pmetrics:
        _rel(pmetrics[k].item(), float(jmetrics[k]), k)
    want = flax_to_state_dict(jgrads)
    got = tr.layout.views(grads)
    gmax = max(float(v.abs().max()) for v in want.values())
    for k in got:
        _rel(got[k].numpy(), want[k].numpy(), f"grad {k}", floor=1e-3 * gmax)


@pytest.mark.parametrize("kind", SETS)
def test_card_sets_are_these_sets(kind):
    """``scripts/common.py:cvc_task_set`` (the sets ``chip_smoke.py`` and the
    card tests run) builds this file's port sets, config for config."""
    from metta_tpu_torch.scripts.common import cvc_task_set

    def dump(cfgs):
        return [json.dumps(c.model_dump(), sort_keys=True, default=str) for c in cfgs]
    assert dump(cvc_task_set(kind, max_steps=MAX_STEPS)) == dump(set_cfgs(kind))
