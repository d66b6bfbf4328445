"""The port's task set and ``MultiTaskEnv`` against ``metta_tpu``'s.

- Three arena-curriculum tasks (the shaped arena's buckets, each package's
  own ``make_curriculum``; reward weights, reward caps, attack's laser cost
  and map seed differ across them), E=5 (no multiple of 8), 6 agents,
  ``max_steps=9`` and desync on, so episodes end and tasks resample within
  the 24 steps. Each step's agent orders and task draws come from the JAX
  state's keys exactly as ``metta_tpu/engine/step_batched.py:149`` and
  ``engine/taskset.py:256-258`` derive them, and the JAX reset's task ids and
  desync steps go to the port's reset. Observations, rewards, done,
  truncated, ``task_id`` and ``last_episode_task`` must be byte-identical
  every step, and the whole state at the end; a ``set_weights`` and (with
  ``track_stats`` off, where the JAX ``set_task`` works) a ``set_task`` come
  mid-run. With ``track_stats`` on, the JAX ``set_task`` raises (it compiles
  the new slot with ``track_stats=False``); the port's equals a set built
  with the new task in place.
- A set whose tasks differ in many leaves the step reads (inventory limits,
  protocol cooldowns and max uses, attack and transfer tables, reward
  weights): each env of the set equals a single-task env of its task.
- One multi-task ``Trainer.update`` at a tiny size, its env half held to the
  JAX env given the rollout's actions and the JAX draws.
- One-task sets equal the plain env; one-hot weights pin every env; per-env
  static grids come from each env's own task; incompatible tasks raise
  (``tests/test_taskset.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.engine.taskset import MultiTaskEnv as JaxMultiTaskEnv
from metta_tpu_torch.builder.envs import make_arena, make_cooperation
from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped, make_curriculum
from metta_tpu_torch.convert import state_to_numpy
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.engine.taskset import MultiTaskEnv, build_task_set
from metta_tpu_torch.engine.tables import tables_at
from metta_tpu_torch.models.vit import ViTConfig
from metta_tpu_torch.rl.config import TrainerConfig
from metta_tpu_torch.rl.trainer import Trainer
from recipes.arena_basic_easy_shaped import make_curriculum as jax_make_curriculum
from recipes.arena_basic_easy_shaped import mettagrid as jax_shaped_arena
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

E, A, STEPS, MAX_STEPS = 5, 6, 24, 9
LASER = "game.actions.attack.consumed_resources.laser"


def _pick(tasks):
    """Three tasks of the pool: the first, the first with the other laser
    cost, and the first whose ore weight differs from both."""
    sv = [t.get_slice_values() for t in tasks]
    ore = "game.agent.rewards.inventory.ore_red"
    i = next(k for k in range(len(sv)) if sv[k][LASER] != sv[0][LASER])
    j = next(k for k in range(len(sv)) if sv[k][ore] not in (sv[0][ore], sv[i][ore]))
    return [0, i, j]


def curriculum_cfgs():
    """(JAX configs, port configs) of three arena-curriculum tasks, map seeds
    11, 12, 13."""
    jt = jax_make_curriculum(jax_shaped_arena(A)).active_tasks()
    pt = make_curriculum(make_arena_basic_easy_shaped(A)).active_tasks()
    assert [t.task_id for t in pt] == [t.task_id for t in jt]
    pick = _pick(pt)
    out = []
    for tasks in (jt, pt):
        cfgs = [tasks[k].get_env_cfg() for k in pick]
        for s, c in enumerate(cfgs):
            c.game.map_builder.seed = 11 + s
            c.game.max_steps = MAX_STEPS
        out.append(cfgs)
    return out


@pytest.fixture(scope="module")
def envs():
    """(JAX env, port env) per ``track_stats``, each pair built once."""
    built = {}

    def make(track_stats):
        if track_stats not in built:
            jcfgs, pcfgs = curriculum_cfgs()
            built[track_stats] = (
                JaxMultiTaskEnv(jcfgs, num_envs=E, seed=3, desync_episodes=True,
                                track_stats=track_stats),
                MultiTaskEnv(pcfgs, num_envs=E, seed=3, desync_episodes=True,
                             track_stats=track_stats, device="cpu"),
            )
        return built[track_stats]
    return make


@jax.jit
def _jax_draws(keys, weights):
    """Each env's agent order and task draw from its pre-step key."""
    logw = jnp.log(jnp.maximum(weights, 1e-9))

    def one(k):
        ks = jax.random.split(k, 4)
        tid = jax.random.categorical(jax.random.fold_in(ks[0], 7), logw)
        return jax.random.permutation(ks[1], A), tid
    return jax.vmap(one)(keys)


def jax_draws(jenv, vstate):
    perm, tid = _jax_draws(vstate.env.key, jenv.tsdata.weights)
    return torch.from_numpy(np.array(perm)), np.asarray(tid)


def _fields(s):
    return {f: np.asarray(getattr(s, f)) for f in s.__dataclass_fields__}


def test_curriculum_tasks_differ():
    """The three tasks differ in reward weights, reward caps, laser cost and
    map, and so in the leaves the step reads per env."""
    _, cfgs = curriculum_cfgs()
    games = [c.game for c in cfgs]
    assert len({g.actions.attack.consumed_resources["laser"] for g in games}) == 2
    assert len({tuple(g.agent.rewards.inventory.values()) for g in games}) == 3
    assert len({tuple(g.agent.rewards.inventory_max.values()) for g in games}) > 1
    assert len({g.map_builder.seed for g in games}) == 3
    ts, _ = build_task_set(cfgs)
    assert {"stat_w", "stat_max", "attack_consumed", "obs_static_bg"} <= ts.tables.varying
    view = tables_at(ts.tables, torch.tensor([2, 0, 1]))
    assert view.stat_w.shape[0] == 3 and view.per_env == ts.tables.varying
    assert torch.equal(view.stat_w[0], tables_at(ts.tables, 2).stat_w)
    assert view.action_kind is ts.tables.row0.action_kind        # shared leaves stay shared


def test_multitask_trainer_update(envs):
    """One small multi-task ``Trainer.update`` on the CPU: finite metrics and
    moved parameters, and its env half, stepped with the rollout's own
    actions and the JAX env's draws, equal to the JAX env step by step.
    (Runs before the byte-identical test, whose ``set_task`` changes the
    shared JAX set.)"""
    jenv, _ = envs(False)
    _, pcfgs = curriculum_cfgs()
    tc = TrainerConfig(num_envs=E, bptt_horizon=8, batch_size=E * A * 8, minibatch_size=48)
    arch = ViTConfig(latent_dim=16, actor_hidden=16, critic_hidden=16, max_tokens=16,
                     core_num_latents=2, core_num_heads=2, core="lstm", compute_dtype="float32")
    tr = Trainer(None, tc, arch, task_cfgs=pcfgs, device="cpu")
    assert isinstance(tr.env, MultiTaskEnv)
    for env in (jenv, tr.env):
        env.set_weights([1.0, 2.0, 1.0])
    reset, step = tr.env.reset_state, tr.env.step_state
    box = {"steps": 0}

    def reset_state():
        box["vs"], jobs = jenv._reset_fn(jax.random.PRNGKey(5), jenv.tsdata)
        out = reset(task_id=np.asarray(box["vs"].task_id),
                    desync_step=np.asarray(box["vs"].desync_step))
        np.testing.assert_array_equal(np.asarray(jobs), out[1].numpy())
        return out

    def step_state(vstate, actions):
        perm, draws = jax_draws(jenv, box["vs"])
        box["vs"], *jout = jenv._step_fn(box["vs"], jnp.asarray(actions.numpy()), jenv.tsdata)
        out = step(vstate, actions, perm=perm, task_draws=draws)
        for name, j, p in zip(("obs", "reward", "done", "truncated"), jout, out[1:]):
            np.testing.assert_array_equal(np.asarray(j), p.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(box["vs"].task_id), out[0].task_id.numpy())
        box["steps"] += 1
        return out

    tr.env.reset_state, tr.env.step_state = reset_state, step_state
    ts = tr.init_state()
    p0 = ts.params.clone()
    ts, metrics = tr.update(ts)
    assert box["steps"] == tc.bptt_horizon
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert float((ts.params - p0).abs().max()) > 0
    for env in (jenv, tr.env):
        env.set_weights([1.0, 1.0, 1.0])


@pytest.mark.parametrize("track_stats", [True, False], ids=["stats", "no_stats"])
def test_multitask_env_byte_identical(envs, track_stats):
    jenv, penv = envs(track_stats)
    vstate, jobs = jenv._reset_fn(jax.random.PRNGKey(3), jenv.tsdata)
    pobs = penv.reset(task_id=np.asarray(vstate.task_id),
                      desync_step=np.asarray(vstate.desync_step))
    np.testing.assert_array_equal(np.asarray(jobs), pobs)
    rng = np.random.default_rng(0)
    ends, tids = 0, set()
    for i in range(STEPS):
        if i == 8:
            for env in (jenv, penv):
                env.set_weights([0.2, 0.5, 0.3])
        if i == 14 and not track_stats:
            jcfgs, pcfgs = curriculum_cfgs()
            for env, cfg in ((jenv, jcfgs[0]), (penv, pcfgs[0])):
                cfg.game.map_builder.seed = 21
                env.set_task(1, cfg)
        acts = rng.integers(0, len(jenv.action_names), (E, A)).astype(np.int32)
        perm, draws = jax_draws(jenv, vstate)
        vstate, *jout = jenv._step_fn(vstate, jnp.asarray(acts), jenv.tsdata)
        pout = penv.step(acts, perm=perm, task_draws=draws)
        for name, j, p in zip(("obs", "reward", "done", "truncated"), jout, pout):
            np.testing.assert_array_equal(np.asarray(j), p, err_msg=f"step {i}: {name}")
        for name in ("task_id", "last_episode_task", "episodes_done"):
            np.testing.assert_array_equal(np.asarray(getattr(vstate, name)),
                                          getattr(penv.state, name).numpy(),
                                          err_msg=f"step {i}: {name}")
        ends += int(np.asarray(jout[2] | jout[3]).sum())
        tids |= set(np.asarray(vstate.task_id).tolist())
    want, want_env = _fields(vstate), _fields(vstate.env)
    got = state_to_numpy(penv.state.env)
    for name, x in got.items():
        np.testing.assert_array_equal(want_env[name].reshape(x.shape), x, err_msg=name)
    for name in ("desync_step", "episode_len", "last_episode_reward", "last_episode_gained"):
        np.testing.assert_array_equal(want[name], getattr(penv.state, name).numpy(), err_msg=name)
    assert ends >= 2 * E and len(tids) == 3    # episodes ended and tasks resampled


def test_jax_set_task_refuses_a_tracked_set(envs):
    """The JAX ``set_task`` compiles the new slot with ``track_stats=False``,
    which a ``track_stats=True`` set refuses; the port's compiles it with the
    set's own setting and equals a set built with the new task in place."""
    jenv, penv = envs(True)
    jcfgs, pcfgs = curriculum_cfgs()
    with pytest.raises(ValueError):
        jenv.set_task(1, jcfgs[0])
    twin = MultiTaskEnv(pcfgs, num_envs=E, seed=3, track_stats=True, device="cpu")
    twin.set_task(1, copy.deepcopy(pcfgs[0]))
    ref = MultiTaskEnv([pcfgs[0], pcfgs[0], pcfgs[2]], num_envs=E, seed=3, track_stats=True,
                       device="cpu")
    assert twin.tsdata.tables.varying == ref.tsdata.tables.varying
    tid, desync = np.array([1, 0, 2, 1, 1]), np.zeros(E)
    outs = [env.reset(task_id=tid, desync_step=desync) for env in (twin, ref)]
    np.testing.assert_array_equal(*outs)
    rng = np.random.default_rng(1)
    for _ in range(4):
        acts = rng.integers(0, len(ref.action_names), (E, A))
        perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(E)]))
        for a, b in zip(*(env.step(acts, perm=perm, task_draws=tid) for env in (twin, ref))):
            np.testing.assert_array_equal(a, b)


def _varied_cfgs():
    """Cooperation tasks (attack, transfer, assemblers) that differ in
    inventory limits, protocol cooldowns and max uses, attack cost, the
    transfer's amounts and reward weights."""
    cfgs = []
    for k in range(3):
        c = make_cooperation(A)
        c.game.map_builder.seed = 7
        c.game.max_steps = 0
        c.game.agent.inventory.default_limit = (50, 4, 7)[k]
        mine = c.game.objects["mine_red"].model_copy(deep=True)   # building.py objects are shared
        mine.protocols[0].cooldown = (50, 3, 9)[k]
        c.game.objects["mine_red"] = mine
        c.game.objects["generator_red"].max_uses = (0, 2, 5)[k]
        c.game.actions.attack.consumed_resources["laser"] = (1, 2, 3)[k]
        c.game.actions.transfer.vibe_transfers[0].actor["heart"] = (-1, -2, -1)[k]
        c.game.agent.rewards.inventory["ore_red"] = (0.0, 0.25, 1.0)[k]
        cfgs.append(c)
    return cfgs


def test_each_env_reads_its_own_tables():
    """Every env of a set whose tasks differ in many leaves steps as a
    single-task env of its own task, given the same actions and orders."""
    cfgs = _varied_cfgs()
    tid = np.array([0, 1, 2, 2, 1, 0])
    n = len(tid)
    mt = MultiTaskEnv(cfgs, num_envs=n, seed=0, desync_episodes=False, track_stats=True,
                      device="cpu")
    assert {"agent_lims", "proto_cooldown", "type_max_uses", "attack_consumed",
            "transfer_actor_delta", "stat_w"} <= mt.tsdata.tables.varying
    singles = [MettaGridEnv(copy.deepcopy(c), num_envs=n, seed=0, desync_episodes=False,
                            track_stats=True, step_mode="batched", device="cpu") for c in cfgs]
    obs = mt.reset(task_id=tid)
    for k, env in enumerate(singles):
        np.testing.assert_array_equal(env.reset().numpy()[tid == k], obs[tid == k])
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(4)
    state, inv = mt.state.env, torch.randint(0, 4, mt.state.env.agent_inv.shape, generator=gen,
                                             dtype=torch.int32)
    vibes = torch.randint(0, 3, state.agent_vibe.shape, generator=gen, dtype=torch.int32)
    mt._state = mt.state.replace(env=state.replace(agent_inv=inv, agent_vibe=vibes))
    for env in singles:
        env._state = env.state.replace(env=env.state.env.replace(agent_inv=inv.clone(),
                                                                 agent_vibe=vibes.clone()))
    for i in range(12):
        acts = rng.integers(0, mt.compiled.n_actions, (n, A))
        perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(n)]))
        got = mt.step(acts, perm=perm, task_draws=tid)
        for k, env in enumerate(singles):
            want = env.step(acts, perm=perm)
            for name, g, w in zip(("obs", "reward", "done", "truncated"), got, want):
                np.testing.assert_array_equal(w.numpy()[tid == k], g[tid == k],
                                              err_msg=f"step {i} task {k}: {name}")


def _arena(seed=1, heart_w=1.0):
    cfg = make_arena(num_agents=4)
    cfg.game.map_builder.seed = seed
    cfg.game.agent.rewards.inventory["heart"] = heart_w
    return cfg


def test_single_task_set_matches_plain_env():
    """weights=[1] over one task == the plain batched env, byte for byte."""
    cfg = _arena(seed=3)
    n = 3
    mt = MultiTaskEnv([copy.deepcopy(cfg)], num_envs=n, desync_episodes=False, device="cpu")
    plain = MettaGridEnv(copy.deepcopy(cfg), num_envs=n, desync_episodes=False,
                         track_stats=False, step_mode="batched", device="cpu")
    np.testing.assert_array_equal(mt.reset(), plain.reset().numpy())
    assert not mt.tsdata.tables.varying
    rng = np.random.default_rng(0)
    for _ in range(6):
        acts = rng.integers(0, len(mt.action_names), (n, mt.num_agents))
        perm = torch.as_tensor(np.stack([rng.permutation(4) for _ in range(n)]))
        for a, b in zip(mt.step(acts, perm=perm), plain.step(acts, perm=perm)):
            np.testing.assert_array_equal(a, b.numpy())


def test_tasks_mix_and_static_grids_are_per_env():
    cfgs = [_arena(seed=s) for s in (1, 2, 3)]
    for c in cfgs:
        c.game.max_steps = 8
    n = 32
    mt = MultiTaskEnv(cfgs, num_envs=n, desync_episodes=False, device="cpu")
    mt.reset()
    tids0 = mt.state.task_id.numpy()
    assert len(np.unique(tids0)) > 1, "envs should spread across tasks"
    for e in range(3):
        np.testing.assert_array_equal(mt.state.env.static_kind[e].numpy(),
                                      mt.tsdata.template.static_kind[tids0[e]].numpy())
    acts = np.zeros((n, mt.num_agents), np.int64)
    for _ in range(9):
        mt.step(acts)
    assert (mt.state.env.step.numpy() <= 1).all()
    assert len(np.unique(mt.state.task_id.numpy())) > 1
    for e in range(n):
        np.testing.assert_array_equal(
            mt.state.env.static_kind[e].numpy(),
            mt.tsdata.template.static_kind[int(mt.state.task_id[e])].numpy())


def test_one_hot_weights_pin_every_env_to_task():
    mt = MultiTaskEnv([_arena(seed=1), _arena(seed=2)], num_envs=8, desync_episodes=False,
                      device="cpu")
    mt.set_weights([0.0, 1.0])
    mt.reset()
    assert (mt.state.task_id.numpy() == 1).all()


def test_incompatible_tasks_rejected():
    other = make_arena(num_agents=8)      # another shape class (agent count)
    other.game.map_builder.seed = 1
    with pytest.raises(ValueError, match="compatible"):
        build_task_set([_arena(seed=1), other])
    mt = MultiTaskEnv([_arena(seed=1), _arena(seed=2)], num_envs=2, device="cpu")
    with pytest.raises(ValueError, match="compatible"):
        mt.set_task(0, other)
