"""The port's evaluation rollouts against the JAX package's, on the CPU.

Navigation 8x8 (map seeded) with 2-3 agents, 3 episodes of 10 steps:

- ``compute_policy_agent_counts`` against the JAX function over many
  agent counts and proportions;
- ``multi_episode_rollout`` with ``RandomPolicy`` and ``NoopPolicy`` mixes
  against the JAX host loop (the loop a replay takes): assignments, rewards
  (float64 in both, byte for byte), steps and ``episode_stats`` equal, and
  the replay ``.json.z`` decompressed to equal JSON. The only difference
  allowed is the map builder's class path in ``mg_config``, which names each
  package's own module. Each step's agent orders are the JAX env's, derived
  from its keys and handed to the port as ``perms``;
- greedy ``NetworkPolicy`` rollouts for the ``"lstm"`` and ``"Ag,A,S"``
  cores, one bundle written by the port (float32, every parameter leaf
  moved off its initial value) and read by both packages: the JAX scan run
  for 14 steps (frozen after each episode's end at step 10) equals the JAX
  host loop (stopped at step 10) and the port's loop; the port's logits
  at every step equal flax's on the same observations within the
  tolerances of ``tests/test_torch_policy.py`` (1e-5 absolute for the
  LSTM core, 1e-4 of the largest magnitude for the cortex core), and the
  smallest top-2 logit margin of the run is above that tolerance, so the
  argmax is decided (measured on the CPU: the largest error 0.137 of the
  tolerance and the smallest margin 1.37e5 times it for the LSTM core,
  0.0152 and 476 for the cortex core);
- each package's ``NetworkPolicy`` for one step, ``reset_slots`` and the
  per-agent view;
- ``run_simulations`` and ``aggregate_stats`` on two simulations with one
  agent (one agent order).

Each JAX rollout compiles its env once; no ``lax.scan`` runs over more than
14 steps.
"""

from __future__ import annotations

import json
import zlib

import jax
import numpy as np
import pytest
import torch

from metta_tpu.builder.envs import make_navigation as jax_make_navigation
from metta_tpu.engine.env import MettaGridEnv as JaxEnv
from metta_tpu.policy import policy as jax_policy
from metta_tpu.sim import rollout as jax_rollout
from metta_tpu.sim import runner as jax_runner
from metta_tpu_torch import sim
from metta_tpu_torch.builder.envs import make_navigation
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.models.vit import ViTConfig
from metta_tpu_torch.policy import policy as port_policy
from metta_tpu_torch.rl.checkpoint import save_policy_bundle
from metta_tpu_torch.sim import rollout, runner
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

E, MAX_STEPS, SEED = 3, 10, 5
N_ACTIONS = 5
TINY = dict(latent_dim=16, actor_hidden=16, critic_hidden=16, max_tokens=16,
            core_num_latents=2, core_num_heads=2, compute_dtype="float32")
# the tolerances of tests/test_torch_policy.py: absolute, or of the largest |logit|
LOGIT_TOL = {"lstm": ("abs", 1e-5), "Ag,A,S": ("rel", 1e-4)}


def cfgs(agents=2, max_steps=MAX_STEPS):
    """(port config, JAX config): navigation 8x8, the map seeded."""
    out = []
    for make in (make_navigation, jax_make_navigation):
        cfg = make(num_agents=agents, width=8, height=8)
        cfg.game.map_builder.seed = 3
        cfg.game.max_steps = max_steps
        out.append(cfg)
    return out


def reset_keys(seed, n_envs):
    """The env keys of the JAX env's reset with ``PRNGKey(seed)``
    (``engine/env.py:reset_batch``, ``engine/step.py:make_reset_batch``)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_envs)
    return jax.vmap(lambda k: jax.random.split(k)[0])(keys)


def jax_perms(seed, n_envs, n_agents, steps):
    """[steps, E, A]: the agent order each step of the JAX batched step
    draws from each env's key (``engine/step_batched.py:149-157``); the key
    chain does not depend on the actions."""
    keys = reset_keys(seed, n_envs)
    out = []
    for _ in range(steps):
        parts = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
        perm = jax.vmap(lambda k: jax.random.permutation(k, n_agents))(parts[:, 1])
        out.append(np.asarray(perm))
        keys = parts[:, 0]
    return np.stack(out)


def feed_jax_perms(monkeypatch, n_envs, n_agents, steps):
    """Make the port's rollouts take, each step, the agent orders that the
    JAX env draws (``jax_perms``) in place of their own."""
    perms = jax_perms(SEED, n_envs, n_agents, steps)
    draw = rollout.RolloutDraws.step

    def step(self, t):
        _, clip = draw(self, t)
        return torch.as_tensor(perms[t], dtype=torch.int64), clip
    monkeypatch.setattr(rollout.RolloutDraws, "step", step)


def test_reset_keys_are_the_jax_envs():
    _, jcfg = cfgs()
    env = JaxEnv(jcfg, num_envs=E, desync_episodes=False, step_mode="batched")
    env.reset(seed=SEED)
    np.testing.assert_array_equal(np.asarray(env.state.env.key), np.asarray(reset_keys(SEED, E)))


def test_policy_agent_counts_match_jax():
    rng = np.random.default_rng(0)
    cases = [(10, [1.0]), (10, [1.0, 1.0]), (10, [2.0, 1.0]), (24, [1, 1, 1]), (1, [0.5, 0.5])]
    cases += [(int(rng.integers(1, 40)), list(rng.random(int(rng.integers(1, 6))) + 1e-3))
              for _ in range(200)]
    for n, props in cases:
        got = rollout.compute_policy_agent_counts(n, props)
        assert got == jax_rollout.compute_policy_agent_counts(n, props), (n, props)
        assert sum(got) == n
    for mod in (rollout, jax_rollout):
        with pytest.raises(ValueError, match="positive"):
            mod.compute_policy_agent_counts(4, [0.0])


def replay_json(path):
    return json.loads(zlib.decompress(open(path, "rb").read()))


def same_replay(got_path, want_path):
    """The decompressed replays equal, the map builder's class path compared
    by its class name (each package names its own module)."""
    got, want = replay_json(got_path), replay_json(want_path)
    types = [r["mg_config"]["game"]["map_builder"].pop("type") for r in (got, want)]
    assert types[0].startswith("metta_tpu_torch.") and types[1].startswith("metta_tpu.")
    assert types[0].rsplit(".", 1)[1] == types[1].rsplit(".", 1)[1]
    assert got == want
    return got


def same_rollout(got, want, exact_rewards=True, replays=True):
    """Episodes equal: assignments, rewards (byte for byte, or by value
    against the scan's float32 sums), steps, max_steps and stats; and which
    episode has a replay, where both ran the same loop (the scan saves
    none)."""
    assert len(got.episodes) == len(want.episodes)
    for g, w in zip(got.episodes, want.episodes):
        np.testing.assert_array_equal(g.assignments, w.assignments)
        if exact_rewards:
            assert g.rewards.dtype == w.rewards.dtype and g.rewards.tobytes() == w.rewards.tobytes()
        else:
            np.testing.assert_array_equal(g.rewards, w.rewards)
        assert (g.steps, g.max_steps) == (w.steps, w.max_steps)
        assert g.stats == w.stats
        if replays:
            assert (g.replay_path is None) == (w.replay_path is None)


MIXES = {
    "random": (["random"], None),
    "random_noop": (["random", "noop"], None),
    "noop_random_2_1": (["noop", "random"], [2.0, 1.0]),
}


def make_policies(kinds, mod):
    return [mod.RandomPolicy(N_ACTIONS, seed=1) if k == "random" else mod.NoopPolicy()
            for k in kinds]


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_rollout_and_replay_match_jax_host_loop(mix, tmp_path, monkeypatch):
    kinds, props = MIXES[mix]
    cfg, jcfg = cfgs(agents=3)
    feed_jax_perms(monkeypatch, E, 3, MAX_STEPS)
    want = jax_rollout.multi_episode_rollout(
        jcfg, make_policies(kinds, jax_policy), episodes=E, seed=SEED, proportions=props,
        save_replay=str(tmp_path / "jax"))
    got = rollout.multi_episode_rollout(
        cfg, make_policies(kinds, port_policy), episodes=E, seed=SEED, proportions=props,
        save_replay=str(tmp_path / "port"), device="cpu")
    same_rollout(got, want)
    assert all(ep.steps == MAX_STEPS for ep in got.episodes)
    data = same_replay(got.episodes[0].replay_path, want.episodes[0].replay_path)
    assert data["version"] == 3 and data["max_steps"] == MAX_STEPS and data["num_agents"] == 3
    if "random" in kinds:
        moved = [ep.stats["agent"][a]["status.steps_without_motion"] < MAX_STEPS
                 for ep in got.episodes for a in range(3)]
        assert any(moved)                      # the random agents moved


def test_rollout_without_perms_is_device_independent_draws():
    """The rollout's orders come from a CPU generator seeded with its seed: two rollouts with one seed agree, and the env's own
    generator is never drawn from."""
    cfg, _ = cfgs(agents=3)
    runs = [rollout.multi_episode_rollout(cfg, [port_policy.RandomPolicy(N_ACTIONS, seed=2)],
                                          episodes=E, seed=SEED, device="cpu")
            for _ in range(2)]
    same_rollout(*runs)
    draws = rollout.RolloutDraws(MettaGridEnv(cfg, num_envs=E, device="cpu"), SEED)
    perm, clip = draws.step(0)
    assert clip is None and perm.shape == (E, 3)
    assert torch.equal(perm, rollout.RolloutDraws(draws.env, SEED).step(0)[0])


class RecordingPolicy(port_policy.NetworkPolicy):
    """A port ``NetworkPolicy`` that keeps each step's observations and logits."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.seen = []

    def logits(self, obs):
        out = super().logits(obs)
        self.seen.append((obs.numpy().copy(), out.numpy().copy()))
        return out


def tiny_bundle(path, core, n_actions, norms):
    """A bundle of a tiny float32 ViT with ``core``, drawn by the port with
    every parameter leaf moved by a seeded N(0, 0.5)."""
    arch = ViTConfig(**TINY, core=core)
    drawn = arch.make(n_actions, norms, generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for p in drawn.parameters():
            p.add_(0.5 * torch.randn(p.shape, generator=gen))
    save_policy_bundle(path, drawn.state_dict(), arch, extra={"epoch": 1})
    return f"file://{path}"


@pytest.mark.parametrize("core", ["lstm", "Ag,A,S"])
def test_greedy_network_rollout_matches_jax_scan(core, tmp_path, monkeypatch):
    cfg, jcfg = cfgs()
    A, long = 2, MAX_STEPS + 4               # the scan runs 4 steps past the episodes' end
    penv = MettaGridEnv(cfg, device="cpu")
    jenv = JaxEnv(jcfg)
    uri = tiny_bundle(tmp_path / "tiny:v1", core, penv.compiled.n_actions,
                      penv.compiled.feature_normalizations)

    def jpol():
        return jax_policy.NetworkPolicy.from_bundle(uri, jenv, n_slots=1, sample=False)
    scan = jax_rollout.multi_episode_rollout(jcfg, [jpol()], episodes=E, seed=SEED,
                                             max_steps_override=long)
    host = jax_rollout.multi_episode_rollout(jcfg, [jpol()], episodes=E, seed=SEED,
                                             max_steps_override=long,
                                             save_replay=str(tmp_path / "jax"))
    # frozen after the episodes' end (the scan) = stopped at it (the host loop)
    same_rollout(host, scan, exact_rewards=False, replays=False)
    assert [ep.steps for ep in scan.episodes] == [MAX_STEPS] * E

    pol = RecordingPolicy.from_bundle(uri, penv.compiled, n_slots=1, sample=False, device="cpu")
    feed_jax_perms(monkeypatch, E, A, MAX_STEPS)
    got = rollout.multi_episode_rollout(cfg, [pol], episodes=E, seed=SEED,
                                        max_steps_override=long, device="cpu",
                                        save_replay=str(tmp_path / "port"))
    same_rollout(got, host)
    same_rollout(got, scan, exact_rewards=False, replays=False)
    same_replay(got.episodes[0].replay_path, host.episodes[0].replay_path)

    # the port's logits at every step against flax's on the same observations
    assert len(pol.seen) == MAX_STEPS
    ref = jpol()
    apply = jax.jit(ref.policy.apply)
    state = ref.policy.initial_state(E * A)
    kind, tol = LOGIT_TOL[core]
    margin, worst = np.inf, 0.0
    for obs, logits in pol.seen:
        want, _, _, state = apply(ref.params, obs[:, :TINY["max_tokens"]], state)
        want = np.asarray(want)
        bound = tol if kind == "abs" else tol * float(np.abs(want).max())
        err = float(np.abs(logits - want).max())
        assert err <= bound, (err, bound)
        worst = max(worst, err / bound)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        margin = min(margin, float((top2[:, 1] - top2[:, 0]).min()) / bound)
    # the smallest top-2 margin, in units of the tolerance (lstm: 1e-5
    # absolute; cortex: 1e-4 of a step's largest |logit|), must exceed 1
    assert margin > 1.0, f"smallest top-2 logit margin {margin:.3g} x the tolerance"
    print(f"{core}: largest logit error {worst:.3g} x the tolerance, smallest top-2 "
          f"margin {margin:.3g} x the tolerance")


def test_run_simulations_and_aggregate_stats_match_jax():
    cfg, jcfg = cfgs(agents=1, max_steps=8)
    sims = [runner.SimulationConfig(suite="nav", name=n, env=cfg, episodes=2) for n in "ab"]
    jsims = [jax_runner.SimulationConfig(suite="nav", name=n, env=jcfg, episodes=2) for n in "ab"]
    got = runner.run_simulations([port_policy.RandomPolicy(N_ACTIONS, seed=4)], sims, seed=9,
                                 device="cpu")
    want = jax_runner.run_simulations([jax_policy.RandomPolicy(N_ACTIONS, seed=4)], jsims, seed=9)
    assert [r.key for r in got] == [r.key for r in want] == ["nav/a", "nav/b"]
    for g, w in zip(got, want):
        assert (g.suite, g.name, g.mean_reward, g.mean_reward_by_policy) == \
            (w.suite, w.name, w.mean_reward, w.mean_reward_by_policy)
        assert g.mean_stats == w.mean_stats == jax_runner.aggregate_stats(w.rollout)
        assert runner.aggregate_stats(g.rollout) == g.mean_stats
        same_rollout(g.rollout, w.rollout)


def test_unported_sim_modules_refuse_by_name():
    for name, where in (("run_single_episode_job", "single_episode.py"),
                        ("create_server", "serve_policy.py"), ("EvalTaskQueue", "remote.py")):
        with pytest.raises(NotImplementedError, match=where):
            getattr(sim, name)
    with pytest.raises(AttributeError):
        sim.no_such_name  # noqa: B018


@pytest.mark.parametrize("core", ["lstm", "Ag,A,S"])
def test_network_policy_slots_match_jax(core, tmp_path):
    """One step of each package's ``NetworkPolicy`` on the same observations,
    then ``reset_slots`` on two of four slots: every state leaf of the reset
    slots zero and the rest within the logit tolerance of flax's; the
    per-agent view (``agent_policy(a).step``) of a one-slot policy."""
    from metta_tpu_torch.convert import flatten_tree

    cfg, jcfg = cfgs()
    penv = MettaGridEnv(cfg, num_envs=2, device="cpu")
    uri = tiny_bundle(tmp_path / "tiny:v1", core, penv.compiled.n_actions,
                      penv.compiled.feature_normalizations)
    obs = penv.reset().reshape(4, *penv.single_observation_space_shape)
    pol = port_policy.NetworkPolicy.from_bundle(uri, penv.compiled, n_slots=4, sample=False,
                                                device="cpu")
    ref = jax_policy.NetworkPolicy.from_bundle(uri, JaxEnv(jcfg), n_slots=4, sample=False)
    np.testing.assert_array_equal(pol.step_batch(obs).numpy(), ref.step_batch(obs.numpy()))
    mask = np.array([True, False, True, False])
    pol.reset_slots(mask)
    ref.reset_slots(mask)

    def leaves(state):
        return [np.asarray(v) for _, v in sorted(flatten_tree(state).items())] \
            if isinstance(state, dict) else [np.asarray(v) for v in state]
    for got, want in zip(leaves(pol.state), leaves(ref.state)):
        assert not got[mask].any()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))
    pol.reset(1)                                  # the per-agent view of a one-slot policy
    a = pol.agent_policy(0).step(obs[1])
    assert isinstance(a, int) and 0 <= a < N_ACTIONS
