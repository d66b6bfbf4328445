"""The port's evaluation, replay and play entry points against the JAX
package's, on the CPU.

- ``EvaluateTool``, ``ReplayTool`` and ``PlayTool`` of both packages on one
  bundle whose actor bias puts ``move_south`` ahead of every other action
  by 1,000: no float32 Gumbel draw (about -3 to 17) can overturn that
  margin, so the JAX tools' ``jax.random`` samples and the port's torch
  samples take the same action. Navigation 8x8 with one agent (one agent
  order) and the map seeded: the same ``output_json``, the same replay JSON
  (the map builder's class path aside: each package names its own module)
  and the same terminal frames, with the bundle and with ``RandomPolicy``.
- ``TrainTool`` with ``evaluate_interval=1`` against the JAX tool on the
  fakes of ``tests/test_torch_train_tool.py``: the same bundles saved, the
  same simulations run with the same seeds (the update's index), the same
  ``eval <suite/name>: mean_reward`` lines; and the port's tool end to end
  at a tiny size with its real evaluator.
- ``PettingZooEnv``'s dict outputs over an episode and an auto-reset, two
  agents, the JAX env's agent orders fed to the port's sequential step.
- The arena recipe's ``simulations``, ``evaluate``, ``play`` and ``replay``
  against the JAX recipe's; the refusal of ``PlayTool(serve=True)``.
"""

from __future__ import annotations

import json
import logging

import jax
import numpy as np
import pytest
import torch

import metta_tpu.engine.env as jax_env_mod
import metta_tpu.policy.policy as jax_policy_mod
import metta_tpu.rl.checkpoint as jax_ckpt
import metta_tpu.rl.trainer as jax_trainer_mod
import metta_tpu.sim.runner as jax_runner_mod
from metta_tpu.builder.envs import make_navigation as jax_make_navigation
from metta_tpu.envs.pettingzoo_env import PettingZooEnv as JaxPettingZooEnv
from metta_tpu.sim.runner import SimulationConfig as JaxSimulationConfig
from metta_tpu.tools import evaluate as jax_evaluate
from metta_tpu.tools import play as jax_play
from metta_tpu.tools import train as jax_train
from metta_tpu_torch.builder.envs import make_navigation
from metta_tpu_torch.engine import step as step_mod
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.envs.pettingzoo_env import PettingZooEnv
from metta_tpu_torch.models.vit import ViTConfig
from metta_tpu_torch.rl.checkpoint import save_policy_bundle
from metta_tpu_torch.rl.config import TrainerConfig
from metta_tpu_torch.sim.runner import SimulationConfig
from metta_tpu_torch.tools import evaluate, play
from metta_tpu_torch.tools import train as port_train
from metta_tpu_torch.tools.tool import apply_overrides, load_tool
from test_torch_sim_eval import same_replay
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_tool import B, T, Script, fakes, tiny_tool

DOMINANT = "move_south"
TINY = dict(latent_dim=16, actor_hidden=16, critic_hidden=16, max_tokens=16,
            core_num_latents=2, core_num_heads=2, core="lstm", compute_dtype="float32")


def cfgs(agents=1, max_steps=8):
    out = []
    for make in (make_navigation, jax_make_navigation):
        cfg = make(num_agents=agents, width=8, height=8)
        cfg.game.map_builder.seed = 3
        cfg.game.max_steps = max_steps
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def dominated(tmp_path_factory):
    """A bundle URI whose policy puts ``move_south`` 1,000 ahead of every
    other action."""
    cfg, _ = cfgs()
    compiled = MettaGridEnv(cfg, device="cpu").compiled
    arch = ViTConfig(**TINY)
    pol = arch.make(compiled.n_actions, compiled.feature_normalizations,
                    generator=torch.Generator().manual_seed(3))
    sd = pol.state_dict()
    sd["actor_head.bias"][compiled.action_names.index(DOMINANT)] += 1000.0
    path = tmp_path_factory.mktemp("bundle") / "dominated:v1"
    save_policy_bundle(path, sd, arch, extra={"epoch": 1})
    return f"file://{path}"


def test_evaluate_tool_matches_jax(dominated, tmp_path):
    cfg, jcfg = cfgs()
    sims = [SimulationConfig(suite="nav", name=n, env=cfg, episodes=2, max_steps=6)
            for n in ("a", "b")]
    jsims = [JaxSimulationConfig(suite="nav", name=n, env=jcfg, episodes=2, max_steps=6)
             for n in ("a", "b")]
    out, jout = tmp_path / "port.json", tmp_path / "jax.json"
    assert evaluate.EvaluateTool(policy_uri=dominated, output_json=str(out), seed=4,
                                 device="cpu").with_simulations(sims).invoke() == 0
    assert jax_evaluate.EvaluateTool(policy_uri=dominated, output_json=str(jout),
                                     seed=4).with_simulations(jsims).invoke() == 0
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert got == want
    assert [r["name"] for r in got] == ["a", "b"]
    assert got[0]["mean_stats"]["status.steps_without_motion"] > 0    # south into the wall


@pytest.mark.parametrize("name", ["navigation", "arena"])
def test_compile_config_gives_the_policy_what_the_env_does(name):
    """``compile_config``, which the tools load a policy with instead of an
    env, gives the env's action count, agents, action names and feature
    normalizations."""
    from metta_tpu_torch.builder import envs
    from metta_tpu_torch.engine.compiler import compile_config

    cfg = cfgs()[0] if name == "navigation" else envs.make_arena(num_agents=4)
    got, want = compile_config(cfg), MettaGridEnv(cfg, device="cpu").compiled
    assert (got.n_actions, got.num_agents, got.action_names, got.feature_normalizations) == \
        (want.n_actions, want.num_agents, want.action_names, want.feature_normalizations)


def test_replay_tool_matches_jax(dominated, tmp_path):
    cfg, jcfg = cfgs()
    for uri in (dominated, None):
        dirs = {k: tmp_path / f"{k}_{uri is None}" for k in ("port", "jax")}
        assert play.ReplayTool(env=cfg, policy_uri=uri, episodes=2, seed=1, device="cpu",
                               replay_dir=str(dirs["port"])).invoke() == 0
        assert jax_play.ReplayTool(env=jcfg, policy_uri=uri, episodes=2, seed=1,
                                   replay_dir=str(dirs["jax"])).invoke() == 0
        paths = {k: sorted(d.glob("*.json.z")) for k, d in dirs.items()}
        assert len(paths["port"]) == len(paths["jax"]) == 1
        data = same_replay(paths["port"][0], paths["jax"][0])
        agent = [o for o in data["objects"] if o.get("agent_id") == 0][0]
        if uri is not None:
            south = data["action_names"].index(DOMINANT)
            assert agent["action_id"] == south


PLAY = dict(steps=5, fps=1e6, seed=2)


def test_play_tool_frames_match_jax(dominated, capsys):
    cfg, jcfg = cfgs()
    frames = {}
    for uri in (dominated, None):
        for name, tool in (
                ("port", play.PlayTool(env=cfg, policy_uri=uri, device="cpu", **PLAY)),
                ("jax", jax_play.PlayTool(env=jcfg, policy_uri=uri, **PLAY))):
            assert tool.invoke() == 0
            frames[name] = capsys.readouterr().out
        assert frames["port"] == frames["jax"]
        assert frames["port"].count("\x1b[2J") == 5 and "step 5" in frames["port"]


def test_play_tool_serve_is_refused_before_anything_is_built(monkeypatch):
    def no_env(*a, **k):
        raise AssertionError("an env was built")
    monkeypatch.setattr(play, "MettaGridEnv", no_env)
    with pytest.raises(NotImplementedError, match="renderer/live_server.py"):
        play.PlayTool(serve=True, device="cpu").invoke()
    from metta_tpu_torch import renderer
    with pytest.raises(NotImplementedError, match="live_server.py"):
        renderer.serve_play  # noqa: B018


# ---------------------------------------------------------------------------
# TrainTool's evaluator
# ---------------------------------------------------------------------------

N_UPDATES = 3


def run_fake_eval_tool(pkg, tmp_path, monkeypatch, caplog):
    """One package's ``TrainTool`` with ``evaluate_interval=1`` on the fakes:
    -> (evaluator calls, checkpoint calls, eval log lines)."""
    is_jax = pkg == "jax"
    script = Script(N_UPDATES, False, np.asarray if is_jax else torch.from_numpy)
    log, cm_log = [], []
    FakeTrainer, FakeCM = fakes(script, log, cm_log, refuse_tracked=is_jax,
                                heterogeneous=False, resume=False)

    class UriCM(FakeCM):
        def save_policy(self, params, arch, epoch, metadata=None):
            super().save_policy(params, arch, epoch, metadata)
            return f"file://fake:v{epoch}"

    class FakeEnv:                  # the JAX evaluator reads the config through an env
        def __init__(self, cfg, num_envs=1, **kw):
            log.append(("eval config", cfg.label))

    def fake_compile_config(cfg):   # the port's compiles it without one
        log.append(("eval config", cfg.label))

    class FakePolicy:
        @classmethod
        def from_bundle(cls, uri, env_or_compiled, n_slots, **kw):
            log.append(("from_bundle", uri, n_slots))
            pol = cls()
            pol.uri = uri
            return pol

    def fake_run_simulations(policies, sims, seed=0, **kw):
        log.append(("run_simulations", [p.uri for p in policies], [s.name for s in sims], seed))
        return [jax_runner_mod.SimulationResult(suite=s.suite, name=s.name, rollout=None,
                                                mean_reward=seed / 8 + i)
                for i, s in enumerate(sims)]

    mod = jax_train if is_jax else port_train
    monkeypatch.setattr(mod, "time", script.clock)
    if is_jax:
        monkeypatch.setattr(jax_trainer_mod, "Trainer", FakeTrainer)
        monkeypatch.setattr(jax_ckpt, "CheckpointManager", UriCM)
        monkeypatch.setattr(jax_env_mod, "MettaGridEnv", FakeEnv)
        monkeypatch.setattr(jax_policy_mod, "NetworkPolicy", FakePolicy)
        monkeypatch.setattr(jax_runner_mod, "run_simulations", fake_run_simulations)
        cfg, env = jax_train.TrainerConfig(total_timesteps=N_UPDATES * B * T), cfgs()[1]
        sims = [JaxSimulationConfig(suite="nav", name=n, env=env) for n in ("a", "b")]
        kw = {}
    else:
        for name, fake in (("Trainer", FakeTrainer), ("CheckpointManager", UriCM),
                           ("compile_config", fake_compile_config),
                           ("NetworkPolicy", FakePolicy),
                           ("run_simulations", fake_run_simulations)):
            monkeypatch.setattr(port_train, name, fake)
        cfg, env = TrainerConfig(total_timesteps=N_UPDATES * B * T), cfgs()[0]
        sims = [SimulationConfig(suite="nav", name=n, env=env) for n in ("a", "b")]
        kw = {"device": "cpu"}
    tool = mod.TrainTool(env=env, run="ev", data_dir=str(tmp_path / pkg), trainer=cfg,
                         checkpoint_interval=2, evaluate_interval=1, **kw)
    tool.with_simulations(sims)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=mod.__name__):
        assert tool.invoke() == 0
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("eval ")]
    return [e for e in log if e[0] != "trainer"], cm_log, lines


def test_train_tool_evaluator_matches_jax(tmp_path, monkeypatch, caplog):
    got = run_fake_eval_tool("port", tmp_path, monkeypatch, caplog)
    want = run_fake_eval_tool("jax", tmp_path, monkeypatch, caplog)
    assert got == want
    calls, cm_log, lines = got
    assert [c for c in calls if c[0] == "run_simulations"] == \
        [("run_simulations", [f"file://fake:v{u}"], ["a", "b"], u) for u in (1, 2, 3)]
    assert ("policy", 2) in cm_log and cm_log.count(("policy", 2)) == 2   # checkpoint + eval
    assert lines[:2] == ["eval nav/a: mean_reward 0.1250", "eval nav/b: mean_reward 1.1250"]


def test_train_tool_evaluates_end_to_end(tmp_path, caplog):
    """The port's tool with its real evaluator at a tiny size: a bundle and
    both simulations after each update."""
    cfg, _ = cfgs(agents=2, max_steps=6)
    sims = [SimulationConfig(suite="nav", name=n, env=cfg, episodes=2) for n in ("a", "b")]
    tool = tiny_tool(tmp_path, "ev", evaluate_interval=1, updates=2).with_simulations(sims)
    with caplog.at_level(logging.INFO, logger=port_train.__name__):
        assert tool.invoke() == 0
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("eval ")]
    assert [s.split(":")[0] for s in lines] == ["eval nav/a", "eval nav/b"] * 2
    assert all(np.isfinite(float(s.rsplit(" ", 1)[1])) for s in lines)


# ---------------------------------------------------------------------------
# PettingZoo
# ---------------------------------------------------------------------------


@jax.jit
def _key_perms(keys):
    return jax.vmap(lambda k: jax.random.permutation(jax.random.split(k, 4)[1], 2))(keys)


def test_pettingzoo_matches_jax(monkeypatch):
    cfg, jcfg = cfgs(agents=2, max_steps=5)
    env, jenv = PettingZooEnv(cfg, seed=4, device="cpu"), JaxPettingZooEnv(jcfg, seed=4)
    assert env.possible_agents == jenv.possible_agents == ["agent_0", "agent_1"]
    for space in ("observation_space", "action_space"):
        got, want = getattr(env, space)("agent_0"), getattr(jenv, space)("agent_0")
        assert type(got) is type(want) and repr(got) == repr(want)
    perm = {}
    monkeypatch.setattr(step_mod, "random_perm", lambda E, A, gen, dev: perm["next"])

    def same(got, want):
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k
    obs, infos = env.reset()
    jobs, jinfos = jenv.reset()
    same(obs, jobs)
    same(infos, jinfos)
    rng = np.random.default_rng(0)
    ended = []
    for _ in range(8):
        perm["next"] = torch.from_numpy(np.asarray(_key_perms(jenv._env.state.env.key)).copy())
        acts = {a: int(rng.integers(0, 5)) for a in env.possible_agents}
        got, want = env.step(acts), jenv.step(acts)
        for g, w in zip(got, want):
            same(g, w)
        assert env.agents == jenv.agents and env.num_agents == jenv.num_agents
        ended.append(not env.agents)
    # max_steps 5: the episode ends at step 5 (the list stays empty until
    # reset, as in the JAX adapter); the env auto-resets beneath it
    assert ended == [False] * 4 + [True] * 4


# ---------------------------------------------------------------------------
# the recipe and the CLI
# ---------------------------------------------------------------------------


def _dump(cfg):
    """The config as a replay's ``mg_config`` holds it (JSON mode, field
    order kept), the map builder's class path cut to its class name."""
    d = cfg.model_dump(mode="json")
    d["game"]["map_builder"]["type"] = d["game"]["map_builder"]["type"].rsplit(".", 1)[-1]
    return json.dumps(d)


def test_arena_recipe_eval_tools_match_jax():
    from metta_tpu_torch.recipes import arena_basic_easy_shaped as arena
    from recipes import arena_basic_easy_shaped as jax_arena

    sims, jsims = arena.simulations(), jax_arena.simulations()
    assert [(s.suite, s.name, s.episodes, s.max_steps) for s in sims] == \
        [(s.suite, s.name, s.episodes, s.max_steps) for s in jsims]
    assert [_dump(s.env) for s in sims] == [_dump(s.env) for s in jsims]
    assert [s.env.game.actions.attack.consumed_resources["laser"] for s in sims] == [100, 1]
    assert [s.name for s in arena.train()._simulations] == \
        [s.name for s in jax_arena.train()._simulations]
    tool, jtool = arena.evaluate("file:///x"), jax_arena.evaluate("file:///x")
    assert tool.policy_uri == jtool.policy_uri and tool.device is None
    assert [_dump(s.env) for s in tool._simulations] == [_dump(s.env) for s in jtool._simulations]
    for fn in ("play", "replay"):
        tool, jtool = getattr(arena, fn)(), getattr(jax_arena, fn)()
        assert _dump(tool.env) == _dump(jtool.env)
        fields = set(type(jtool).model_fields)
        assert set(type(tool).model_fields) == fields
        assert {k: getattr(tool, k) for k in fields - {"env"}} == \
            {k: getattr(jtool, k) for k in fields - {"env"}}
    assert set(evaluate.EvaluateTool.model_fields) == set(jax_evaluate.EvaluateTool.model_fields)


def test_cli_loads_the_eval_recipe():
    tool = load_tool("metta_tpu_torch.recipes.arena_basic_easy_shaped.evaluate")
    assert isinstance(tool, evaluate.EvaluateTool) and tool.device is None
    apply_overrides(tool, ["policy_uri=file:///tmp/run:v3", "device=cpu", "seed=7"])
    assert (tool.policy_uri, tool.device, tool.seed) == ("file:///tmp/run:v3", "cpu", 7)
    assert len(tool._simulations) == 2
