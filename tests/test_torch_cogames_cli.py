"""The port's ``cogames`` CLI and Cogs-vs-Clips recipe against ``metta_tpu``'s.

- Every command of ``python -m metta_tpu_torch.cogames`` prints what the JAX
  CLI (``metta_tpu/cogames/main.py``) prints, the package's name aside, and
  exits with its code: ``missions`` (all, by site, by mission), ``describe``
  (with cogs and a variant), ``evals``, ``variants``, ``make-mission`` (the
  JSON equal), ``policies``, ``version``, ``docs``, an unknown mission, and,
  on the CPU (``--device cpu``), ``tutorial`` (``play`` with the scripted
  policy), ``validate-policy`` and ``diagnose`` (its mission list cut to
  one short diagnostic in both packages). The scripted crew is one cog
  here, so no agent order and no draw of either env's generator changes
  what they print (``tests/test_torch_machina.py`` holds the scripted
  agent on ``machina_1`` with 4 cogs, every draw fed).
- ``recipes/prod/cogs_v_clips.py``: the port's ``mettagrid``,
  ``make_curriculum``, ``simulations`` and ``evaluate`` equal the JAX
  recipe's, and ``train()`` through each package's ``TrainTool`` with its
  ``Trainer`` and ``CheckpointManager`` replaced by fakes (those of
  ``tests/test_torch_train_tool.py``; the fake ``Trainer`` stacks the task
  set as its package does and raises its ValueError) takes the fallback of
  whole-batch swaps for the recipe's pool (its ``max_steps`` bucket mixes two
  shape classes) and the task set for a pool over the heart bucket alone,
  the same trainers, curriculum calls and records in both.
"""

from __future__ import annotations

import importlib
import json
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_tool import FakeState, Script

# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

PORT_ONLY = {"play": ["--device", "cpu"], "tutorial": ["--device", "cpu"],
             "validate-policy": ["--device", "cpu"], "diagnose": ["--device", "cpu"]}

COMMANDS = {
    "missions": ["missions"],
    "missions_site": ["missions", "machina_1"],
    "missions_mission": ["missions", "-m", "training_facility.harvest"],
    "missions_unknown_site": ["missions", "nowhere"],
    "describe": ["describe", "machina_1.open_world"],
    "describe_variant": ["describe", "training_facility.harvest", "-c", "2", "-v", "pack_rat"],
    "describe_unknown": ["describe", "nope.nothing"],
    "evals": ["evals"],
    "variants": ["variants"],
    "make_mission": ["make-mission", "machina_1.open_world_with_chests"],
    "make_mission_config": ["make-mission", "training_facility.tutorial", "--mg-config"],
    "policies": ["policies"],
    "version": ["version"],
    "docs": ["docs"],
    "no_command": [],
    "tutorial": ["tutorial", "--steps", "40"],
    "validate_policy": ["validate-policy", "random"],
}


def run_cli(pkg, argv, capsys):
    """(exit code, stdout, stderr) of ``pkg``'s CLI, the package's name
    replaced by ``PKG`` (and the docstring's line on how to run it, which
    names the JAX package's ``cogames`` script, left out)."""
    main = importlib.import_module(f"{pkg}.cogames.main")
    if pkg == "metta_tpu_torch" and argv and argv[0] in PORT_ONLY:
        argv = argv + PORT_ONLY[argv[0]]
    capsys.readouterr()
    rc = main.main(argv)
    out = capsys.readouterr()
    text = "\n".join(ln for ln in out.out.splitlines() if not ln.startswith("Run as "))
    return rc, text.replace(pkg, "PKG"), out.err.replace(pkg, "PKG")


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_command_prints_what_jax_prints(name, capsys):
    want = run_cli("metta_tpu", COMMANDS[name], capsys)
    got = run_cli("metta_tpu_torch", COMMANDS[name], capsys)
    assert got == want
    if name == "tutorial":
        assert "episode over" in got[1] and "resources gained" in got[1]


def test_make_mission_saves_the_same_json(tmp_path, capsys):
    for pkg in ("metta_tpu", "metta_tpu_torch"):
        path = tmp_path / f"{pkg}.json"
        rc, out, _ = run_cli(pkg, ["make-mission", "hello_world.open_world", "--save",
                                   str(path)], capsys)
        assert rc == 0 and "wrote" in out
    want = (tmp_path / "metta_tpu.json").read_text()
    assert (tmp_path / "metta_tpu_torch.json").read_text().replace(
        "metta_tpu_torch.", "metta_tpu.") == want


def test_diagnose_prints_what_jax_prints(capsys, monkeypatch):
    """``diagnose`` over the first diagnostic mission cut to 30 steps, in
    both packages (the full list runs every diagnostic to its end)."""
    for pkg in ("metta_tpu", "metta_tpu_torch"):
        evals = importlib.import_module(f"{pkg}.cogames.evals")
        missions = evals.get_diagnostic_missions()[:1]

        def short(ms=missions, pkg=pkg):
            out = []
            for m in ms:
                m = m.model_copy(deep=True)
                out.append(_ShortMission(m))
            return out
        monkeypatch.setattr(evals, "get_diagnostic_missions", short)
    want = run_cli("metta_tpu", ["diagnose"], capsys)
    got = run_cli("metta_tpu_torch", ["diagnose"], capsys)
    assert got == want
    assert got[1].count("PASS") + got[1].count("FAIL") == 1


class _ShortMission:
    """A mission whose env stops after 30 steps."""

    def __init__(self, mission):
        self.mission = mission

    def full_name(self):
        return self.mission.full_name()

    def make_env(self):
        cfg = self.mission.make_env()
        cfg.game.max_steps = 30
        return cfg


def test_module_entry_point_runs():
    """``python -m metta_tpu_torch.cogames`` (the package's ``__main__``)."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "metta_tpu_torch.cogames", "policies"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "scripted" in out.stdout


# ---------------------------------------------------------------------------
# the recipe
# ---------------------------------------------------------------------------


def recipe(pkg):
    name = "recipes.prod.cogs_v_clips" if pkg == "metta_tpu" else f"{pkg}.recipes.prod.cogs_v_clips"
    return importlib.import_module(name)


def _dump(x):
    return json.dumps(x.model_dump(), sort_keys=True, default=str).replace(
        "metta_tpu_torch.", "metta_tpu.")


def test_recipe_configs_match_jax():
    j, p = recipe("metta_tpu"), recipe("metta_tpu_torch")
    for mission in ("training_grounds", "basic"):
        assert _dump(p.mettagrid(mission)) == _dump(j.mettagrid(mission))
    jtasks, ptasks = (r.make_curriculum().active_tasks() for r in (j, p))
    assert len(ptasks) == len(jtasks) == 16
    assert [t.get_slice_values() for t in ptasks] == [t.get_slice_values() for t in jtasks]
    assert [_dump(t.get_env_cfg()) for t in ptasks] == [_dump(t.get_env_cfg()) for t in jtasks]
    for a, b in zip(j.simulations(), p.simulations()):
        assert (b.suite, b.name, b.episodes) == (a.suite, a.name, a.episodes)
        assert _dump(b.env) == _dump(a.env)
    jtool, ptool = j.train(), p.train()
    assert ptool.run == jtool.run == "cvc_training_grounds"
    assert len(ptool._simulations) == len(jtool._simulations) == 2
    ev = p.evaluate("file:///nowhere")
    assert ev.policy_uri == "file:///nowhere" and [s.name for s in ev._simulations] == [
        "training_grounds", "basic"]


def _jax_stacks(cfgs):
    """The JAX task set's verdict (``metta_tpu/engine/taskset.py:build_task_set``:
    the compiled tables' tree structure and leaf shapes), without its
    templates' compile."""
    from metta_tpu.engine.compiler import compile_game
    from metta_tpu.engine.tables import Tables

    trees = [Tables(compile_game(c.game, c.game.map_builder.create().build())[0],
                    track_stats=False) for c in cfgs]
    s0 = (jax.tree.structure(trees[0]), [x.shape for x in jax.tree.leaves(trees[0])])
    for i, t in enumerate(trees[1:], 1):
        if (jax.tree.structure(t), [x.shape for x in jax.tree.leaves(t)]) != s0:
            raise ValueError(f"task {i} is not shape/static-compatible with task 0")


def _heart_only(pkg):
    r = recipe(pkg)
    cur = importlib.import_module(f"{pkg}.cogworks.curriculum")
    tasks = cur.bucketed(r.mettagrid())
    tasks.add_bucket("game.agent.rewards.inventory.heart", [0.5, 1.0])
    return tasks.to_curriculum(algorithm_config=cur.LearningProgressConfig())


N_UPDATES, B, T = 5, 8, 4


def run_recipe_tool(pkg, curriculum, monkeypatch, tmp_path):
    """-> (trainer and curriculum calls, metrics records) of ``train()``'s
    tool with fakes, over ``curriculum`` ("recipe" or "heart_only")."""
    is_jax = pkg == "metta_tpu"
    mod = importlib.import_module(f"{pkg}.tools.train")
    log = []
    array = np.asarray if is_jax else torch.from_numpy
    script = Script(N_UPDATES, curriculum == "heart_only", array)

    def label(cfg):
        return (cfg.game.max_steps, cfg.game.agent.rewards.inventory["heart"])

    class FakeEnv:
        def __init__(self):
            self.compiled = types.SimpleNamespace(resource_names=["energy", "heart"])
            self.generator = torch.Generator()

        def set_weights(self, w):
            log.append(("set_weights", len(w)))

        def set_task(self, slot, cfg):
            log.append(("set_task", slot, label(cfg)))

    class FakeTrainer:
        def __init__(self, env_cfg, cfg, arch, num_envs=None, device=None, task_cfgs=None):
            if task_cfgs is not None:
                if is_jax:
                    _jax_stacks(task_cfgs)
                else:
                    from metta_tpu_torch.engine.taskset import build_task_set
                    build_task_set(task_cfgs, track_stats=False)
                log.append(("task set", [label(c) for c in task_cfgs]))
            else:
                log.append(("single", label(env_cfg)))
            self.B, self.T = B, T
            self.env = FakeEnv()
            self.generator = torch.Generator()

        def init_state(self):
            return FakeState(params=0, opt_state={}, r_bar=0.0, vstate=None)

        def state_dict(self, params):
            return {}

        def update(self, ts):
            i = script.i
            script.i += 1
            return (ts.replace(update_idx=ts.update_idx + 1, vstate=script.vstates[i]),
                    script.metrics[i])

    class FakeCheckpointManager:
        def __init__(self, run, data_dir="./train_dir"):
            pass

        def save_policy(self, params, arch, epoch, metadata=None):
            pass

        def save_trainer_state(self, ts, epoch, extras=None, generators=None):
            pass

        def load_trainer_state(self, ts_like, generators=None):
            return None, None

    if is_jax:
        monkeypatch.setattr(importlib.import_module("metta_tpu.rl.trainer"), "Trainer",
                            FakeTrainer)
        monkeypatch.setattr(importlib.import_module("metta_tpu.rl.checkpoint"),
                            "CheckpointManager", FakeCheckpointManager)
    else:
        monkeypatch.setattr(mod, "Trainer", FakeTrainer)
        monkeypatch.setattr(mod, "CheckpointManager", FakeCheckpointManager)
    tool = recipe(pkg).train()
    if curriculum == "heart_only":
        tool.with_curriculum(_heart_only(pkg))
    tool.data_dir = str(tmp_path / pkg)
    tool.trainer.total_timesteps = N_UPDATES * B * T
    tool.curriculum_interval = 2
    tool.checkpoint_interval = 0
    if not is_jax:
        tool.device = "cpu"
    tool.with_simulations(None)
    assert tool.invoke() == 0
    lines = (tmp_path / pkg / tool.run / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(s) for s in lines]
    for r in records:
        r.pop("overview/sps"), r.pop("_time")
    return log, records


@pytest.mark.parametrize("curriculum", ["recipe", "heart_only"])
def test_recipe_train_routes_like_jax(curriculum, monkeypatch, tmp_path):
    want = run_recipe_tool("metta_tpu", curriculum, monkeypatch, tmp_path)
    got = run_recipe_tool("metta_tpu_torch", curriculum, monkeypatch, tmp_path)
    assert got == want
    log = got[0]
    if curriculum == "recipe":
        # two shape classes in the pool: whole-batch swaps, the batch's task
        # rebuilt at a curriculum sync
        assert log[0][0] == "single" and not any(e[0] == "task set" for e in log)
        assert {e[1][0] for e in log if e[0] == "single"} <= {256, 512}
    else:
        assert log[0][0] == "task set" and len(log[0][1]) == 16
        assert not any(e[0] == "single" for e in log)


def test_tool_seeds_the_recipe_maps():
    """The recipe's ``MapGen`` builders have no seed; the port's tool seeds
    each task's from the trainer's seed and the task id (``_own_maps``), so a
    run's maps are a function of its seed."""
    from metta_tpu_torch.tools.train import _own_maps

    cfg = recipe("metta_tpu_torch").mettagrid()
    assert cfg.game.map_builder.seed is None
    seeded = [_own_maps(cfg, 0, task) for task in (1, 2)]
    assert cfg.game.map_builder.seed is None
    assert all(c.game.map_builder.seed is not None for c in seeded)
    assert seeded[0].game.map_builder.seed != seeded[1].game.map_builder.seed
    grids = [c.game.map_builder.create().build().grid for c in (seeded[0], _own_maps(cfg, 0, 1))]
    np.testing.assert_array_equal(*grids)
