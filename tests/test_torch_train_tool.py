"""The port's training entry point against the JAX package's, on the CPU.

- The tool's logic: both ``TrainTool.invoke``s (``metta_tpu/tools/train.py``
  unchanged, ``metta_tpu_torch/tools/train.py``), each with its package's
  ``Trainer`` and ``CheckpointManager`` replaced by the same fakes, fed one
  numpy-seeded script of per-update metrics and env fields and one scripted
  curriculum that evicts a task: the same ``metrics.jsonl`` record by record
  (``_time`` left out; ``overview/sps`` present and positive), the same
  curriculum calls, the same checkpoint epochs and the same abort and
  watchdog stops. On a tracked set the JAX env refuses the evicted slot's
  new task (it compiles it untracked) and the port's takes it: the one
  documented difference, checked as such. No JAX compile runs.
- The port end to end at a tiny size, with the ``"lstm"`` and the
  ``"Ag,A,S"`` core: 2 updates and a resume for 2 more equal 4
  uninterrupted updates bit for bit (every leaf of the trainer state, both
  generators, the ``losses/*`` records).
- The trainer state's round trip for both core trees, a corrupt state (a
  warning, a fresh start) and the JAX package's state (refused by name).
- Recovery: the abort file, the watchdog, and a SIGKILL then resume.
- ``STABLE_JOBS``, ``evaluate_acceptance`` and the recipes against the JAX
  package's; the CLI; the refusals.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Any

import numpy as np
import pytest
import torch

import metta_tpu.rl.checkpoint as jax_ckpt
import metta_tpu.rl.trainer as jax_trainer_mod
from metta_tpu.builder.envs import make_navigation as jax_make_navigation
from metta_tpu.devops import stable as jax_stable
from metta_tpu.rl.config import TrainerConfig as JaxTrainerConfig
from metta_tpu.tools import train as jax_train
from metta_tpu_torch.builder.envs import make_navigation
from metta_tpu_torch.devops import stable
from metta_tpu_torch.rl import checkpoint as ckpt
from metta_tpu_torch.rl.config import TrainerConfig
from metta_tpu_torch.rl.trainer import Trainer
from metta_tpu_torch.tools import train as port_train
from metta_tpu_torch.tools.tool import apply_overrides, cli_entry, load_tool
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
E, A, R, K = 4, 2, 3, 4          # scripted envs, agents, resources, tasks
B, T = E * A, 4                   # the fake trainer's batch: 32 agent-steps an update
RESOURCES = ["ore_red", "heart", "laser"]

# ---------------------------------------------------------------------------
# the tool's logic against the JAX package's, on fakes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FakeState:
    params: Any
    opt_state: Any
    r_bar: Any
    vstate: Any
    update_idx: int = 0

    def replace(self, **kw):                       # flax struct's method
        return dataclasses.replace(self, **kw)


class Script:
    """Per-update metrics and env fields drawn from one seed; ``array``
    makes each field an array of the package under test."""

    def __init__(self, n, multi_task, array, seed=0):
        rng = np.random.default_rng(seed)
        names = ("policy_loss", "value_loss", "entropy", "approx_kl", "clipfrac",
                 "reward_mean", "r_bar", "value_mean")
        self.metrics = [{k: np.float32(rng.normal()) for k in names} for _ in range(n)]
        done = np.cumsum(rng.integers(0, 2, (n, E)), axis=0).astype(np.int32)
        fields = dict(
            episode_len=rng.integers(0, 5, (n, E)).astype(np.int32),
            last_episode_reward=rng.normal(size=(n, E, A)).astype(np.float32),
            last_episode_gained=rng.random((n, E, R)).astype(np.float32),
        )
        if multi_task:
            fields.update(episodes_done=done,
                          last_episode_task=rng.integers(0, K, (n, E)).astype(np.int32))
        self.vstates = [types.SimpleNamespace(**{k: array(v[i]) for k, v in fields.items()})
                        for i in range(n)]
        self.i = 0
        self.clock = types.SimpleNamespace(now=1000.0)
        self.clock.time = lambda: self.clock.now
        self.hours_per_update = 0.0
        self.abort_at = None            # (update, path): the fake writes the abort file


class FakeCfg:
    """A task's config: its id, and a map builder with no seed."""

    def __init__(self, task_id):
        self.task_id = task_id
        self.game = types.SimpleNamespace(map_builder=types.SimpleNamespace(seed=None))

    def model_copy(self, deep):
        return FakeCfg(self.task_id)


class FakeTask:
    def __init__(self, task_id):
        self.task_id = task_id

    def get_env_cfg(self):
        return FakeCfg(self.task_id)


class FakeCurriculum:
    """Four active tasks; after ``evict_after`` scores the task in position 1
    leaves the pool and task 10 joins it. ``get_task`` cycles the pool."""

    def __init__(self, log, evict_after=3):
        self.active = [FakeTask(i) for i in range(K)]
        self.log, self.evict_after, self.n, self.picks = log, evict_after, 0, 0

    def active_tasks(self):
        return list(self.active)

    def task_weights(self, ids):
        self.log.append(("task_weights", list(ids)))
        return [1.0 / (1 + i % 7) for i in ids]

    def update_task_performance(self, task_id, score):
        self.log.append(("perf", task_id, score))
        self.n += 1
        if self.n == self.evict_after:
            self.active.pop(1)
            self.active.append(FakeTask(10))

    def get_task(self):
        self.picks += 1
        return self.active[self.picks % len(self.active)]


def fakes(script, log, cm_log, refuse_tracked, heterogeneous, resume):
    """(Trainer, CheckpointManager) classes for one package's tool."""

    class FakeEnv:
        def __init__(self, tracked):
            self.compiled = types.SimpleNamespace(resource_names=RESOURCES)
            self.generator = torch.Generator()
            self.tracked = tracked

        def set_weights(self, w):
            log.append(("set_weights", [float(x) for x in np.asarray(w)]))

        def set_task(self, slot, cfg):
            if self.tracked and refuse_tracked:
                log.append(("set_task refused", slot, cfg.task_id))
                raise ValueError("the slot's tables do not stack")
            log.append(("set_task", slot, cfg.task_id))

    class FakeTrainer:
        def __init__(self, env_cfg, cfg, arch, num_envs=None, device=None, task_cfgs=None):
            if task_cfgs is not None and heterogeneous:
                raise ValueError("two shape classes")
            log.append(("trainer", [c.task_id for c in task_cfgs] if task_cfgs is not None
                        else getattr(env_cfg, "task_id", "env")))
            self.B, self.T = B, T
            self.env = FakeEnv(cfg.track_env_stats)
            self.generator = torch.Generator()

        def init_state(self):
            return FakeState(params=0, opt_state={}, r_bar=0.0, vstate=None)

        def state_dict(self, params):
            return {}

        def update(self, ts):
            i = script.i
            script.i += 1
            script.clock.now += 1.0 + 3600.0 * script.hours_per_update
            if script.abort_at is not None and script.abort_at[0] == i:
                Path(script.abort_at[1]).write_text("stop")
            return (ts.replace(update_idx=ts.update_idx + 1, vstate=script.vstates[i]),
                    script.metrics[i])

    class FakeCheckpointManager:
        def __init__(self, run, data_dir="./train_dir"):
            pass

        def save_policy(self, params, arch, epoch, metadata=None):
            cm_log.append(("policy", epoch))

        def save_trainer_state(self, ts, epoch, extras=None, generators=None):
            cm_log.append(("state", epoch, dict(extras or {})))

        def load_trainer_state(self, ts_like, generators=None):
            if not resume:
                return None, None
            return ts_like.replace(update_idx=2), {"epoch": 2, "extras": {"agent_steps": 2 * B * T}}

    return FakeTrainer, FakeCheckpointManager


CASES = {
    # name: (curriculum, track_env_stats, heterogeneous, log_interval, resume)
    "single": (False, True, False, 1, False),
    "curriculum": (True, False, False, 1, False),
    "curriculum_tracked": (True, True, False, 1, False),
    "fallback": (True, True, True, 1, False),
    "log_interval_2": (True, True, False, 2, True),
}
N_UPDATES = 7


def run_fake_tool(pkg, case, tmp_path, monkeypatch, abort=False, watchdog=False):
    """-> (metrics records, curriculum and env calls, checkpoint calls, updates run)."""
    multi, tracked, hetero, log_interval, resume = CASES[case]
    is_jax = pkg == "jax"
    array = np.asarray if is_jax else torch.from_numpy
    script = Script(N_UPDATES, multi and not hetero, array)
    log, cm_log = [], []
    FakeTrainer, FakeCM = fakes(script, log, cm_log, refuse_tracked=is_jax,
                                heterogeneous=hetero, resume=resume)
    mod = jax_train if is_jax else port_train
    monkeypatch.setattr(mod, "time", script.clock)
    if is_jax:
        monkeypatch.setattr(jax_trainer_mod, "Trainer", FakeTrainer)
        monkeypatch.setattr(jax_ckpt, "CheckpointManager", FakeCM)
        cfg = JaxTrainerConfig(total_timesteps=N_UPDATES * B * T, track_env_stats=tracked)
        env = jax_make_navigation()
    else:
        monkeypatch.setattr(port_train, "Trainer", FakeTrainer)
        monkeypatch.setattr(port_train, "CheckpointManager", FakeCM)
        cfg = TrainerConfig(total_timesteps=N_UPDATES * B * T, track_env_stats=tracked)
        env = make_navigation()
    kw = dict(run=case, data_dir=str(tmp_path / pkg), trainer=cfg, checkpoint_interval=2,
              curriculum_interval=2, log_interval=log_interval)
    if abort:
        kw.update(abort_file=str(tmp_path / f"ABORT_{pkg}"), abort_check_interval=3)
        script.abort_at = (1, kw["abort_file"])
    if watchdog:
        kw.update(max_runtime_hrs=2.5)
        script.hours_per_update = 1.0
    if not is_jax:
        kw["device"] = "cpu"
    tool = mod.TrainTool(env=None if multi else env, **kw)
    if multi:
        tool.with_curriculum(FakeCurriculum(log))
    assert tool.invoke() == 0
    lines = (tmp_path / pkg / case / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(s) for s in lines]
    for r in records:
        assert r.pop("overview/sps") > 0
        r.pop("_time")
    return records, log, cm_log, script.i


def untracked_swap(jax_log):
    """The JAX tool's calls as the port's on a tracked set: the first
    refused ``set_task`` taken, later retries gone, and the new task (10) in
    the evicted task's slot (1) from then on."""
    out, swapped = [], None
    for entry in jax_log:
        if entry[0] == "set_task refused":
            if swapped is None:
                swapped = entry[1:]
                out.append(("set_task", *swapped))
            continue
        if swapped is not None:
            slot, new = swapped
            if entry[0] == "perf" and entry[1] == 1:
                entry = ("perf", new, entry[2])
            elif entry[0] == "task_weights":
                entry = ("task_weights", [new if i == 1 else i for i in entry[1]])
            elif entry[0] == "set_weights":
                w = list(entry[1])
                w[slot] = 1.0 / (1 + new % 7)
                entry = ("set_weights", w)
        out.append(entry)
    assert swapped == (1, 10), "the scripted eviction never reached set_task"
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_logic_matches_jax(case, tmp_path, monkeypatch):
    got_j = run_fake_tool("jax", case, tmp_path, monkeypatch)
    got_p = run_fake_tool("port", case, tmp_path, monkeypatch)
    records_j, log_j, cm_j, n_j = got_j
    records_p, log_p, cm_p, n_p = got_p
    assert records_p == records_j
    assert len(records_p) == (N_UPDATES - 2 * CASES[case][4]) // CASES[case][3]
    assert any(k.startswith("losses/") for k in records_p[0])
    if CASES[case][1]:
        assert any(k == "env_agent/heart.gained" for r in records_p for k in r)
    assert cm_p == cm_j and ("state", N_UPDATES, {"agent_steps": N_UPDATES * B * T}) in cm_p
    assert n_p == n_j
    multi, tracked, hetero = CASES[case][:3]
    if multi and tracked and not hetero:
        assert log_p == untracked_swap(log_j)
    else:
        assert log_p == log_j
    if case == "curriculum":
        assert ("set_task", 1, 10) in log_p
    if case == "fallback":
        assert sum(1 for e in log_p if e[0] == "trainer") > 1    # the batch's task swapped


@pytest.mark.parametrize("stop", ["abort", "watchdog"])
def test_tool_stops_match_jax(stop, tmp_path, monkeypatch):
    kw = {stop: True}
    got_j = run_fake_tool("jax", "curriculum", tmp_path, monkeypatch, **kw)
    got_p = run_fake_tool("port", "curriculum", tmp_path, monkeypatch, **kw)
    assert got_p == got_j
    assert got_p[3] == 3 < N_UPDATES                                 # stopped early


# ---------------------------------------------------------------------------
# the port end to end: resume equals the uninterrupted run
# ---------------------------------------------------------------------------

TINY_POLICY = dict(latent_dim=16, actor_hidden=16, critic_hidden=16, max_tokens=16,
                   core_num_latents=2, core_num_heads=2)


def tiny_tool(tmp_path, run, core="lstm", updates=2, **kw):
    env = make_navigation(num_agents=2, width=8, height=8)
    env.game.max_steps = 12           # episodes end and reset inside 4 updates
    return port_train.TrainTool(
        run=run, data_dir=str(tmp_path), env=env, device="cpu",
        trainer=TrainerConfig(batch_size=2 * 2 * 8, minibatch_size=2 * 8, bptt_horizon=8,
                              num_envs=2, total_timesteps=10_000_000, track_env_stats=True),
        policy=port_train.PolicyConfig(core=core, **TINY_POLICY),
        total_timesteps=updates * 32, checkpoint_interval=1, **kw)


def losses(run_dir):
    lines = (Path(run_dir) / "metrics.jsonl").read_text().splitlines()
    return [{k: v for k, v in json.loads(s).items() if k.startswith("losses/")} for s in lines]


@pytest.mark.parametrize("core", ["lstm", "Ag,A,S"])
def test_resume_equals_uninterrupted(core, tmp_path, caplog):
    assert tiny_tool(tmp_path, "whole", core, updates=4).invoke() == 0
    assert tiny_tool(tmp_path, "split", core, updates=2).invoke() == 0
    with caplog.at_level(logging.INFO, logger="metta_tpu_torch.tools.train"):
        assert tiny_tool(tmp_path, "split", core, updates=4).invoke() == 0
    assert "resumed from update 2" in caplog.text
    whole, split = (ckpt.read_safetensors(tmp_path / r / "checkpoints" / ckpt.STATE_FILE)
                    for r in ("whole", "split"))
    assert sorted(whole) == sorted(split)
    assert {"generator/trainer", "generator/env", "params", "r_bar", "update_idx"} <= set(whole)
    assert any(k.startswith("core/") for k in whole) and any(k.startswith("vstate/env/")
                                                             for k in whole)
    for k in whole:
        assert whole[k].dtype == split[k].dtype and torch.equal(whole[k], split[k]), k
    assert int(whole["update_idx"]) == 4
    assert losses(tmp_path / "whole") == losses(tmp_path / "split") and len(losses(tmp_path / "whole")) == 4
    cm = ckpt.CheckpointManager("split", tmp_path)
    assert [e for e, _ in cm.list_policies()] == [1, 2, 3, 4]
    assert cm.latest_policy_uri().endswith("split:v4")
    sd, cfg, spec = cm.load_policy()
    assert cfg.core == core and spec["epoch"] == 4 and sd


# ---------------------------------------------------------------------------
# the trainer state's round trip
# ---------------------------------------------------------------------------


def tiny_trainer(core):
    env = make_navigation(num_agents=2, width=8, height=8)
    env.game.map_builder.seed = 5       # both trainers on one map, as the tool's runs
    arch = port_train.PolicyConfig(core=core, **TINY_POLICY).to_arch()
    return Trainer(env, TrainerConfig(batch_size=32, minibatch_size=16, bptt_horizon=8,
                                      num_envs=2), arch, device="cpu")


@pytest.mark.parametrize("core", ["lstm", "Ag,A,S"])
def test_trainer_state_round_trip(core, tmp_path):
    tr = tiny_trainer(core)
    ts, _ = tr.update(tr.init_state())
    gens = {"trainer": tr.generator, "env": tr.env.generator}
    cm = ckpt.CheckpointManager("rt", tmp_path)
    cm.save_trainer_state(ts, 1, extras={"agent_steps": 32}, generators=gens)
    want = {k: g.get_state() for k, g in gens.items()}
    tr2 = tiny_trainer(core)
    like = tr2.init_state()
    gens2 = {"trainer": tr2.generator.manual_seed(99), "env": tr2.env.generator.manual_seed(98)}
    got, meta = cm.load_trainer_state(like, generators=gens2)
    assert meta == {"epoch": 1, "extras": {"agent_steps": 32}}
    assert isinstance(got.core, tuple if core == "lstm" else dict) and got.update_idx == 1
    flat_got, flat_want = ckpt.flatten_state(got), ckpt.flatten_state(ts)
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype and torch.equal(flat_got[k], v), k
    for k, g in gens2.items():
        assert torch.equal(g.get_state(), want[k]), k
    # the restored state draws what the saved one would
    a, _ = tr.update(ts)
    b, _ = tr2.update(got)
    assert torch.equal(a.params, b.params)


def test_corrupt_state_starts_fresh(tmp_path, caplog):
    tr = tiny_trainer("lstm")
    ts = tr.init_state()
    cm = ckpt.CheckpointManager("bad", tmp_path)
    cm.save_trainer_state(ts, 3)
    path = cm.checkpoint_dir / ckpt.STATE_FILE
    path.write_bytes(path.read_bytes()[:100])               # truncated mid-write
    with caplog.at_level(logging.WARNING):
        assert cm.load_trainer_state(ts) == (None, None)
    assert "unreadable" in caplog.text and "starting fresh" in caplog.text
    cm.save_trainer_state(ts, 3)
    like = tiny_trainer("Ag,A,S").init_state()                # another tree
    assert cm.load_trainer_state(like) == (None, None)


def test_torn_save_starts_fresh(tmp_path, caplog):
    """A kill between the state's rename and the meta's: the new state stands
    beside the previous meta, and neither is trusted."""
    tr = tiny_trainer("lstm")
    ts = tr.init_state()
    gens = {"trainer": tr.generator, "env": tr.env.generator}
    cm = ckpt.CheckpointManager("torn", tmp_path)
    cm.save_trainer_state(ts, 2, generators=gens)
    meta = (cm.checkpoint_dir / ckpt.META_FILE).read_text()
    cm.save_trainer_state(dataclasses.replace(ts, update_idx=3), 3, generators=gens)
    (cm.checkpoint_dir / ckpt.META_FILE).write_text(meta)
    fresh = tiny_trainer("lstm")
    gens2 = {"trainer": fresh.generator, "env": fresh.env.generator}
    like = fresh.init_state()
    before = {k: g.get_state() for k, g in gens2.items()}
    with caplog.at_level(logging.WARNING):
        assert cm.load_trainer_state(like, generators=gens2) == (None, None)
    assert "the state is of epoch 3, the meta of 2" in caplog.text
    assert all(torch.equal(g.get_state(), before[k]) for k, g in gens2.items())


def test_jax_trainer_state_is_refused(tmp_path):
    cm = ckpt.CheckpointManager("jax", tmp_path)
    assert cm.load_trainer_state(None) == (None, None)      # nothing saved
    (cm.checkpoint_dir / "trainer_state.bin").write_bytes(b"\x80")
    with pytest.raises(RuntimeError, match="trainer_state.bin"):
        cm.load_trainer_state(None)


def test_resolve_uri():
    assert ckpt.resolve_uri("file:///a/b") == Path("/a/b") == ckpt.resolve_uri("/a/b")
    with pytest.raises(ValueError, match="s3"):
        ckpt.resolve_uri("s3://bucket/x")


# ---------------------------------------------------------------------------
# recovery: abort file, watchdog, SIGKILL then resume
# ---------------------------------------------------------------------------


def test_abort_file_and_watchdog_stop(tmp_path):
    abort = tmp_path / "ABORT"
    abort.write_text("stop")
    tool = tiny_tool(tmp_path, "abort", updates=1000, abort_file=str(abort))
    assert tool.invoke() == 0
    tool = tiny_tool(tmp_path, "watchdog", updates=1000, max_runtime_hrs=1e-9)
    assert tool.invoke() == 0
    for run in ("abort", "watchdog"):
        cm = ckpt.CheckpointManager(run, tmp_path)
        assert [e for e, _ in cm.list_policies()] == [0]     # stopped before an update


WORKER = r"""
import logging
logging.basicConfig(level=logging.INFO)
from metta_tpu_torch.builder.envs import make_navigation
from metta_tpu_torch.rl.config import TrainerConfig
from metta_tpu_torch.tools.train import PolicyConfig, TrainTool

raise SystemExit(TrainTool(
    run="killtest", data_dir={data_dir!r}, device="cpu",
    env=make_navigation(num_agents=2, width=8, height=8),
    trainer=TrainerConfig(batch_size=32, minibatch_size=16, bptt_horizon=8, num_envs=2),
    policy=PolicyConfig(core="lstm", **{policy!r}),
    total_timesteps={updates} * 32, checkpoint_interval=1,
).invoke())
"""


def test_resume_after_sigkill(tmp_path):
    state = tmp_path / "killtest" / "checkpoints" / ckpt.META_FILE
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    src = dict(data_dir=str(tmp_path), policy=TINY_POLICY)
    p = subprocess.Popen([sys.executable, "-c", WORKER.format(updates=100_000, **src)],
                         env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while not state.exists():
            assert p.poll() is None, "worker exited before its first checkpoint"
            assert time.time() < deadline, "no checkpoint within 120 s"
            time.sleep(0.2)
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    done = json.loads(state.read_text())["epoch"]
    out = subprocess.run([sys.executable, "-c", WORKER.format(updates=done + 1, **src)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"resumed from update {done}" in out.stderr
    assert json.loads(state.read_text())["epoch"] == done + 1


# ---------------------------------------------------------------------------
# the registry, the recipes, the CLI and the refusals
# ---------------------------------------------------------------------------


def _dump(cfg):
    d = cfg.model_dump()
    d["game"]["map_builder"]["type"] = d["game"]["map_builder"]["type"].rsplit(".", 1)[-1]
    return d


def _port_fields_match(port: dict, jax: dict, jax_default: dict, path=""):
    """Every field the port has equals the JAX package's; every JAX field
    the port lacks is at the JAX default (the job does not set it)."""
    for k, v in jax.items():
        where = f"{path}.{k}"
        if k not in port:
            assert v == jax_default[k], where
        elif isinstance(v, dict) and isinstance(port[k], dict):
            _port_fields_match(port[k], v, jax_default[k], where)
        else:
            assert port[k] == v, where
    assert set(port) <= set(jax), sorted(set(port) - set(jax))


def test_stable_jobs_match_jax(tmp_path):
    assert sorted(stable.STABLE_JOBS) == sorted(jax_stable.STABLE_JOBS)
    for name, job in stable.STABLE_JOBS.items():
        jjob = jax_stable.STABLE_JOBS[name]
        assert (job.name, job.timeout_s) == (jjob.name, jjob.timeout_s)
        assert [dataclasses.asdict(c) for c in job.acceptance] == \
            [dataclasses.asdict(c) for c in jjob.acceptance]
        tool, jtool = job.make_tool(), jjob.make_tool()
        assert set(port_train.TrainTool.model_fields) == set(jax_train.TrainTool.model_fields)
        for field in port_train.TrainTool.model_fields:
            if field in ("trainer", "policy", "env"):
                continue
            assert getattr(tool, field) == getattr(jtool, field), field
        assert tool.env is None and jtool.env is None
        assert tool.policy.model_dump() == jtool.policy.model_dump()
        _port_fields_match(tool.trainer.model_dump(), jtool.trainer.model_dump(),
                           JaxTrainerConfig().model_dump())
        tasks, jtasks = tool._curriculum.active_tasks(), jtool._curriculum.active_tasks()
        assert [t.task_id for t in tasks] == [t.task_id for t in jtasks]
        assert [_dump(t.get_env_cfg()) for t in tasks] == \
            [_dump(t.get_env_cfg()) for t in jtasks]
    tool = stable.STABLE_JOBS["arena_100m"].make_tool()
    assert (tool.trainer.num_envs, tool.trainer.track_env_stats, tool.curriculum_interval,
            tool.trainer.total_timesteps, tool.policy.core) == \
        (170, True, 5, 100_000_000, "Ag,A,S")

    rng = np.random.default_rng(0)
    lines = [json.dumps({"overview/sps": float(rng.uniform(1e4, 1e5)),
                         **({"env_agent/heart.gained": float(rng.random())} if i % 3 else {})})
             for i in range(25)] + ["not json"]
    (tmp_path / "metrics.jsonl").write_text("\n".join(lines) + "\n")
    for name in stable.STABLE_JOBS:
        got = stable.evaluate_acceptance(stable.STABLE_JOBS[name], tmp_path)
        assert got == jax_stable.evaluate_acceptance(jax_stable.STABLE_JOBS[name], tmp_path)
        assert got["n_records"] == 25
    assert stable.evaluate_acceptance(stable.STABLE_JOBS["arena_100m"], tmp_path / "none") == \
        jax_stable.evaluate_acceptance(jax_stable.STABLE_JOBS["arena_100m"], tmp_path / "none")


def test_recipes_match_jax():
    from metta_tpu_torch.recipes import arena_basic_easy_shaped as arena
    from metta_tpu_torch.recipes import navigation
    from recipes import arena_basic_easy_shaped as jax_arena
    from recipes import navigation as jax_navigation

    assert _dump(arena.mettagrid()) == _dump(jax_arena.mettagrid())
    tasks, jtasks = arena.make_curriculum().active_tasks(), jax_arena.make_curriculum().active_tasks()
    assert [_dump(t.get_env_cfg()) for t in tasks] == [_dump(t.get_env_cfg()) for t in jtasks]
    for fn in ("train", "train_single_task"):
        tool, jtool = getattr(arena, fn)(), getattr(jax_arena, fn)()
        assert (tool.run, tool.env is None) == (jtool.run, jtool.env is None)
        assert (tool._curriculum is None) == (jtool._curriculum is None)
    tool, jtool = navigation.train(), jax_navigation.train()
    assert _dump(tool.env) == _dump(jtool.env) and tool.run == jtool.run
    _port_fields_match(tool.trainer.model_dump(), jtool.trainer.model_dump(),
                       JaxTrainerConfig().model_dump())


def test_cli_runs_the_navigation_recipe(tmp_path):
    tool = load_tool("metta_tpu_torch.recipes.navigation.train")
    assert tool.run == "navigation" and tool.device is None         # default: the card
    apply_overrides(tool, ["run=custom", "trainer.bptt_horizon=8", "checkpoint_interval=2"])
    assert (tool.run, tool.trainer.bptt_horizon, tool.checkpoint_interval) == ("custom", 8, 2)
    args = ["metta_tpu_torch.recipes.navigation.train", "device=cpu", "run=cli",
            f"data_dir={tmp_path}", "trainer.num_envs=2", "trainer.bptt_horizon=8",
            "trainer.batch_size=64", "trainer.minibatch_size=16", "total_timesteps=64",
            "policy.core=lstm"] + [f"policy.{k}={v}" for k, v in TINY_POLICY.items()]
    out = subprocess.run([sys.executable, "-m", "metta_tpu_torch.tools.run", *args],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "overview/sps" in out.stderr
    assert [e for e, _ in ckpt.CheckpointManager("cli", tmp_path).list_policies()] == [1]
    assert cli_entry([]) == 2


def test_refusals(tmp_path):
    from metta_tpu_torch.tools.play import PlayTool

    with pytest.raises(NotImplementedError, match="renderer/live_server.py"):
        PlayTool(serve=True, device="cpu").invoke()
    if not torch.cuda.is_available():
        tool = tiny_tool(tmp_path, "nocard")
        tool.device = None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.invoke()


def test_run_arena_100m_script(tmp_path, monkeypatch):
    from metta_tpu_torch.scripts import run_arena_100m

    job = stable.STABLE_JOBS["arena_100m"]

    monkeypatch.setitem(stable.STABLE_JOBS, "arena_100m", dataclasses.replace(
        job, make_tool=lambda: tiny_tool(tmp_path, "stable_100m", updates=1)))
    out = tmp_path / "out"
    result = run_arena_100m.main(["--data-dir", str(tmp_path), "--out", str(out), "--seed", "3"])
    assert result["exit_code"] == 0 and result["seed"] == 3 and result["n_records"] == 1
    assert json.loads((out / "RESULTS_arena_100m.json").read_text()) == result
    assert (out / "metrics.jsonl").exists()


def test_run_arena_100m_stops_at_its_budget_and_resumes(tmp_path, monkeypatch, caplog):
    """``--max-minutes`` ends the run with the trainer state saved (the tool's
    own checkpoints are 30 updates apart), and the next run of the script
    resumes from it. The tool's clock moves a minute a reading, so a budget
    of 1.5 minutes lets exactly one update start."""
    from metta_tpu_torch.scripts import run_arena_100m

    def make_tool():
        tool = tiny_tool(tmp_path, "stable_100m", updates=1000)
        tool.checkpoint_interval = 30
        return tool

    job = stable.STABLE_JOBS["arena_100m"]
    monkeypatch.setitem(stable.STABLE_JOBS, "arena_100m", dataclasses.replace(
        job, make_tool=make_tool))
    clock = iter(range(0, 10**6, 60))
    monkeypatch.setattr(port_train, "time", types.SimpleNamespace(time=lambda: next(clock)))
    argv = ["--data-dir", str(tmp_path), "--out", str(tmp_path / "out"), "--max-minutes", "1.5"]
    with caplog.at_level(logging.INFO, logger="metta_tpu_torch.tools.train"):
        assert run_arena_100m.main(argv)["n_records"] == 1
        assert "max_runtime_hrs" in caplog.text and "resumed" not in caplog.text
        assert run_arena_100m.main(argv)["n_records"] == 2
    assert "resumed from update 1" in caplog.text
    cm = ckpt.CheckpointManager("stable_100m", tmp_path)
    assert [e for e, _ in cm.list_policies()] == [1, 2]
    assert json.loads((cm.checkpoint_dir / ckpt.META_FILE).read_text())["epoch"] == 2
