"""Stable-job acceptance registry.

Counterpart of ``metta_tpu/devops/stable.py`` (reference
``devops/stable/runner.py:34-132`` + the ``@stable_job`` acceptance criteria
in ``recipes/prod/arena_basic_easy_shaped.py:308-334``). A stable job is a
named training run with acceptance criteria evaluated from the run's
``metrics.jsonl`` (written by ``TrainTool``); the thresholds, windows and
tool fields are the JAX package's, which are the reference's own bars.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


@dataclass(frozen=True)
class AcceptanceCriterion:
    """One metric gate (runner.py:34-38). ``window``: the criterion is
    evaluated on the mean of the metric's last ``window`` records — a single
    noisy tail value shouldn't pass or fail a multi-hour run."""

    metric: str
    threshold: float
    operator: str = ">="
    window: int = 10

    def evaluate(self, records: List[dict]) -> tuple[bool, Optional[float]]:
        vals = [r[self.metric] for r in records if self.metric in r]
        if not vals:
            return False, None
        tail = vals[-self.window:]
        v = sum(tail) / len(tail)
        return _OPS[self.operator](v, self.threshold), v


@dataclass(frozen=True)
class StableJob:
    """A registered acceptance run (runner.py:41-58, local form)."""

    name: str
    make_tool: Callable[[], object]       # () -> TrainTool
    timeout_s: int = 7200
    acceptance: tuple = ()


def read_metrics(run_dir: str | Path) -> List[dict]:
    path = Path(run_dir) / "metrics.jsonl"
    records = []
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def evaluate_acceptance(job: StableJob, run_dir: str | Path) -> dict:
    """Evaluate a job's criteria against its run dir; returns a result dict
    (checked into the repo by the stable runner as RESULTS_<job>.json)."""
    records = read_metrics(run_dir)
    results = []
    passed = True
    for crit in job.acceptance:
        ok, value = crit.evaluate(records)
        passed = passed and ok
        results.append({
            "metric": crit.metric, "operator": crit.operator,
            "threshold": crit.threshold, "value": value, "passed": ok,
        })
    return {"job": job.name, "passed": passed, "criteria": results,
            "n_records": len(records)}


# --------------------------------------------------------------------------
# registry: the reference's acceptance bars
# (recipes/prod/arena_basic_easy_shaped.py:308-334)
# --------------------------------------------------------------------------


def _train_100m():
    from metta_tpu_torch.recipes.arena_basic_easy_shaped import make_curriculum
    from metta_tpu_torch.rl.config import TrainerConfig
    from metta_tpu_torch.tools.train import TrainTool

    # reference curricula reweight continuously as episodes complete; the
    # CLI default interval (50 updates) exceeds the run's ~96 updates worth
    # of useful reweight points, so sync every 5 updates here.
    tool = TrainTool(run="stable_100m", curriculum_interval=5)
    tool.trainer = TrainerConfig(
        total_timesteps=100_000_000, track_env_stats=True,
        # reference env count: forward_pass_minibatch_target_size=4096 over
        # 24 agents -> ~170 envs (training_environment.py:52). The derived
        # default (batch/bptt/agents = 341) halves per-env episode depth —
        # with 10k-step episodes that is ~1.2 episodes/env per 100M run.
        num_envs=170,
    )
    tool.with_curriculum(make_curriculum())
    return tool


def _train_2b():
    tool = _train_100m()
    tool.run = "stable_2b"
    tool.trainer.total_timesteps = 2_000_000_000
    return tool


STABLE_JOBS: Dict[str, StableJob] = {
    "arena_100m": StableJob(
        name="arena_100m",
        make_tool=_train_100m,
        timeout_s=7200,
        acceptance=(
            # reference 1-GPU bar: sps >= 23000 (:311), measured on one L4
            AcceptanceCriterion(metric="overview/sps", threshold=23000),
            AcceptanceCriterion(metric="env_agent/heart.gained",
                                operator=">", threshold=0.1),
        ),
    ),
    "arena_2b": StableJob(
        name="arena_2b",
        make_tool=_train_2b,
        timeout_s=172800,
        acceptance=(
            # reference 16-GPU bar (:329-334) — one card must clear it outright
            AcceptanceCriterion(metric="overview/sps", threshold=80000),
            AcceptanceCriterion(metric="env_agent/heart.gained",
                                operator=">", threshold=1.0),
        ),
    ),
}


def run_stable_job(name: str, data_dir: str = "./train_dir") -> dict:
    """Run a registered job to completion and evaluate its acceptance;
    writes RESULTS_<name>.json next to the run's metrics."""
    job = STABLE_JOBS[name]
    tool = job.make_tool()
    object.__setattr__(tool, "data_dir", data_dir)
    rc = tool.invoke()
    run_dir = Path(data_dir) / tool.run
    result = evaluate_acceptance(job, run_dir)
    result["exit_code"] = rc
    (run_dir / f"RESULTS_{name}.json").write_text(json.dumps(result, indent=2))
    return result
