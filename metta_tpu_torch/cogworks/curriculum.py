"""Curriculum system (cogworks), the port's copy of ``metta_tpu/cogworks/curriculum.py``.

Host-side Python, the same code: the same seed gives the same task ids,
configs, weights and evictions (``tests/test_torch_curriculum.py``). Trimmed
to what the arena curriculum uses: the bucketed generator, the seeded pool
and both selection algorithms.

Parity: reference ``metta/cogworks/curriculum/`` — task generators (bucketed
parameter grids), a seeded task pool with eviction, and
selection algorithms: uniform random and bidirectional learning-progress
(fast/slow EMAs of task scores; LP = |fast − slow| + performance bonus,
exploration bonus for under-sampled tasks —
``learning_progress_algorithm.py``).

The curriculum is host-side (task configs are pydantic trees); the trainer
trains on its active pool as a task set (``engine/taskset.py``).
"""

from __future__ import annotations

import abc
import random
from typing import Any, Dict, List, Optional

import numpy as np
from pydantic import Field

from metta_tpu_torch.config.base import Config
from metta_tpu_torch.config.mettagrid_config import MettaGridConfig


class CurriculumTask:
    """A task instance: task id + generated env config + bookkeeping."""

    def __init__(self, task_id: int, env_cfg: MettaGridConfig,
                 slice_values: Optional[Dict[str, Any]] = None):
        self._task_id = task_id
        self._env_cfg = env_cfg
        self._slice_values = slice_values or {}
        self._num_completions = 0
        self._total_score = 0.0
        self._mean_score = 0.0
        self._num_scheduled = 0

    @property
    def task_id(self) -> int:
        return self._task_id

    def complete(self, score: float):
        self._num_completions += 1
        self._total_score += score
        self._mean_score = self._total_score / self._num_completions

    def get_env_cfg(self) -> MettaGridConfig:
        return self._env_cfg

    def get_slice_values(self) -> Dict[str, Any]:
        return self._slice_values


def _apply_override(cfg: MettaGridConfig, path: str, value: Any) -> None:
    parts = path.split(".")
    obj: Any = cfg
    for part in parts[:-1]:
        if isinstance(obj, dict):
            obj = obj[part]
        else:
            obj = getattr(obj, part)
    last = parts[-1]
    if isinstance(obj, dict):
        obj[last] = value
    else:
        object.__setattr__(obj, last, value)


# ---------------------------------------------------------------------------
# task generators
# ---------------------------------------------------------------------------


class TaskGenerator(abc.ABC):
    """Deterministically maps task ids to env configs."""

    def get_task(self, task_id: int) -> MettaGridConfig:
        rng = random.Random(task_id)
        return self._generate(task_id, rng)

    def slice_values(self, task_id: int) -> Dict[str, Any]:
        return {}

    @abc.abstractmethod
    def _generate(self, task_id: int, rng: random.Random) -> MettaGridConfig: ...


class BucketedTaskGenerator(TaskGenerator):
    """Cartesian parameter-grid tasks: each bucket is a config path with a set
    of candidate values; a task samples one value per bucket (cc.bucketed)."""

    def __init__(self, base_cfg: MettaGridConfig):
        self.base_cfg = base_cfg
        self.buckets: Dict[str, List[Any]] = {}

    def add_bucket(self, path: str, values: List[Any]) -> "BucketedTaskGenerator":
        self.buckets[path] = list(values)
        return self

    def slice_values(self, task_id: int) -> Dict[str, Any]:
        rng = random.Random(task_id)
        return {path: rng.choice(vals) for path, vals in sorted(self.buckets.items())}

    def _generate(self, task_id, rng):
        cfg = self.base_cfg.model_copy(deep=True)
        for path, value in self.slice_values(task_id).items():
            _apply_override(cfg, path, value)
        return cfg

    def to_curriculum(self, num_active_tasks: int = 16, algorithm_config=None) -> "Curriculum":
        return Curriculum(
            CurriculumConfig(num_active_tasks=num_active_tasks),
            task_generator=self,
            algorithm_config=algorithm_config,
        )


def bucketed(base_cfg: MettaGridConfig) -> BucketedTaskGenerator:
    return BucketedTaskGenerator(base_cfg)


# ---------------------------------------------------------------------------
# selection algorithms
# ---------------------------------------------------------------------------


class DiscreteRandomConfig(Config):
    type: str = "discrete_random"


class LearningProgressConfig(Config):
    type: str = "learning_progress"
    use_bidirectional: bool = True
    ema_timescale: float = 0.001
    slow_timescale_factor: float = 0.2
    exploration_bonus: float = 0.1
    progress_smoothing: float = 0.05
    lp_gain: float = 0.1
    memory: int = 25
    max_memory_tasks: int = 1000
    max_slice_axes: int = 5
    enable_detailed_slice_logging: bool = False

    def create(self) -> "LearningProgressAlgorithm":
        return LearningProgressAlgorithm(self)


class CurriculumAlgorithm(abc.ABC):
    @abc.abstractmethod
    def score_tasks(self, task_ids: List[int]) -> Dict[int, float]: ...

    def recommend_eviction(self, task_ids: List[int]) -> Optional[int]:
        return None

    def on_task_evicted(self, task_id: int) -> None:
        pass

    def update_task_performance(self, task_id: int, score: float) -> None:
        pass

    def stats(self) -> Dict[str, float]:
        return {}

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class DiscreteRandomCurriculum(CurriculumAlgorithm):
    def score_tasks(self, task_ids):
        return {t: 1.0 for t in task_ids}


class SliceAnalyzer:
    """Probability-distribution telemetry across parameter slices.

    Parity: ``metta/cogworks/curriculum/stats.py:87-359`` — tracks task
    completions per slice bin (a "slice" is one bucketed config path) and
    reports coverage / entropy / variance / underexplored-bin stats, the
    telemetry the reference uses to diagnose *which* task parameters drive
    learning progress."""

    def __init__(self, max_slice_axes: int = 3,
                 enable_detailed_logging: bool = False):
        self.max_slice_axes = max_slice_axes
        self.enable_detailed_logging = enable_detailed_logging
        self._slice_tracking: Dict[str, Dict[int, Any]] = {}
        self._slice_completion_counts: Dict[str, Dict[int, int]] = {}
        self._slice_bins: Dict[str, List[Any]] = {}
        self._slice_is_discrete: Dict[str, bool] = {}
        self._slice_history: Dict[str, List] = {}
        self._monitored: set = set()

    def _init_bins(self, name: str, sample: Any) -> None:
        # stats.py:322-341: small ints discrete, floats 10 bins, strings discrete
        if isinstance(sample, bool) or not isinstance(sample, (int, float)):
            self._slice_bins[name] = [sample]
            self._slice_is_discrete[name] = True
        elif isinstance(sample, int) and 0 <= sample < 20:
            self._slice_bins[name] = list(range(21))
            self._slice_is_discrete[name] = True
        else:
            center = float(sample)
            rng = max(abs(center), 1.0)
            self._slice_bins[name] = np.linspace(
                center - rng, center + rng, 11).tolist()
            self._slice_is_discrete[name] = False

    def _bin_index(self, name: str, value: Any) -> Optional[int]:
        bins = self._slice_bins.get(name)
        if bins is None:
            return None
        if self._slice_is_discrete[name]:
            if value in bins:
                return bins.index(value)
            bins.append(value)
            return len(bins) - 1
        edges = np.array(bins)
        idx = int(np.digitize(value, edges)) - 1
        return max(0, min(idx, len(edges) - 2))

    def update_task_completion(self, task_id: int,
                               slice_values: Dict[str, Any],
                               score: float) -> None:
        for name, value in slice_values.items():
            self._slice_tracking.setdefault(name, {})[task_id] = value
            if name not in self._slice_bins:
                self._init_bins(name, value)
            if len(self._monitored) < self.max_slice_axes:
                self._monitored.add(name)
            elif name not in self._monitored:
                continue
            b = self._bin_index(name, value)
            if b is not None:
                cc = self._slice_completion_counts.setdefault(name, {})
                cc[b] = cc.get(b, 0) + 1
                hist = self._slice_history.setdefault(name, [])
                hist.append((b, score))
                del hist[:-100]

    def get_slice_distribution_stats(self) -> Dict[str, Dict[str, float]]:
        stats = {}
        for name in sorted(self._monitored):
            cc = self._slice_completion_counts.get(name)
            if not cc:
                continue
            total = sum(cc.values())
            used = len(cc)
            n_bins = len(self._slice_bins.get(name, []))
            probs = [c / total for c in cc.values()]
            entropy = -sum(p * np.log(p + 1e-10) for p in probs if p > 0)
            vals = list(cc.values())
            mean_per_bin = total / max(1, used)
            stats[name] = {
                "total_completions": total,
                "coverage": used / max(1, n_bins),
                "mean_completions_per_bin": mean_per_bin,
                "entropy": float(entropy),
                "distribution_variance": float(np.var(vals)),
                "underexplored_bins": sum(
                    1 for c in vals if c < mean_per_bin * 0.5),
                "num_bins_used": used,
                "num_total_bins": n_bins,
            }
        return stats

    def get_underexplored_regions(self, name: str) -> List[int]:
        cc = self._slice_completion_counts.get(name)
        if not cc:
            return []
        mean = sum(cc.values()) / len(cc)
        return [b for b, c in cc.items() if c < mean * 0.3]

    def get_base_stats(self) -> Dict[str, float]:
        tracked = set(
            t for d in self._slice_tracking.values() for t in d
        )
        return {
            "total_tracked_slices": float(len(self._monitored)),
            "total_tasks_tracked": float(len(tracked)),
        }

    def remove_task(self, task_id: int) -> None:
        for d in self._slice_tracking.values():
            d.pop(task_id, None)

    def get_state(self) -> dict:
        return {
            "bins": {k: list(v) for k, v in self._slice_bins.items()},
            "discrete": dict(self._slice_is_discrete),
            "counts": {k: dict(v) for k, v in
                       self._slice_completion_counts.items()},
            "monitored": sorted(self._monitored),
        }

    def set_state(self, state: dict) -> None:
        self._slice_bins = {k: list(v) for k, v in state.get("bins", {}).items()}
        self._slice_is_discrete = dict(state.get("discrete", {}))
        self._slice_completion_counts = {
            k: {int(b): c for b, c in v.items()}
            for k, v in state.get("counts", {}).items()
        }
        self._monitored = set(state.get("monitored", []))


class LearningProgressAlgorithm(CurriculumAlgorithm):
    """Bidirectional learning progress — faithful port of the reference
    algorithm (``learning_progress_algorithm.py:52-612``):

    - per-task fast/slow EMAs of baseline-normalized outcomes (:346-382)
    - LP score = |fast − slow| + max(fast,0)·lp_gain, progress-smoothed,
      floored by the exploration bonus (:175-203)
    - per-call normalization: drop non-progress, z-score, sigmoid,
      renormalize (:531-563)
    - eviction score = same LP *without* the exploration floor, so cold /
      stale tasks lose ties (:205-220); ``should_evict_task`` gates on
      min presentations + bottom-40%% rank (:266-290)
    - integrated SliceAnalyzer telemetry (stats.py)
    """

    def __init__(self, cfg: LearningProgressConfig):
        self.cfg = cfg
        self._outcomes: Dict[int, List[float]] = {}
        self._counter: Dict[int, int] = {}
        self._fast: Dict[int, float] = {}
        self._slow: Dict[int, float] = {}
        self.slice_analyzer = SliceAnalyzer(
            max_slice_axes=cfg.max_slice_axes,
            enable_detailed_logging=cfg.enable_detailed_slice_logging,
        )

    # --- EMA update (reference :346-382) ---
    def update_task_performance(self, task_id: int, score: float) -> None:
        sr = max(0.0, min(1.0, score))
        self._outcomes.setdefault(task_id, []).append(sr)
        self._outcomes[task_id] = self._outcomes[task_id][-self.cfg.memory:]
        self._counter[task_id] = self._counter.get(task_id, 0) + 1
        normalized = (sr - 0.5) / 0.5
        if task_id not in self._fast:
            self._fast[task_id] = normalized
            self._slow[task_id] = normalized
        else:
            a = self.cfg.ema_timescale
            self._fast[task_id] += a * (normalized - self._fast[task_id])
            a_s = a * self.cfg.slow_timescale_factor
            self._slow[task_id] += a_s * (normalized - self._slow[task_id])

    def update_task_with_slice_values(self, task_id: int, score: float,
                                      slice_values: Dict[str, Any]) -> None:
        self.update_task_performance(task_id, score)
        if slice_values:
            self.slice_analyzer.update_task_completion(
                task_id, slice_values, score)

    # --- scoring (reference :175-220, :512-563) ---
    def _reweight(self, x: float) -> float:
        s = self.cfg.progress_smoothing
        num = x * (1.0 - s)
        den = x + s * (1.0 - 2.0 * x)
        if den <= 0:
            den = 1.0
        return num / den

    def _raw_lp(self, task_id: int) -> Optional[float]:
        """LP without the exploration floor; None when <2 outcomes."""
        if task_id not in self._fast or len(self._outcomes.get(task_id, ())) < 2:
            return None
        fast, slow = self._fast[task_id], self._slow[task_id]
        if self.cfg.progress_smoothing != 0.0:
            fast, slow = self._reweight(fast), self._reweight(slow)
        return abs(fast - slow) + max(fast, 0.0) * self.cfg.lp_gain

    def _lp_score(self, task_id: int) -> float:
        raw = self._raw_lp(task_id)
        if raw is None:
            return self.cfg.exploration_bonus
        return max(raw, self.cfg.exploration_bonus)

    def _eviction_score(self, task_id: int) -> float:
        raw = self._raw_lp(task_id)
        return self.cfg.exploration_bonus if raw is None else raw

    def score_tasks(self, task_ids: List[int]) -> Dict[int, float]:
        if not task_ids:
            return {}
        raw = np.array([self._lp_score(t) for t in task_ids], dtype=float)
        # drop non-progress, standardize, sigmoid, normalize (:531-563)
        pos = raw > 0
        if not np.any(pos):
            return {t: 0.0 for t in task_ids}
        sub = raw[pos]
        if sub.size > 2:
            std = np.std(sub)
            sub = (sub - np.mean(sub)) / std if std > 0 else sub - np.mean(sub)
        sub = 1.0 / (1.0 + np.exp(-np.clip(sub, -500, 500)))
        total = float(np.sum(sub))
        sub = sub / total if total > 0 else np.ones_like(sub) / len(sub)
        out = np.zeros_like(raw)
        out[pos] = sub
        return {t: float(v) for t, v in zip(task_ids, out)}

    # --- eviction (reference :254-290) ---
    def recommend_eviction(self, task_ids: List[int]) -> Optional[int]:
        if not task_ids:
            return None
        return min(task_ids, key=self._eviction_score)

    def should_evict_task(self, task_id: int,
                          min_presentations: int = 5) -> bool:
        if self._counter.get(task_id, 0) < min_presentations:
            return False
        all_ids = list(self._counter)
        if len(all_ids) <= 1:
            return False
        scores = self.score_tasks(all_ids)
        sorted_scores = sorted(scores.values())
        thr = sorted_scores[max(0, int(len(sorted_scores) * 0.4))]
        return scores.get(task_id, 0.0) <= thr

    def on_task_evicted(self, task_id: int) -> None:
        self._outcomes.pop(task_id, None)
        self._counter.pop(task_id, None)
        self._fast.pop(task_id, None)
        self._slow.pop(task_id, None)
        self.slice_analyzer.remove_task(task_id)

    def stats(self) -> Dict[str, float]:
        out = {
            "lp/num_tracked": float(len(self._outcomes)),
            "lp/mean_task_success_rate": float(np.mean([
                np.mean(v) if v else 0.0 for v in self._outcomes.values()
            ])) if self._outcomes else 0.0,
        }
        lps = [v for v in (self._raw_lp(t) for t in self._outcomes)
               if v is not None]
        out["lp/mean_learning_progress"] = float(np.mean(lps)) if lps else 0.0
        for k, v in self.slice_analyzer.get_base_stats().items():
            out[f"slice/{k}"] = v
        for name, st in self.slice_analyzer.get_slice_distribution_stats().items():
            short = name.rsplit(".", 1)[-1]
            for k in ("coverage", "entropy", "underexplored_bins"):
                out[f"slice/{short}/{k}"] = float(st[k])
        return out

    def get_state(self) -> dict:
        return {
            "outcomes": {k: list(v) for k, v in self._outcomes.items()},
            "counter": dict(self._counter),
            "fast": dict(self._fast),
            "slow": dict(self._slow),
            "slices": self.slice_analyzer.get_state(),
        }

    def set_state(self, state: dict) -> None:
        self._outcomes = {int(k): list(v)
                          for k, v in state.get("outcomes", {}).items()}
        self._counter = {int(k): v for k, v in state.get("counter", {}).items()}
        self._fast = {int(k): v for k, v in state.get("fast", {}).items()}
        self._slow = {int(k): v for k, v in state.get("slow", {}).items()}
        if not self._fast or not self._slow or not self._outcomes:
            self._outcomes, self._counter = {}, {}
            self._fast, self._slow = {}, {}
        self.slice_analyzer.set_state(state.get("slices", {}))


# ---------------------------------------------------------------------------
# curriculum
# ---------------------------------------------------------------------------


class CurriculumConfig(Config):
    num_active_tasks: int = Field(default=16, gt=0)
    max_task_id: int = Field(default=1_000_000)
    seed: int = 0


class Curriculum:
    """Seeded task pool + algorithm-driven selection (curriculum.py:24-80)."""

    def __init__(
        self,
        cfg: CurriculumConfig,
        task_generator: TaskGenerator,
        algorithm_config=None,
    ):
        self.cfg = cfg
        self.task_generator = task_generator
        if algorithm_config is None:
            self.algorithm: CurriculumAlgorithm = DiscreteRandomCurriculum()
        elif isinstance(algorithm_config, LearningProgressConfig):
            self.algorithm = algorithm_config.create()
        elif isinstance(algorithm_config, DiscreteRandomConfig):
            self.algorithm = DiscreteRandomCurriculum()
        else:
            self.algorithm = algorithm_config
        self._rng = random.Random(cfg.seed)
        self._tasks: Dict[int, CurriculumTask] = {}

    def _spawn_task(self) -> CurriculumTask:
        task_id = self._rng.randrange(self.cfg.max_task_id)
        env_cfg = self.task_generator.get_task(task_id)
        task = CurriculumTask(task_id, env_cfg, self.task_generator.slice_values(task_id))
        self._tasks[task_id] = task
        return task

    def get_task(self) -> CurriculumTask:
        while len(self._tasks) < self.cfg.num_active_tasks:
            self._spawn_task()
        ids = list(self._tasks)
        scores = self.algorithm.score_tasks(ids)
        weights = [max(scores.get(t, 0.0), 1e-9) for t in ids]
        chosen = self._rng.choices(ids, weights=weights)[0]
        task = self._tasks[chosen]
        task._num_scheduled += 1
        return task

    def active_tasks(self) -> List[CurriculumTask]:
        """The full active pool (fills to num_active_tasks). Used by the
        multi-task trainer path, which samples per env per episode on-device
        (CurriculumEnv parity — engine/taskset.py)."""
        while len(self._tasks) < self.cfg.num_active_tasks:
            self._spawn_task()
        return list(self._tasks.values())

    def task_weights(self, task_ids: List[int]) -> List[float]:
        """Sampling weights for the given tasks (algorithm scores)."""
        scores = self.algorithm.score_tasks(task_ids)
        return [max(scores.get(t, 0.0), 1e-9) for t in task_ids]

    def update_task_performance(self, task_id: int, score: float) -> None:
        task = self._tasks.get(task_id)
        if task is not None:
            task.complete(score)
        sv = task.get_slice_values() if task is not None else None
        if sv and hasattr(self.algorithm, "update_task_with_slice_values"):
            self.algorithm.update_task_with_slice_values(task_id, score, sv)
        else:
            self.algorithm.update_task_performance(task_id, score)
        # eviction when pool over capacity
        if len(self._tasks) > self.cfg.num_active_tasks:
            evict = self.algorithm.recommend_eviction(list(self._tasks))
            if evict is None:
                evict = self._rng.choice(list(self._tasks))
            self._tasks.pop(evict, None)
            self.algorithm.on_task_evicted(evict)

    def stats(self) -> Dict[str, float]:
        base = {
            "curriculum/num_tasks": float(len(self._tasks)),
            "curriculum/mean_score": float(
                np.mean([t._mean_score for t in self._tasks.values() if t._num_completions])
                if any(t._num_completions for t in self._tasks.values()) else 0.0
            ),
        }
        base.update(self.algorithm.stats())
        return base

    def get_state(self) -> dict:
        return {
            "rng": self._rng.getstate(),
            "task_ids": list(self._tasks),
            "algorithm": self.algorithm.get_state(),
        }

    def set_state(self, state: dict) -> None:
        self._rng.setstate(tuple(
            tuple(x) if isinstance(x, list) else x for x in state["rng"]
        ))
        self._tasks = {}
        for task_id in state["task_ids"]:
            env_cfg = self.task_generator.get_task(task_id)
            self._tasks[task_id] = CurriculumTask(
                task_id, env_cfg, self.task_generator.slice_values(task_id)
            )
        self.algorithm.set_state(state.get("algorithm", {}))
