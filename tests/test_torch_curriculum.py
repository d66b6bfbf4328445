"""The port's curriculum copy against ``metta_tpu.cogworks.curriculum``.

The arena curriculum (each package's own ``make_curriculum`` over its
shaped arena) with one seed must give the same active pool (task ids, slice
values and env configs, whose dumps differ only in the map builder's module
path), and, fed the same scores, the same learning-progress weights (exact:
the same float operations in the same order), the same ``get_task`` picks,
the same eviction when the pool overflows, the same statistics and the same
saved state.
"""

import numpy as np

from metta_tpu.cogworks import curriculum as jax_cur
from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped, make_curriculum
from metta_tpu_torch.cogworks import curriculum as cur
from recipes.arena_basic_easy_shaped import make_curriculum as jax_make_curriculum
from recipes.arena_basic_easy_shaped import mettagrid as jax_shaped_arena
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _dump(cfg):
    d = cfg.model_dump()
    d["game"]["map_builder"]["type"] = d["game"]["map_builder"]["type"].rsplit(".", 1)[-1]
    return d


def _pair(seed=0):
    j, p = jax_make_curriculum(jax_shaped_arena()), make_curriculum(make_arena_basic_easy_shaped())
    for c in (j, p):
        c.cfg.seed = seed
        c._rng.seed(seed)
    return j, p


def _ids(c):
    return [t.task_id for t in c.active_tasks()]


def test_same_pool_and_configs():
    j, p = _pair()
    assert isinstance(p.algorithm, cur.LearningProgressAlgorithm)
    assert _ids(j) == _ids(p) and len(_ids(p)) == 16
    for jt, pt in zip(j.active_tasks(), p.active_tasks()):
        assert jt.get_slice_values() == pt.get_slice_values()
        assert _dump(jt.get_env_cfg()) == _dump(pt.get_env_cfg())


def test_same_weights_picks_and_evictions():
    j, p = _pair(seed=7)
    rng = np.random.default_rng(0)
    for rnd in range(40):
        ids = _ids(p)
        assert ids == _ids(j)
        assert j.task_weights(ids) == p.task_weights(ids)
        for tid in ids[: 4 + rnd % 5]:
            score = float(rng.uniform(-0.2, 1.2))
            j.update_task_performance(tid, score)
            p.update_task_performance(tid, score)
        assert j.get_task().task_id == p.get_task().task_id
        if rnd % 10 == 9:
            # overflow the pool by one task: the next update evicts
            for c in (j, p):
                c._spawn_task()
            j.update_task_performance(ids[0], 0.5)
            p.update_task_performance(ids[0], 0.5)
            assert len(_ids(p)) == 16 and _ids(p) == _ids(j)
    assert j.stats() == p.stats()
    assert j.get_state() == p.get_state()
    assert j.algorithm.should_evict_task(ids[0]) == p.algorithm.should_evict_task(ids[0])
    assert j.algorithm.recommend_eviction(ids) == p.algorithm.recommend_eviction(ids)


def test_state_round_trip():
    j, p = _pair(seed=3)
    for c in (j, p):
        for tid in _ids(c)[:6]:
            c.update_task_performance(tid, 0.25)
    state = p.get_state()
    fresh = make_curriculum(make_arena_basic_easy_shaped())
    fresh.set_state(state)
    assert _ids(fresh) == _ids(p) and fresh.get_state() == state


def test_slice_analyzer_matches():
    js, ps = jax_cur.SliceAnalyzer(max_slice_axes=2), cur.SliceAnalyzer(max_slice_axes=2)
    rng = np.random.default_rng(1)
    for tid in range(30):
        sv = {"a": int(rng.integers(0, 5)), "b": float(rng.uniform(0, 2)), "c": "x"}
        score = float(rng.uniform())
        js.update_task_completion(tid, sv, score)
        ps.update_task_completion(tid, sv, score)
    assert js.get_slice_distribution_stats() == ps.get_slice_distribution_stats()
    assert js.get_base_stats() == ps.get_base_stats()
    assert js.get_underexplored_regions("a") == ps.get_underexplored_regions("a")
