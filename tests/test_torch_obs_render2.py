"""K4, the v2 obs render, in the port against ``metta_tpu``'s.

- ``render_obs2_plain`` (K4's formulation: rank-order prefix sums and a
  scatter) on the port's prep of a task set's states, against the JAX
  ``render_obs_pallas2(..., eps=1, interpret=True)`` with ``stacked_tables``
  and ``task_id``: ``make_arena(6)``, two tasks whose maps and reward
  weights differ, E=3 (each task's reset state with seeded inventories,
  vibes, last actions and rewards), byte for byte. The set crosses as numpy
  (``convert.task_set_from_numpy``), which also checks every stacked leaf.
- ``render_obs2_plain`` against ``render_obs3_plain`` on ``make_arena(30)``
  (149 block ids, beyond the TPU kernels' 128), also under a token budget of
  24 and with a 13x13 window, byte for byte.
- The render dispatch: the port's copies of ``pick_eps`` and ``supports_v3``
  agree with the JAX package's, and an env whose E fails ``pick_eps``
  renders through K4's wrapper.
- The wrapper takes the plain version for CPU tensors; importing the module
  builds nothing. The CUDA kernel is held against the plain version on a GPU
  by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from metta_tpu.builder.envs import make_arena as jax_make_arena
from metta_tpu.builder.envs import make_combat as jax_make_combat
from metta_tpu.engine.compiler import compile_game as jax_compile_game
from metta_tpu.engine.tables import Tables as JaxTables
from metta_tpu.engine.taskset import build_task_set as jax_build_task_set
from metta_tpu.ops import obs_render3 as jax_v3
from metta_tpu.ops.obs_render2 import render_obs_pallas2
from metta_tpu_torch.builder.envs import make_arena, make_combat
from metta_tpu_torch.convert import state_from_numpy, task_set_from_numpy
from metta_tpu_torch.engine import env as env_mod
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.engine.tables import tables_at
from metta_tpu_torch.ops import obs_render2 as k4
from metta_tpu_torch.ops.obs_render3 import pick_eps, prep_env3, render_obs3_plain, supports_v3
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _render2(state, tables):
    args = prep_env3(state, tables, state.executed_action, state.reward)
    rank = k4.rank_table(tables.obs_scan, tables.obs_width)
    return k4.render_obs2(*args, rank, tables.num_obs_tokens, tables.obs_height,
                          tables.obs_width)


def test_plain_matches_pallas2_with_stacked_tables():
    cfgs = []
    for seed, heart in ((1, 1.0), (2, 0.5)):
        c = jax_make_arena(num_agents=6)
        c.game.map_builder.seed = seed
        c.game.agent.rewards.inventory["heart"] = heart
        cfgs.append(c)
    ts, tables_list = jax_build_task_set(cfgs, track_stats=False)
    # three envs at their tasks' reset states, with seeded inventories,
    # vibes and last actions so that every token kind shows
    tid = np.array([1, 0, 1], np.int32)
    rng = np.random.default_rng(0)
    s = jax.tree.map(lambda x: x[tid], ts.template)
    s = s.replace(agent_inv=rng.integers(0, 4, s.agent_inv.shape).astype(np.int32),
                  agent_vibe=rng.integers(0, 3, s.agent_vibe.shape).astype(np.int32),
                  executed_action=rng.integers(0, 5, s.executed_action.shape).astype(np.int32),
                  reward=rng.integers(-3, 4, s.reward.shape).astype(np.float32) / 4)
    # under jax.jit: the interpret-mode kernel traces once and runs compiled,
    # the same bytes as its eager run in a tenth of the time
    render = jax.jit(lambda s, st, tid: render_obs_pallas2(
        s, tables_list[0], s.executed_action, s.reward, eps=1, interpret=True,
        stacked_tables=st, task_id=tid))
    want = np.asarray(render(s, ts.tables, tid))

    tsdata = task_set_from_numpy(
        [t._cfg for t in tables_list],
        {n: np.asarray(getattr(ts.tables, n)) for n in ts.tables._array_names},
        {f.name: np.asarray(getattr(ts.template, f.name))
         for f in dataclasses.fields(ts.template) if f.name != "key"},
        ts.obs1, ts.weights, track_stats=False)
    assert "obs_static_bg" in tsdata.tables.varying and "stat_w" in tsdata.tables.varying
    state = state_from_numpy({f.name: np.asarray(getattr(s, f.name))
                              for f in dataclasses.fields(s)})
    tables = tables_at(tsdata.tables, torch.from_numpy(tid))
    before = k4.launches
    got = _render2(state, tables).numpy()
    assert k4.launches == before                    # a CPU tensor takes the plain version
    np.testing.assert_array_equal(want, got)
    assert (got[..., 0] != 255).sum(-1).min() > 0


@pytest.mark.parametrize("obs", [{}, dict(num_tokens=24), dict(width=13, height=13)],
                         ids=["arena30", "budget24", "window13"])
def test_plain_matches_v3_plain_on_arena30(obs):
    cfg = make_arena(30)
    cfg.game.map_builder.seed = 1234
    for k, v in obs.items():
        setattr(cfg.game.obs, k, v)
    env = MettaGridEnv(cfg, num_envs=3, seed=0, step_mode="batched", device="cpu")
    t = env.tables
    nb = 1 + t.num_agents + t.n_object_types + t.n_assembler_slots + t.n_chest_slots
    assert nb == 149 and (t.height, t.width) == (62, 87) and not supports_v3(t, 3)
    env.reset()
    gen = torch.Generator().manual_seed(0)
    for _ in range(6):
        env.step(torch.randint(0, t.n_actions, (3, 30), generator=gen))
    s = env.state.env
    args = prep_env3(s, t, s.executed_action, s.reward)
    want = render_obs3_plain(*args, t.obs_scan, t.num_obs_tokens, t.obs_height // 2,
                             t.obs_width // 2)
    np.testing.assert_array_equal(want.numpy(), _render2(s, t).numpy())


def test_dispatch_follows_the_jax_rule(monkeypatch):
    for E in range(1, 400):
        assert pick_eps(E) == jax_v3.pick_eps(E), E
    for make, jax_make, obs in ((make_combat, jax_make_combat, {}),
                                (make_combat, jax_make_combat, dict(width=13, height=13)),
                                (make_arena, jax_make_arena, {})):
        pc, jc = make(30 if make is make_arena else 24), jax_make(30 if make is make_arena else 24)
        for c in (pc, jc):
            c.game.map_builder.seed = 1234
            for k, v in obs.items():
                setattr(c.game.obs, k, v)
        penv = MettaGridEnv(pc, num_envs=1, step_mode="batched", device="cpu")
        compiled, _ = jax_compile_game(jc.game, jc.game.map_builder.create().build())
        jt = JaxTables(compiled)
        for E in (4, 170, 341, 4096):
            assert supports_v3(penv.tables, E) == jax_v3.supports_v3(jt, E), (obs, E)
    calls = {"k1": 0, "k4": 0}
    for name, key in (("render_obs2", "k4"), ("render_obs3", "k1")):
        def counted(*args, _fn=getattr(env_mod, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(env_mod, name, counted)
    cfg = make_arena(6)
    cfg.game.map_builder.seed = 1
    for E, want in ((4, "k1"), (10, "k4")):
        env = MettaGridEnv(cfg, num_envs=E, device="cpu", track_stats=False,
                           step_mode="batched")
        env.reset()
        env.step(np.zeros((E, 6), np.int64))
        assert calls[want] == 1, (E, calls)
        calls[want] = 0


def test_kernel_module_imports_without_nvcc():
    code = ("import metta_tpu_torch.ops.obs_render2 as m; "
            "assert m._lib is None and m.launches == 0; print('ok')")
    env = {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=pathlib.Path(k4.__file__).resolve().parents[2],
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
