"""The port's CUDA kernels on a GPU (skipped without one).

Each kernel against its plain torch version, on the card, at small sizes:
K1 (``csrc/obs_render3.cu``) on rolled combat states and on a window outside
the TPU kernel's limits, its wrapper's input checks, and a few whole env
steps on the GPU against the CPU. This file imports no JAX, so it runs on a
machine with a card and torch alone:

    python3 -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from metta_tpu_torch.builder.envs import make_combat
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.ops import obs_render3 as k1

pytestmark = pytest.mark.cuda
E, A = 16, 24


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _env(device, **obs):
    cfg = make_combat(A)
    cfg.game.map_builder.seed = 1234
    for k, v in obs.items():
        setattr(cfg.game.obs, k, v)
    return MettaGridEnv(cfg, num_envs=E, seed=0, track_stats=True, device=device)


def _inputs(env, steps=6):
    env.reset()
    gen = torch.Generator(device=env.device).manual_seed(0)
    for _ in range(steps):
        env.step(torch.randint(0, env.tables.n_actions, (E, A), generator=gen,
                               device=env.device))
    s, t = env.state.env, env.tables
    args = k1.prep_env3(s, t, s.executed_action, s.reward)
    return args, (t.obs_scan, t.num_obs_tokens, t.obs_height // 2, t.obs_width // 2)


@pytest.mark.parametrize("obs", [{}, dict(num_tokens=24), dict(width=13, height=13)],
                         ids=["combat", "budget24", "window13"])
def test_k1_matches_plain(obs):
    args, extra = _inputs(_env(_cuda(), **obs))
    before = k1.launches
    got = k1.render_obs3(*args, *extra)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert torch.equal(got, k1.render_obs3_plain(*args, *extra))


def test_k1_wrapper_checks_inputs():
    args, extra = _inputs(_env(_cuda()), steps=1)
    bad = list(args)
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(ValueError):
        k1.render_obs3(*bad, *extra)
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError):
        k1.render_obs3(*bad, *extra)


def test_env_gpu_matches_cpu():
    envs = [_env(_cuda()), _env("cpu")]
    rng = np.random.default_rng(0)
    desync = rng.integers(1, 12, E)
    obs = [env.reset(desync_step=desync) for env in envs]
    assert torch.equal(obs[0].cpu(), obs[1])
    for _ in range(12):
        acts = rng.integers(0, envs[1].tables.n_actions, (E, A))
        perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(E)]))
        outs = [env.step(acts, perm=perm) for env in envs]
        for g, c in zip(*outs):
            assert torch.equal(g.cpu(), c)
