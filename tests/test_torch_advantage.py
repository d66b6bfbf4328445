"""K3 and the advantages of the port against the JAX package, on the CPU.

The port's plain discounted sum (``ops/discounted_sum.py``, what its CUDA
kernel is held to on the card) against ``metta_tpu.ops.discounted_sum``: its
Pallas kernel in interpret mode at B=128 (as ``tests/test_pallas_ops.py``
runs it) and its ``lax.scan`` path at B=70. ``puff_advantage``,
``compute_delta_lambda`` and the gradient through the scan against the JAX
functions and ``jax.grad``; the port takes the time-major [T, B] layout, JAX
[B, T]. Tolerance: 1e-6 relative (float32 recurrences of up to 16 steps;
the two sides round the same multiply-adds, up to XLA's fusion), with an
absolute floor of 1e-6 times the largest magnitude for entries near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.ops.discounted_sum import discounted_sum_reverse
from metta_tpu.rl import advantage as jadv
from metta_tpu_torch.ops.discounted_sum import discounted_sum, discounted_sum_plain
from metta_tpu_torch.rl import advantage as tadv

T = 16


def close(got, want, rtol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T)).astype(np.float32)
    decay = rng.uniform(0, 1, size=(B, T)).astype(np.float32)
    return x, decay


@pytest.mark.parametrize("B,use_pallas", [(128, True), (70, False)], ids=["pallas128", "scan70"])
def test_plain_matches_jax(B, use_pallas):
    x, decay = _inputs(B, B)
    want = np.asarray(discounted_sum_reverse(x, decay, use_pallas=use_pallas,
                                             interpret=use_pallas))
    got = discounted_sum_plain(torch.from_numpy(x.T.copy()), torch.from_numpy(decay.T.copy()))
    close(got.numpy().T, want)
    # the CPU wrapper is the plain version
    assert torch.equal(discounted_sum(torch.from_numpy(x.T.copy()),
                                      torch.from_numpy(decay.T.copy())), got)


def _trajectory(B=12, seed=3):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(B, T)).astype(np.float32)
    rewards = rng.normal(size=(B, T)).astype(np.float32)
    dones = (rng.random((B, T)) < 0.15).astype(np.float32)
    imp = rng.uniform(0.5, 2.0, size=(B, T)).astype(np.float32)
    return values, rewards, dones, imp


def _tm(a):
    """[B, T] numpy -> [T, B] torch."""
    return torch.from_numpy(np.ascontiguousarray(a.T))


def test_puff_advantage_matches_jax():
    v, r, d, imp = _trajectory()
    args = (0.99, 0.95, 1.0, 0.9)
    want = np.asarray(jadv.puff_advantage(v, r, d, imp, *args))
    got = tadv.puff_advantage(_tm(v), _tm(r), _tm(d), _tm(imp), *args)
    close(got.numpy().T, want)


def test_delta_lambda_and_gradient_match_jax():
    v, r, d, _ = _trajectory(seed=4)
    w = np.random.default_rng(5).normal(size=v.shape).astype(np.float32)
    gamma, lam = 0.997, 0.95

    def jloss(vals):
        return jnp.sum(jadv.compute_delta_lambda(vals, r, d, gamma, lam) * w)

    want_dl = np.asarray(jadv.compute_delta_lambda(v, r, d, gamma, lam))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(v)))
    vt = _tm(v).requires_grad_()
    dl = tadv.compute_delta_lambda(vt, _tm(r), _tm(d), gamma, lam)
    (g,) = torch.autograd.grad((dl * _tm(w)).sum(), vt)
    close(dl.detach().numpy().T, want_dl)
    close(g.numpy().T, want_g)


def test_normalize_advantage_matches_jax():
    a = np.random.default_rng(6).normal(2.0, 3.0, size=(T, 9)).astype(np.float32)
    close(tadv.normalize_advantage(torch.from_numpy(a)).numpy(),
          np.asarray(jadv.normalize_advantage(jnp.asarray(a))))


def test_wrapper_refuses_bad_inputs_before_launch():
    from metta_tpu_torch.ops.discounted_sum import launch_discounted_sum

    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        launch_discounted_sum(x, x)
