"""The port's optimizer (``rl/optim.py``) against optax, on the CPU.

The JAX trainer's own ``make_optimizer`` (``optax.chain`` of
``clip_by_global_norm`` and schedule-free AdamW, AdamW, Adam or SGD) and the
port's, fed the same parameters and the same five gradients (some above the
clipping norm, some below, some entries near 0), must hand back the same
parameters after every step: parameters and gradients cross as the port's
flat vector and optax's dict of leaves. Tolerance 1e-6 absolute (float32
elementwise rules; the global norm is summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metta_tpu.rl.config import TrainerConfig as JTrainerConfig
from metta_tpu.rl.trainer import make_optimizer as jmake
from metta_tpu_torch.rl.config import TrainerConfig
from metta_tpu_torch.rl.optim import make_optimizer

SHAPES = {"a": (7, 5), "b": (11,), "c": (3, 2, 4)}


def _flat(tree):
    return torch.from_numpy(np.concatenate([np.asarray(tree[k]).reshape(-1) for k in SHAPES]))


@pytest.mark.parametrize("kind,warmup", [
    ("adamw_schedulefree", 1000), ("adamw_schedulefree", 3), ("adamw_schedulefree", 0),
    ("adamw", 0), ("adam", 0), ("sgd", 0),
])
def test_optimizer_matches_optax(kind, warmup):
    opt = dict(type=kind, warmup_steps=warmup, learning_rate=0.05)
    jtx = jmake(JTrainerConfig(optimizer=opt))
    ttx = make_optimizer(TrainerConfig(optimizer=opt))
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = _flat(params)
    tstate = ttx.init(tp)
    for step in range(5):
        scale = (0.02, 3.0, 0.1, 1.0, 1e-6)[step]
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
        grads["b"][:3] = 0.0
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, tstate = ttx.update(_flat(grads), tstate, tp)
        tp = tp + tu
        np.testing.assert_allclose(tp.numpy(), _flat(jp).numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"{kind} step {step}")
