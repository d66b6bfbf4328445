"""The port's learner against the JAX trainer, on the CPU, at a tiny size.

- One minibatch: the port's ``Trainer._loss_fn`` and its gradient against
  ``jax.value_and_grad`` of a tiny JAX ``Trainer._loss_fn`` (built as
  ``tests/test_rl_trainer.py`` builds one, with the ``"lstm"`` core at
  float32), the same parameters (the port's, converted by ``convert.py``) and
  the same minibatch of real arena observations, for both critic modes. The
  GTD(λ) critic's gradient runs back through K3's plain version. Tolerance
  1e-4 relative: the loss and each metric to its own magnitude, each
  parameter tensor's gradient to the largest entry of that tensor, or to
  1e-3 of the largest entry of the whole gradient where that is larger (the
  attention key bias, whose exact gradient is 0, holds rounding noise).
- A whole ``Trainer.update`` through ``train``: finite metrics, changed
  parameters, and the trajectory's recorded log-probabilities and values
  equal to the flax policy replayed over the recorded observations and
  actions, with the recurrent state zeroed where an episode ended (1e-5
  absolute).
- What the port does not run is refused with ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.builder.envs import make_arena as jmake_arena
from metta_tpu.models.vit import ViTConfig as JViTConfig
from metta_tpu.rl.config import TrainerConfig as JTrainerConfig
from metta_tpu.rl.trainer import Trainer as JTrainer
from metta_tpu_torch.builder.envs import make_arena
from metta_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from metta_tpu_torch.models.vit import ViTConfig
from metta_tpu_torch.rl.config import LossesConfig, PPOCriticConfig, SamplingConfig, TrainerConfig
from metta_tpu_torch.rl.trainer import Trainer

ARCH = dict(latent_dim=16, actor_hidden=16, critic_hidden=16, max_tokens=16,
            core_num_latents=2, core_num_heads=2, core="lstm", compute_dtype="float32")
TRAIN = dict(num_envs=2, bptt_horizon=8, batch_size=2 * 4 * 8, minibatch_size=16)


def _pair(critic_update, max_steps=None, arch=ARCH):
    """(port trainer, JAX trainer) on the same 4-agent arena map."""
    def cfg(make):
        c = make(num_agents=4)
        c.game.map_builder.seed = 5
        c.game.max_steps = max_steps or c.game.max_steps
        return c

    tc = dict(TRAIN, losses=dict(ppo_critic=dict(critic_update=critic_update)))
    tr = Trainer(cfg(make_arena), TrainerConfig(**tc), ViTConfig(**arch), device="cpu")
    jtr = JTrainer(cfg(jmake_arena), JTrainerConfig(**tc), JViTConfig(**arch))
    assert jtr.env.compiled.n_actions == tr.env.compiled.n_actions
    return tr, jtr


def _minibatch(tr, seed=0):
    """[T, M] minibatch of real obs from the port env and random the rest."""
    rng = np.random.default_rng(seed)
    T, M, K = tr.T, 6, tr.policy_cfg.max_tokens
    env = tr.env
    env.reset()
    obs = []
    for _ in range(T):
        o, *_ = env.step(rng.integers(0, env.compiled.n_actions, (tr.E, tr.A)))
        obs.append(o.reshape(tr.B, -1, 3)[:M, :K].numpy())
    return dict(
        obs=np.stack(obs),
        actions=rng.integers(0, env.compiled.n_actions, (T, M)).astype(np.int32),
        logprob=rng.uniform(-2.5, -0.5, (T, M)).astype(np.float32),
        value=rng.normal(size=(T, M)).astype(np.float32),
        reward=rng.normal(0, 0.5, (T, M)).astype(np.float32),
        done=(rng.random((T, M)) < 0.2).astype(np.float32),
        advantages=rng.normal(size=(T, M)).astype(np.float32),
        rows=np.arange(M, dtype=np.int32),
    )


def _jax_loss_and_grads(tr, jtr, ts, mb, hp):
    """((loss, metrics), flax gradient tree) of the JAX trainer's ``_loss_fn``
    at the port's parameters ``ts.params``."""
    jparams = state_dict_to_flax(tr.state_dict(ts.params), tr.policy_cfg.core_num_heads)
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtr._loss_fn((p, None), jmb, jnp.asarray(hp, jnp.float32), {},
                               jax.random.PRNGKey(0)), has_aux=True))
    return fn(jparams)


def _port_loss_and_grads(tr, ts, mb, hp):
    """(loss, metrics, [P] gradient) of the port's ``_loss_fn``."""
    tmb = {k: torch.from_numpy(v) for k, v in mb.items() if k != "rows"}   # all PPO rows
    tmb["actions"] = tmb["actions"].long()
    p = ts.params.detach().requires_grad_()
    loss, metrics = tr._loss_fn(p, tmb, hp)
    (grads,) = torch.autograd.grad(loss, p)
    return loss.detach(), metrics, grads


def _rel(got, want, name, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor, 1e-12)
    assert float(np.abs(got - want).max()) <= 1e-4 * scale, (name, got, want)


@pytest.mark.parametrize("critic_update", ["gtd_lambda", "mse"])
def test_minibatch_loss_and_grads_match_jax(critic_update):
    tr, jtr = _pair(critic_update)
    ts = tr.init_state(seed=3)
    mb = _minibatch(tr)
    hp = tr.default_hp()
    assert hp == jtr.default_hp()
    (jloss, jmetrics), jgrads = _jax_loss_and_grads(tr, jtr, ts, mb, hp)
    loss, metrics, grads = _port_loss_and_grads(tr, ts, mb, hp)

    _rel(loss.item(), float(jloss), "loss")
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        _rel(metrics[k].item(), float(jmetrics[k]), k)
    want = flax_to_state_dict(jgrads)
    got = tr.layout.views(grads)
    assert sorted(got) == sorted(want)
    gmax = max(float(v.abs().max()) for v in want.values())
    for k in got:
        _rel(got[k].numpy(), want[k].numpy(), f"grad {k}", floor=1e-3 * gmax)


def test_update_replays_in_flax():
    tr, jtr = _pair("gtd_lambda", max_steps=5)         # episodes end inside the rollout
    ts = tr.init_state(seed=1)
    p0 = ts.params.clone()
    trajs = []
    rollout = tr._rollout

    def spy(state):
        state, traj = rollout(state)
        trajs.append(traj)
        return state, traj

    tr._rollout = spy
    logs = []
    ts = tr.train(total_timesteps=tr.B * tr.T, ts=ts, log_fn=logs.append)
    assert len(logs) == 1 and logs[0]["agent_steps"] == tr.B * tr.T and logs[0]["sps"] > 0
    for k, v in logs[0].items():
        assert np.isfinite(v), k
    assert ts.update_idx == 1 and float((ts.params - p0).abs().max()) > 0

    traj = trajs[0]
    jparams = state_dict_to_flax(tr.state_dict(p0), ARCH["core_num_heads"])
    apply = jax.jit(jtr.policy.apply)
    core = jtr.policy.initial_state(tr.B)
    for t in range(tr.T):
        keep = (1.0 - traj.done[t].numpy())[:, None]
        core = tuple(c * keep for c in core)
        logits, value, _, core = apply(jparams, jnp.asarray(traj.obs[t].numpy()), core)
        logp = jax.nn.log_softmax(logits)[np.arange(tr.B), traj.actions[t].numpy()]
        np.testing.assert_allclose(traj.logprob[t].numpy(), np.asarray(logp), rtol=0,
                                   atol=1e-5, err_msg=f"logprob step {t}")
        np.testing.assert_allclose(traj.value[t].numpy(), np.asarray(value), rtol=0,
                                   atol=1e-5, err_msg=f"value step {t}")
    assert traj.done[1:].sum() > 0


def test_target_kl_stops_the_phase():
    """With a target every KL exceeds, the first minibatch trips the KL stop:
    the rest of the phase leaves the parameters and the optimizer's counts
    alone."""
    tr, _ = _pair("gtd_lambda")
    tr.cfg.losses.ppo_actor.target_kl = -1.0
    ts = tr.init_state(seed=2)
    p0 = ts.params.clone()
    ts, metrics = tr.update(ts)
    assert tr.n_minibatches > 1 and float(metrics["kl_early_stop"]) == 1.0
    assert int(ts.opt_state["count"]) == 1 and int(ts.opt_state["step_count"]) == 2
    # the first step's rate is 0 (warm-up): the parameters move by rounding only
    torch.testing.assert_close(ts.params, p0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("make", [
    lambda: TrainerConfig(scheduler={"rules": []}),
    lambda: TrainerConfig(autotuner={"evaluation_epochs": 1}),
    lambda: TrainerConfig(rollout_chunks=2),
    lambda: LossesConfig(grpo={"enabled": True}),
    lambda: PPOCriticConfig(burn_in_steps=4),
    lambda: SamplingConfig(method="prioritized"),
    lambda: ViTConfig().make(5, {}),
    lambda: ViTConfig(core="lstm", num_quantiles=8).make(5, {}),
], ids=["scheduler", "autotuner", "chunks", "grpo", "burn_in", "prioritized", "cortex",
        "quantiles"])
def test_unported_is_refused(make):
    with pytest.raises(NotImplementedError):
        make()
