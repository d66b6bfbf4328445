"""The learner's optimizer: global-norm clipping, then schedule-free AdamW.

Counterpart of ``metta_tpu/rl/trainer.py:74 make_optimizer``, written in the
repo to mirror optax 0.2.6: ``optax.chain(optax.clip_by_global_norm(max),
base)`` with ``base`` one of ``optax.contrib.schedule_free_adamw``,
``optax.adamw``, ``optax.adam`` or ``optax.sgd``. Functional, as optax is:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; the caller adds ``updates`` to ``params``.

Parameters, gradients and moments are single flat float32 vectors (the
trainer keeps the policy's parameters as one vector and hands the policy
views of it), so each step of the rule is one torch op over every
parameter. Step counts and scalars stay on the parameters' device, so an
update never waits for the host.

Schedule-free AdamW as optax has it (Defazio et al. 2024):

- the learning rate warms up linearly from 0 over ``warmup_steps``; the
  inner AdamW reads it at its own count (0 on the first step), the
  schedule-free weighting at ``step_count`` (1 on the first step); with
  ``warmup_steps=0`` optax's schedule is constant 0, and so is this one;
- inner rule: ``nu = b2·nu + (1-b2)·g²`` with bias correction,
  ``u = g / (sqrt(nu_hat) + eps) + wd·y``, ``z += -lr·u``;
- the averaged iterate ``x`` is recovered from ``y`` (the parameters, where
  gradients are taken) and the old ``z``: ``x = (y - (1-b1)·z_old) / b1``,
  moved toward the new ``z`` by ``ck = max_lr² / Σ max_lr²``, and the new
  parameters are ``y = b1·x + (1-b1)·z``.
"""

from __future__ import annotations

import torch

F32 = torch.float32
WEIGHT_LR_POWER = 2.0          # optax's default weighting of the running average


def _warmup_lr(count, peak, warmup_steps):
    """optax ``warmup_constant_schedule(0, peak, warmup_steps)`` at ``count``
    (an int tensor), float32."""
    if warmup_steps <= 0:
        return torch.zeros((), dtype=F32, device=count.device)
    c = torch.clamp(count, 0, warmup_steps).to(F32)
    frac = 1.0 - c / warmup_steps
    return (0.0 - peak) * frac + peak


def _bias_correction(decay, count):
    return 1.0 - torch.pow(torch.tensor(decay, dtype=F32, device=count.device), count.to(F32))


class Optimizer:
    """``clip_by_global_norm(max_grad_norm)`` followed by the base rule."""

    def __init__(self, kind: str, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, warmup_steps: int = 0,
                 max_grad_norm: float = float("inf")):
        if kind not in ("adamw_schedulefree", "adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.max_grad_norm = max_grad_norm

    def init(self, params):
        zero = torch.zeros((), dtype=torch.int32, device=params.device)
        state = {"count": zero}
        if self.kind in ("adamw", "adam"):
            state.update(mu=torch.zeros_like(params), nu=torch.zeros_like(params))
        elif self.kind == "adamw_schedulefree":
            state.update(
                nu=torch.zeros_like(params), z=params.detach().clone(),
                weight_sum=torch.zeros((), dtype=F32, device=params.device),
                step_count=torch.ones((), dtype=torch.int32, device=params.device),
                max_lr=torch.zeros((), dtype=F32, device=params.device),
            )
        return state

    def clip(self, g):
        norm = torch.sqrt((g * g).sum())
        return torch.where(norm < self.max_grad_norm, g, (g / norm) * self.max_grad_norm)

    def update(self, grads, state, params):
        g = self.clip(grads)
        count = state["count"] + 1
        if self.kind == "sgd":
            return -self.lr * g, {"count": count}
        if self.kind in ("adamw", "adam"):
            mu = (1 - self.b1) * g + self.b1 * state["mu"]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"]
            mu_hat = mu / _bias_correction(self.b1, count)
            nu_hat = nu / _bias_correction(self.b2, count)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.kind == "adamw":
                u = u + self.weight_decay * params
            return (-self.lr) * u, {"count": count, "mu": mu, "nu": nu}
        return self._schedule_free(g, state, params, count)

    def _schedule_free(self, g, state, params, count):
        b1 = self.b1
        # the schedule-free weighting reads the schedule at step_count
        lr = _warmup_lr(state["step_count"], self.lr, self.warmup_steps)
        max_lr = torch.maximum(state["max_lr"], lr)
        weight = max_lr ** WEIGHT_LR_POWER
        total = state["weight_sum"] + weight
        ck = torch.where(torch.isnan(weight) | torch.isnan(total),
                         torch.full_like(weight, float("nan")),
                         torch.nan_to_num(weight / total, nan=0.0, posinf=float("inf")))
        # inner AdamW without momentum: scale_by_rms, decayed weights, -lr(count)
        nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"]
        nu_hat = nu / _bias_correction(self.b2, count)
        u = (1 / (torch.sqrt(nu_hat) + self.eps)) * g
        u = u + self.weight_decay * params
        step = -_warmup_lr(state["count"], self.lr, self.warmup_steps)
        z_old = state["z"]
        z = z_old + step * u
        prev_x = (params - (1.0 - b1) * z_old) / b1
        x = (1.0 - ck) * prev_x + ck * z
        new_params = b1 * x + (1.0 - b1) * z
        return new_params - params, {
            "count": count, "nu": nu, "z": z, "weight_sum": total,
            "step_count": state["step_count"] + 1, "max_lr": max_lr,
        }


def make_optimizer(cfg) -> Optimizer:
    """The optimizer of a ``TrainerConfig``, as the JAX trainer makes it."""
    oc = cfg.optimizer
    wd = oc.weight_decay if oc.type in ("adamw", "adamw_schedulefree") else 0.0
    return Optimizer(oc.type, oc.learning_rate, oc.beta1, oc.beta2, oc.eps, wd,
                     oc.warmup_steps, cfg.max_grad_norm)
