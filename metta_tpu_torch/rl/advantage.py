"""Advantages: VTrace/GAE and TD(λ), through the discounted-sum kernel.

Counterpart of ``metta_tpu/rl/advantage.py``. Both recurrences are
``out[t] = x[t] + decay[t]·out[t+1]``, which is kernel K3
(``ops/discounted_sum.py``): on the card its CUDA kernel, forward and
backward; on the CPU its plain version. Layout is the trainer's own,
time-major [T, B] (the JAX version takes [B, T] and transposes for its
scan). Index t holds (value of obs_t, reward received on arriving at obs_t,
done flag of obs_t)::

    delta_t = rho_t (r_{t+1} + γ v_{t+1} (1-d_{t+1}) - v_t)
    adv_t   = delta_t + γλ c_t (1-d_{t+1}) adv_{t+1}
"""

from __future__ import annotations

import torch

from metta_tpu_torch.ops.discounted_sum import discounted_sum


def puff_advantage(values, rewards, dones, importance, gamma, gae_lambda,
                   vtrace_rho_clip=1.0, vtrace_c_clip=1.0):
    """VTrace-flavored GAE over [T, B] f32 inputs; adv[-1] = 0."""
    nextnonterminal = 1.0 - dones[1:]                          # [T-1, B]
    rho = torch.clamp(importance[:-1], max=vtrace_rho_clip)
    c = torch.clamp(importance[:-1], max=vtrace_c_clip)
    delta = rho * (rewards[1:] + gamma * values[1:] * nextnonterminal - values[:-1])
    decay = gamma * gae_lambda * c * nextnonterminal
    adv = discounted_sum(delta, decay)
    return torch.cat([adv, torch.zeros_like(adv[:1])], dim=0)


def td_lambda_reverse_scan(delta, mask_next, gamma_lambda):
    """running_t = delta_t + γλ mask_t running_{t+1}, [T, B]."""
    return discounted_sum(delta, gamma_lambda * mask_next)


def compute_delta_lambda(values, rewards, dones, gamma, gae_lambda):
    """TD(λ) targets for the GTD critic, [T, B] in and out (last row 0).
    Differentiable in ``values``: the gradient runs back through the scan."""
    mask_next = 1.0 - dones[1:]
    delta = rewards[1:] + gamma * mask_next * values[1:] - values[:-1]
    dl = td_lambda_reverse_scan(delta, mask_next, gamma * gae_lambda)
    return torch.cat([dl, torch.zeros_like(dl[:1])], dim=0)


def normalize_advantage(adv, eps=1e-8):
    """Mean/std normalization over every element (single device)."""
    n = float(adv.numel())
    mean = adv.sum() / n
    var = torch.clamp((adv * adv).sum() / n - mean * mean, min=0.0)
    return (adv - mean) / torch.sqrt(var + eps)
