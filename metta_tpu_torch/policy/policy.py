"""Inference-policy API.

Counterpart of ``metta_tpu/policy/policy.py`` (reference
``mettagrid/policy/policy.py:22-264``, ``AgentPolicy`` / ``MultiAgentPolicy``
/ ``StatefulAgentPolicy``, and ``policy/loader.py``). Policies are batched:
``step_batch`` acts on ``[N, tokens, 3]`` uint8 observations for N agent
slots at once and returns ``[N]`` int32 actions on the observations' device,
so that an evaluation keeps its whole episode batch on the card.

``RandomPolicy`` draws from numpy's ``default_rng(seed)``, so its actions
equal the JAX package's draw for draw. ``NetworkPolicy`` runs the port's
``ViTPolicy`` under ``torch.inference_mode`` with per-slot recurrent state;
it samples by Gumbel-max from its own seeded ``torch.Generator`` (as
``jax.random.categorical``, with another stream of numbers), or takes the
``argmax`` in greedy mode.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from metta_tpu_torch.rl.checkpoint import load_policy_bundle, resolve_uri
from metta_tpu_torch.rl.trainer import zero_ended
from metta_tpu_torch.utils.transfer import to_device


class AgentPolicy:
    """Single-agent stepwise view of a policy."""

    def __init__(self, parent: "MultiAgentPolicy", agent_id: int):
        self.parent = parent
        self.agent_id = agent_id

    def reset(self) -> None:
        self.parent.reset_agent(self.agent_id)

    def step(self, obs) -> int:
        return int(self.parent.step_batch(torch.as_tensor(obs)[None])[0])


class MultiAgentPolicy:
    """Batched policy over agent slots; subclasses implement step_batch."""

    def agent_policy(self, agent_id: int) -> AgentPolicy:
        return AgentPolicy(self, agent_id)

    def reset(self, n_slots: Optional[int] = None) -> None:
        pass

    def reset_agent(self, agent_id: int) -> None:
        pass

    def reset_slots(self, mask) -> None:
        """Reset recurrent state for the masked slots (episode boundaries)."""

    def step_batch(self, obs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class NoopPolicy(MultiAgentPolicy):
    def step_batch(self, obs):
        return torch.zeros((obs.shape[0],), dtype=torch.int32, device=obs.device)


class RandomPolicy(MultiAgentPolicy):
    def __init__(self, n_actions: int, seed: int = 0):
        self.n_actions = n_actions
        self.rng = np.random.default_rng(seed)

    def step_batch(self, obs):
        acts = self.rng.integers(0, self.n_actions, size=(obs.shape[0],), dtype=np.int32)
        return to_device(torch.from_numpy(acts), obs.device)


class NetworkPolicy(MultiAgentPolicy):
    """A trained ``ViTPolicy`` with per-slot recurrent state on its device.

    Greedy or sampling action selection; slots map to (episode, agent) pairs
    in batched evaluation.
    """

    def __init__(self, policy, n_slots: int, sample: bool = True, seed: int = 0,
                 device=None):
        self.device = torch.device(device or next(policy.parameters()).device)
        self.policy = policy.to(self.device).eval()
        self.n_slots = n_slots
        self.sample = sample
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = policy.initial_state(n_slots, self.device)

    @classmethod
    def from_bundle(cls, uri: str, compiled, n_slots: int, sample: bool = True, seed: int = 0,
                    device="cuda"):
        """Load a bundle written by either package's ``CheckpointManager``
        onto ``device``; ``compiled`` (an env's ``compiled``, or
        ``compile_config`` of its config) gives the action count and the
        feature normalizations."""
        sd, policy_cfg, _ = load_policy_bundle(resolve_uri(uri))
        policy = policy_cfg.make(compiled.n_actions, compiled.feature_normalizations)
        policy.load_state_dict(sd)
        return cls(policy, n_slots, sample=sample, seed=seed, device=device)

    def reset(self, n_slots: Optional[int] = None) -> None:
        if n_slots is not None:
            self.n_slots = n_slots
        self.state = self.policy.initial_state(self.n_slots, self.device)

    def reset_slots(self, mask) -> None:
        with torch.inference_mode():
            self.state = zero_ended(self.state, torch.as_tensor(mask, device=self.device))

    def logits(self, obs: torch.Tensor) -> torch.Tensor:
        """One step on ``obs`` cut to ``max_tokens``: the logits, the
        recurrent state carried."""
        obs = obs.to(self.device)[:, : self.policy.cfg.max_tokens]
        with torch.inference_mode():
            logits, _value, _h, self.state = self.policy(obs, self.state)
        return logits

    def step_batch(self, obs):
        logits = self.logits(obs)
        with torch.inference_mode():
            if self.sample:
                u = torch.rand(logits.shape, generator=self.generator, device=self.device)
                u = u.clamp_(min=torch.finfo(torch.float32).tiny)
                logits = logits - torch.log(-torch.log(u))
            return torch.argmax(logits, dim=-1).to(torch.int32)
