"""ViT-style default policy with the LSTM core.

Counterpart of ``metta_tpu/models/vit.py`` (``ViTConfig`` :34, ``ViTPolicy``
:90): token embed -> Perceiver latent pooling -> recurrent core -> actor
MLP(256) + dense head, critic MLP(512) and the GTD aux head. Ported: the
perceiver encoder, the ``"lstm"`` core, the dense actor head, ``critic`` and
``gtd_aux``; the single-step call and the [T, B, K, 3] segment call;
``compute_dtype`` "bfloat16" (the default) and "float32". The config carries
every field of the JAX one, so a bundle's ``policy_spec.json`` loads; the
parts not ported raise ``NotImplementedError`` when the policy is built.

Recurrent state: persistent during rollout, zero per BPTT segment in the
learner, as in the JAX trainer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from metta_tpu_torch.models.components import MLP, Dense, LSTMCore, PerceiverLatent, TokenEmbed

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class ViTConfig:
    """Architecture hyperparameters; fields and defaults as the JAX
    ``ViTConfig``."""

    latent_dim: int = 128
    actor_hidden: int = 256
    critic_hidden: int = 512
    core_num_heads: int = 4
    max_tokens: int = 128
    core_num_latents: int = 12
    token_embed_dim: int = 8
    fourier_freqs: int = 3
    core: str = "Ag,A,S"
    core_layers: int = 2
    compute_dtype: str = "bfloat16"
    num_quantiles: int = 0
    encoder: str = "perceiver"
    swin_window: int = 2
    swin_patch: int = 4
    swin_depth: int = 2
    obs_height: int = 11
    obs_width: int = 11
    actor_head: str = "dense"
    actor_embed_dim: int = 16
    predict_future: bool = False
    name: str = "vit"

    def check_ported(self):
        """Raise ``NotImplementedError`` for what the port does not run yet."""
        unported = [
            (self.core != "lstm", f"core={self.core!r} (cortex stacks, metta_tpu/models/cells.py)"),
            (self.encoder != "perceiver", "encoder='swin' (metta_tpu/models/swin.py)"),
            (self.actor_head != "dense", "actor_head='query_key' (metta_tpu/models/swin.py)"),
            (self.num_quantiles > 0, "num_quantiles > 0 (metta_tpu/models/vit.py:181)"),
            (self.predict_future, "predict_future (metta_tpu/models/vit.py:163)"),
            (self.compute_dtype not in _DTYPES, f"compute_dtype={self.compute_dtype!r}"),
        ]
        for bad, what in unported:
            if bad:
                raise NotImplementedError(f"ViT policy: {what} is not ported")

    def make(self, n_actions: int, feature_norms: dict, generator=None) -> "ViTPolicy":
        return ViTPolicy(self, n_actions, tuple(sorted(feature_norms.items())), generator)


class ViTPolicy(nn.Module):
    """``forward(obs, state) -> (logits, value, h_value, new_state)``.

    ``obs`` [B, K, 3] uint8 runs one step (logits [B, n_actions], value and
    h_value [B]); ``obs`` [T, B, K, 3] runs a segment: the encoder and heads
    batch over T·B and the core runs its sequence mode (outputs [T, B, ...]).
    Parameters are made on the CPU from ``generator`` (seeded by the caller),
    so every device starts from the same numbers."""

    supports_sequence = True

    def __init__(self, cfg: ViTConfig, n_actions: int, feature_norms: tuple = (),
                 generator=None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.n_actions = n_actions
        dtype = _DTYPES[cfg.compute_dtype]
        self.dtype = dtype
        c = cfg
        self.token_embed = TokenEmbed(c.token_embed_dim, c.fourier_freqs, c.max_tokens,
                                      feature_norms, dtype)
        self.perceiver = PerceiverLatent(self.token_embed.out_dim, c.latent_dim,
                                         c.core_num_latents, c.core_num_heads, dtype=dtype)
        self.core = LSTMCore(c.latent_dim)
        self.actor_mlp = MLP(c.latent_dim, (c.actor_hidden,), c.actor_hidden, dtype)
        self.actor_head = Dense(c.actor_hidden, n_actions, torch.float32)
        self.critic = MLP(c.latent_dim, (c.critic_hidden,), 1, dtype)
        self.gtd_aux = MLP(c.latent_dim, (c.critic_hidden,), 1, dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        for m in self.children():
            m.reset_parameters(generator)

    def initial_state(self, batch: int, device=None):
        return self.core.initial_state(batch, device)

    def forward(self, obs, state):
        seq = obs.dim() == 4
        if seq:
            T, B = obs.shape[0], obs.shape[1]
            obs = obs.reshape(T * B, *obs.shape[2:])
        tokens, mask = self.token_embed(obs)
        latent = self.perceiver(tokens, mask)
        if seq:
            latent = latent.reshape(T, B, latent.shape[-1])
        core_out, new_state = self.core(latent, state)
        x = core_out.to(self.dtype)
        actor_h = self.actor_mlp(x)
        logits = self.actor_head(torch.relu(actor_h).to(self.dtype))
        value = self.critic(x)[..., 0]
        h_value = self.gtd_aux(x)[..., 0]
        return logits, value, h_value, new_state
