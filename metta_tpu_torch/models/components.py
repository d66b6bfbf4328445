"""Policy building blocks as ``nn.Module``s, with flax's numerics.

Counterpart of ``metta_tpu/models/components.py`` (``TokenEmbed`` :30,
``PerceiverLatent`` :80, ``LSTMCore`` :124, ``MLP`` :154) and of the flax
layers they are made of. Plain torch ops only (matmuls and elementwise
work); no cuDNN LSTM and no fused attention, so the math and the rounding
points are the JAX package's:

- ``Dense(dtype)`` casts input, kernel and bias to ``dtype`` for each call
  (flax ``promote_dtype``), rounds the product to ``dtype`` and then adds
  the bias (two roundings, as flax; a fused ``F.linear`` with its bias
  rounds once); weights are stored [out, in] as torch's.
- ``LayerNorm`` takes its statistics in float32 with the fast variance
  ``E[x²] - E[x]²``, ``epsilon=1e-6``, and casts the result to ``dtype``.
- ``Attention`` is flax's ``MultiHeadDotProductAttention``: q scaled by
  ``1/sqrt(head_dim)``, masked logits filled with the dtype's minimum (not
  ``-inf``), softmax in the working dtype with each of its steps (the
  exponential, the sum, the quotient) rounded to it, as ``jax.nn.softmax``.
- ``gelu`` is the tanh approximation (``nn.gelu``'s default), written out
  op by op with its constants in the working dtype, as ``jax.nn.gelu``.

Parameter names follow the flax tree (``ln_q_0.scale``, ``xattn_0.query``,
``lstm.weight_ih`` = flax ``ii/if/ig/io``), so ``convert.py`` maps one onto
the other.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

EMPTY_BYTE = 255
_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)`` op by op in ``x``'s dtype."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def lecun_normal_(w, fan_in: int, generator=None):
    """flax's ``lecun_normal``: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``Dense``: y = x @ kernel + bias, all cast to ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: float32 statistics, epsilon 1e-6, output ``dtype``."""

    def __init__(self, features: int, dtype=torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (no dropout): ``query``, ``key``,
    ``value`` project [.., D] to heads x head_dim, ``out`` back to D."""

    def __init__(self, features: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.head_dim = features // num_heads
        self.query = Dense(features, features, dtype)
        self.key = Dense(features, features, dtype)
        self.value = Dense(features, features, dtype)
        self.out = Dense(features, features, dtype)

    def reset_parameters(self, generator=None):
        for m in (self.query, self.key, self.value, self.out):
            m.reset_parameters(generator)

    def forward(self, x_q, x_kv, mask):
        """x_q [N, Q, D], x_kv [N, K, D], mask [N, K] (True = attend)."""
        N, Q, D = x_q.shape
        H, hd = self.num_heads, self.head_dim
        q = self.query(x_q).reshape(N, Q, H, hd).transpose(1, 2)        # [N, H, Q, hd]
        k = self.key(x_kv).reshape(N, -1, H, hd).transpose(1, 2)        # [N, H, K, hd]
        v = self.value(x_kv).reshape(N, -1, H, hd).transpose(1, 2)
        q = q / torch.tensor(math.sqrt(hd), dtype=self.dtype, device=q.device)
        logits = q @ k.transpose(-1, -2)                                  # [N, H, Q, K]
        logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(self.dtype).min)
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        o = (w @ v).transpose(1, 2).reshape(N, Q, H * hd)
        return self.out(o)


class TokenEmbed(nn.Module):
    """Raw observation tokens [N, T, 3] uint8 -> ([N, T', D] features, mask),
    T' = max_tokens: feature-id embedding, Fourier features of the window
    coordinates and the value over its feature's normalization (float32,
    then cast to ``dtype``), zero where the token is empty."""

    def __init__(self, attr_embed_dim=8, num_freqs=3, max_tokens=128, feature_norms=(),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_freqs = num_freqs
        self.max_tokens = max_tokens
        self.embedding = nn.Parameter(torch.empty(256, attr_embed_dim))
        norms = torch.ones(256, dtype=torch.float32)
        for fid, n in feature_norms:
            norms[fid] = max(n, 1.0)
        self.register_buffer("norms", norms, persistent=False)

    @property
    def out_dim(self) -> int:
        return self.embedding.shape[1] + 4 * self.num_freqs + 1

    def reset_parameters(self, generator=None):
        # flax Embed: variance_scaling(1, fan_in, normal) with fan_in = features
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(self.embedding.shape[1]),
                                   generator=generator)

    def forward(self, obs):
        obs = obs[:, : self.max_tokens]
        loc = obs[..., 0].long()
        feat = obs[..., 1].long()
        val = obs[..., 2].float()
        mask = loc != EMPTY_BYTE
        row = (loc >> 4).float() / 15.0
        col = (loc & 0x0F).float() / 15.0
        freqs = 2.0 ** torch.arange(self.num_freqs, dtype=torch.float32,
                                    device=obs.device) * math.pi
        ang_r = row[..., None] * freqs
        ang_c = col[..., None] * freqs
        fourier = torch.cat([torch.sin(ang_r), torch.cos(ang_r),
                             torch.sin(ang_c), torch.cos(ang_c)], dim=-1)
        val_n = (val / self.norms[feat])[..., None]
        attr = self.embedding.to(self.dtype)[feat]
        x = torch.cat([attr.float(), fourier, val_n], dim=-1).to(self.dtype)
        x = torch.where(mask[..., None], x, torch.zeros((), dtype=self.dtype, device=x.device))
        return x, mask


class PerceiverLatent(nn.Module):
    """Learned latents cross-attend to the tokens, [N, T, F] -> [N, D]: two
    cross-attention layers with MLP blocks, latent mean-pool, projection and
    a final LayerNorm."""

    def __init__(self, in_dim: int, latent_dim=128, num_latents=12, num_heads=4, num_layers=2,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.latents = nn.Parameter(torch.empty(num_latents, latent_dim))
        self.token_proj = Dense(in_dim, latent_dim, dtype)
        for i in range(num_layers):
            self.add_module(f"ln_q_{i}", LayerNorm(latent_dim, dtype))
            self.add_module(f"ln_kv_{i}", LayerNorm(latent_dim, dtype))
            self.add_module(f"xattn_{i}", Attention(latent_dim, num_heads, dtype))
            self.add_module(f"ln_mlp_{i}", LayerNorm(latent_dim, dtype))
            self.add_module(f"mlp_up_{i}", Dense(latent_dim, 2 * latent_dim, dtype))
            self.add_module(f"mlp_down_{i}", Dense(2 * latent_dim, latent_dim, dtype))
        self.out_proj = Dense(latent_dim, latent_dim, dtype)
        self.out_ln = LayerNorm(latent_dim, dtype)

    def reset_parameters(self, generator=None):
        std = 0.02 / _TRUNC_STD                        # flax truncated_normal(0.02)
        with torch.no_grad():
            nn.init.trunc_normal_(self.latents, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, tokens, mask):
        N = tokens.shape[0]
        x = self.latents[None].expand(N, -1, -1).to(self.dtype)
        kv = self.token_proj(tokens)
        for i in range(self.num_layers):
            y = getattr(self, f"ln_q_{i}")(x)
            kv_n = getattr(self, f"ln_kv_{i}")(kv)
            x = x + getattr(self, f"xattn_{i}")(y, kv_n, mask)
            z = getattr(self, f"ln_mlp_{i}")(x)
            z = gelu_tanh(getattr(self, f"mlp_up_{i}")(z))
            x = x + getattr(self, f"mlp_down_{i}")(z)
        pooled = x.mean(dim=1)
        return self.out_ln(self.out_proj(pooled))


class LSTMCore(nn.Module):
    """flax ``OptimizedLSTMCell`` in float32; state (c, h), each [N, hidden].

    ``x`` [N, in] runs one step; ``x`` [T, N, in] runs the sequence (the
    input projection of every step in one matmul, then the recurrence) and
    returns the [T, N, hidden] outputs."""

    def __init__(self, hidden: int = 128):
        super().__init__()
        self.hidden = hidden
        H = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * H, H))                 # ii if ig io
        self.weight_hh = nn.Parameter(torch.empty(4 * H, H))                 # hi hf hg ho
        self.bias = nn.Parameter(torch.zeros(4 * H))

    def reset_parameters(self, generator=None):
        H = self.hidden
        with torch.no_grad():
            for g in range(4):
                lecun_normal_(self.weight_ih[g * H:(g + 1) * H], self.weight_ih.shape[1],
                              generator)
                nn.init.orthogonal_(self.weight_hh[g * H:(g + 1) * H], generator=generator)
            self.bias.zero_()

    def initial_state(self, batch: int, device=None):
        z = torch.zeros((batch, self.hidden), dtype=torch.float32, device=device)
        return z, z.clone()

    def _cell(self, xi, state):
        c, h = state
        gates = F.linear(h, self.weight_hh, self.bias) + xi
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_c, new_h)

    def forward(self, x, state):
        xi = F.linear(x.float(), self.weight_ih)
        if x.dim() == 2:
            return self._cell(xi, state)
        outs = []
        for t in range(x.shape[0]):
            h, state = self._cell(xi[t], state)
            outs.append(h)
        return torch.stack(outs), state


class MLP(nn.Module):
    """Dense + relu per hidden width in ``dtype``, then a float32 ``out``."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (), out: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = [in_features, *hidden]
        for i in range(len(hidden)):
            self.add_module(f"fc{i}", Dense(widths[i], widths[i + 1], dtype))
        self.n_hidden = len(hidden)
        self.out = Dense(widths[-1], out, torch.float32)

    def reset_parameters(self, generator=None):
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return self.out(x)
