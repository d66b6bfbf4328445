"""The port's bfloat16 policy and learner against the JAX package's, on the CPU.

The learner on the card runs the ViT at its default ``compute_dtype``,
bfloat16. Both packages then round to bfloat16 at the same points (each
Dense's product and then its bias, the embedding gather, each step of the
softmax and of the tanh gelu, LayerNorm's output), but a float32 sum of the
same products in another order still lands on the other side of a bfloat16
rounding now and then, and such a flip grows through the layers that
follow. So:

- Each bfloat16 component of the policy (the token embed with its gather's
  scatter-add backward, the Perceiver encoder, the critic MLP with its
  backward) gets the same inputs and parameters (the ``stable_100m:v48``
  bundle) in both packages and is held to a tolerance that the port's
  float32 version of the same component fails on the same inputs: the test
  checks both, so a module left in float32, or rounding at other points,
  cannot pass. Tolerances: the token embed and its gradient bit-equal; the
  encoder's output bit-equal in at least 95% of its elements and within
  1e-4 in mean relative difference; the critic's float32 output within 1e-5
  mean relative, and the gradient of its bfloat16 layer bit-equal in at
  least 95% of its elements.
- The whole policy (step and segment) and one minibatch's loss, metrics and
  gradient at bfloat16 are held to what the flips leave: each policy output
  within 5e-2 of its largest magnitude; the loss and each metric within 2e-2
  relative (to at least 1e-2 of the loss); the gradient within 1e-1 in
  relative L2 norm and with a cosine of at least 0.99 to the JAX one.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.models import components as jc
from metta_tpu.models.vit import ViTConfig as JViTConfig
from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped
from metta_tpu_torch.convert import (
    flatten_tree, flax_to_state_dict, state_dict_to_flax, unflatten_tree,
)
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.models.vit import ViTConfig
from metta_tpu_torch.rl import checkpoint as tck

import test_torch_trainer as tt
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUNDLE = Path(__file__).resolve().parents[1] / "devops_runs/stable_100m/checkpoints/stable_100m:v48"


@pytest.fixture(scope="module")
def v48():
    """(compiled config, [48, 200, 3] uint8 arena obs, state_dict, ViTConfig,
    flax parameter tree)."""
    cfg = make_arena_basic_easy_shaped(24)
    cfg.game.map_builder.seed = 0
    env = MettaGridEnv(cfg, num_envs=2, seed=0, track_stats=False, step_mode="batched",
                       device="cpu")
    env.reset()
    gen = torch.Generator().manual_seed(0)
    for _ in range(6):
        obs, *_ = env.step(torch.randint(0, env.compiled.n_actions, (2, 24), generator=gen))
    sd, pcfg, _ = tck.load_policy_bundle(BUNDLE)
    return env.compiled, obs.reshape(-1, *obs.shape[2:]), sd, pcfg, \
        state_dict_to_flax(sd, pcfg.core_num_heads)["params"]


def _policy(v48, dtype):
    compiled, _, sd, pcfg, _ = v48
    pol = dataclasses.replace(pcfg, compute_dtype=dtype).make(
        compiled.n_actions, compiled.feature_normalizations)
    pol.load_state_dict(sd)
    return pol


def _f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _agree(got, want):
    """(share of elements bit-equal, mean |got - want| / mean |want|)."""
    g, w = _f32(got), _f32(want)
    d = np.abs(g - w)
    return float(np.mean(d == 0)), float(d.mean() / max(np.abs(w).mean(), 1e-30))


def _token_embed(pol, obs, ct):
    """(output, d embedding) of the port's token embed for cotangent ``ct``."""
    pol.zero_grad()
    x, _ = pol.token_embed(obs)
    (x.float() * ct).sum().backward()
    return x, pol.token_embed.embedding.grad


def _perceiver(pol, tokens, mask):
    with torch.no_grad():
        return pol.perceiver(tokens, mask)


def _critic(pol, x, ct):
    pol.zero_grad()
    out = pol.critic(x)
    (out * ct).sum().backward()
    return out, pol.critic.fc0.weight.grad.T


def test_token_embed_bf16_bit_equal(v48):
    compiled, obs, _, pcfg, tree = v48
    norms = tuple(sorted(compiled.feature_normalizations.items()))
    jte = jc.TokenEmbed(pcfg.token_embed_dim, pcfg.fourier_freqs, pcfg.max_tokens, norms,
                        dtype=jnp.bfloat16)
    jobs = jnp.asarray(obs.numpy())
    want, _ = jte.apply({"params": tree["token_embed"]}, jobs)
    ct = np.random.default_rng(0).normal(size=want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jte.apply({"params": p}, jobs)[0], tree["token_embed"])
    (gwant,) = vjp(jnp.asarray(ct).astype(want.dtype))
    gwant = gwant["Embed_0"]["embedding"]
    x, g = _token_embed(_policy(v48, "bfloat16"), obs, torch.from_numpy(ct))
    assert x.dtype == torch.bfloat16
    assert _agree(x, want) == (1.0, 0.0) and _agree(g, gwant) == (1.0, 0.0)
    x, g = _token_embed(_policy(v48, "float32"), obs, torch.from_numpy(ct))
    assert _agree(x, want)[0] < 1.0 and _agree(g, gwant)[0] < 1.0


def test_perceiver_bf16_matches_flax(v48):
    compiled, obs, _, pcfg, tree = v48
    norms = tuple(sorted(compiled.feature_normalizations.items()))
    jte = jc.TokenEmbed(pcfg.token_embed_dim, pcfg.fourier_freqs, pcfg.max_tokens, norms,
                        dtype=jnp.bfloat16)
    tokens, mask = jte.apply({"params": tree["token_embed"]}, jnp.asarray(obs.numpy()))
    jp = jc.PerceiverLatent(pcfg.latent_dim, pcfg.core_num_latents, pcfg.core_num_heads,
                            dtype=jnp.bfloat16)
    want = jp.apply({"params": tree["perceiver"]}, tokens, mask)
    t_tokens = torch.from_numpy(np.array(tokens.astype(jnp.float32))).to(torch.bfloat16)
    t_mask = torch.from_numpy(np.array(mask))
    got = _perceiver(_policy(v48, "bfloat16"), t_tokens, t_mask)
    assert got.dtype == torch.bfloat16
    equal, rel = _agree(got, want)
    assert equal >= 0.95 and rel <= 1e-4, (equal, rel)
    equal, rel = _agree(_perceiver(_policy(v48, "float32"), t_tokens, t_mask), want)
    assert equal < 0.95 and rel > 1e-4, (equal, rel)


def test_critic_bf16_matches_flax(v48):
    _, _, _, pcfg, tree = v48
    rng = np.random.default_rng(1)
    x = rng.normal(size=(48, pcfg.latent_dim)).astype(np.float32)
    ct = rng.normal(size=(48, 1)).astype(np.float32)
    jmlp = jc.MLP(hidden=(pcfg.critic_hidden,), out=1, dtype=jnp.bfloat16)
    want, vjp = jax.vjp(lambda p: jmlp.apply({"params": p}, jnp.asarray(x)), tree["critic"])
    (gwant,) = vjp(jnp.asarray(ct))
    gwant = gwant["fc0"]["kernel"]
    tx, tct = torch.from_numpy(x), torch.from_numpy(ct)
    out, g = _critic(_policy(v48, "bfloat16"), tx, tct)
    assert _agree(out, want)[1] <= 1e-5 and _agree(g, gwant)[0] >= 0.95
    out, g = _critic(_policy(v48, "float32"), tx, tct)
    assert _agree(out, want)[1] > 1e-5 and _agree(g, gwant)[0] < 0.95


def test_policy_bf16_matches_flax(v48):
    compiled, obs, _, pcfg, tree = v48
    arch = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)
            if f.name in JViTConfig.__dataclass_fields__}
    jpol = JViTConfig(**dict(arch, compute_dtype="bfloat16")).make(
        compiled.n_actions, compiled.feature_normalizations)
    tpol = _policy(v48, "bfloat16")
    apply = jax.jit(jpol.apply)
    rng = np.random.default_rng(2)
    B, H = obs.shape[0], pcfg.latent_dim
    state = tuple(rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    seq = obs.reshape(4, B // 4, *obs.shape[1:])
    calls = [(obs, state), (seq, tuple(np.zeros((B // 4, H), np.float32) for _ in range(2)))]
    for o, s in calls:
        want = apply({"params": tree}, jnp.asarray(o.numpy()), tuple(map(jnp.asarray, s)))
        with torch.no_grad():
            got = tpol(o, tuple(map(torch.from_numpy, s)))
        for name, g, w in zip(("logits", "value", "h_value", "c", "h"),
                              (*got[:3], *got[3]), (*want[:3], *want[3])):
            w = _f32(w)
            err = float(np.abs(_f32(g) - w).max())
            assert err <= 5e-2 * float(np.abs(w).max()), (name, o.dim(), err)


def test_policy_bf16_matches_flax_cortex(v48):
    """The ``"Ag,A,S"`` core at the small trainer widths, every parameter leaf
    drawn at random, bf16 in both packages (the core itself in float32, as in
    both): step from a random state tree and segment from zero, each output
    and state leaf within 5e-2 of its largest magnitude.

    flax runs op by op here, not under ``jax.jit``: XLA's CPU compiler drops
    some bf16 round trips inside its fusions, so the jitted policy rounds at
    other points than the op-by-op one (9% apart on these logits), and this
    core amplifies each flip (the sLSTM's group norm over DH=4 divides by a
    small spread). Op by op, both packages round at the same points."""
    compiled, obs, *_ = v48
    arch = dict(tt.ARCH, core="Ag,A,S", compute_dtype="bfloat16")
    tpol = ViTConfig(**arch).make(compiled.n_actions, compiled.feature_normalizations,
                                  generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in tpol.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
    jparams = state_dict_to_flax(tpol.state_dict(), arch["core_num_heads"])
    jpol = JViTConfig(**arch).make(compiled.n_actions, compiled.feature_normalizations)
    apply = jpol.apply
    rng = np.random.default_rng(7)
    B = obs.shape[0]
    state = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("/n") else rng.normal(size=v.shape))
             .astype(np.float32) for k, v in flatten_tree(tpol.initial_state(B)).items()}
    zero = {k: np.zeros(v.shape, np.float32)
            for k, v in flatten_tree(tpol.initial_state(B // 4)).items()}
    seq = obs.reshape(4, B // 4, *obs.shape[1:])
    for o, s in ((obs, state), (seq, zero)):
        want = apply(jparams, jnp.asarray(o.numpy()),
                     unflatten_tree({k: jnp.asarray(v) for k, v in s.items()}))
        with torch.no_grad():
            got = tpol(o, unflatten_tree({k: torch.from_numpy(v) for k, v in s.items()}))
        gstate, wstate = flatten_tree(got[3]), flatten_tree(want[3])
        assert sorted(gstate) == sorted(wstate)
        for name, g, w in [*zip(("logits", "value", "h_value"), got[:3], want[:3]),
                           *((k, gstate[k], wstate[k]) for k in sorted(wstate))]:
            w = _f32(w)
            err = float(np.abs(_f32(g) - w).max())
            assert err <= 5e-2 * float(np.abs(w).max()), (name, o.dim(), err)


def test_minibatch_bf16_matches_jax():
    arch = dict(tt.ARCH, compute_dtype="bfloat16")
    tr, jtr = tt._pair("gtd_lambda", arch=arch)
    ts = tr.init_state(seed=3)
    mb = tt._minibatch(tr)
    hp = tr.default_hp()
    (jloss, jmetrics), jgrads = tt._jax_loss_and_grads(tr, jtr, ts, mb, hp)
    loss, metrics, grads = tt._port_loss_and_grads(tr, ts, mb, hp)
    scale = 1e-2 * abs(float(jloss))
    for name, g, w in [("loss", loss, jloss)] + [(k, metrics[k], jmetrics[k]) for k in metrics]:
        g, w = float(g), float(w)
        assert abs(g - w) <= 2e-2 * max(abs(w), scale), (name, g, w)
    want = flax_to_state_dict(jgrads)
    got = tr.layout.views(grads)
    g = torch.cat([got[k].reshape(-1) for k in sorted(want)]).double()
    w = torch.cat([want[k].reshape(-1) for k in sorted(want)]).double()
    rel = float((g - w).norm() / w.norm())
    cos = float(g @ w / (g.norm() * w.norm()))
    assert rel <= 1e-1 and cos >= 0.99, (rel, cos)
