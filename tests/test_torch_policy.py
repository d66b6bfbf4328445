"""The port's ViT policy (``"lstm"`` core) against flax ``ViTPolicy``, and its
bundles, on the CPU.

Observations are real arena tokens from the port's env. Both policies run
at ``compute_dtype="float32"``: logits, value, h_value and the new LSTM
state, in step mode (from a random state) and segment mode ([T, B, K, 3]
from zero). Parameters: the repository's trained bundle
``stable_100m:v48`` (loaded by each package's own loader) and small random
parameters drawn by the port and converted to flax by ``convert.py``.
Tolerance 1e-5 absolute: the two frameworks sum the same float32 products in
different orders.

Bundles: the port's safetensors parser against ``safetensors.numpy``, the
flax <-> port round trip, and a bundle written by the port read back by the
JAX package.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from metta_tpu.models.vit import ViTConfig as JViTConfig
from metta_tpu.rl.checkpoint import load_policy_bundle as jload
from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped
from metta_tpu_torch.convert import flatten_tree, flax_to_state_dict, state_dict_to_flax
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.models.vit import ViTConfig
from metta_tpu_torch.rl import checkpoint as tck

BUNDLE = Path(__file__).resolve().parents[1] / "devops_runs/stable_100m/checkpoints/stable_100m:v48"
ATOL = 1e-5
SMALL = dict(latent_dim=16, actor_hidden=24, critic_hidden=20, max_tokens=32,
             core_num_latents=3, core_num_heads=2, core="lstm")


@pytest.fixture(scope="module")
def arena():
    """(compiled config, [2, 24, 200, 3] uint8 obs after 6 random steps)."""
    cfg = make_arena_basic_easy_shaped(24)
    cfg.game.map_builder.seed = 0               # the same map on every run
    env = MettaGridEnv(cfg, num_envs=2, seed=0, track_stats=False, step_mode="batched",
                       device="cpu")
    env.reset()
    gen = torch.Generator().manual_seed(0)
    for _ in range(6):
        obs, *_ = env.step(torch.randint(0, env.compiled.n_actions, (2, 24), generator=gen))
    return env.compiled, obs.numpy()


def _pair(arch: dict, compiled, params_flax):
    """(flax policy, port policy loaded with the same parameters), float32."""
    arch = dict(arch, compute_dtype="float32")
    jpol = JViTConfig(**arch).make(compiled.n_actions, compiled.feature_normalizations)
    tpol = ViTConfig(**arch).make(compiled.n_actions, compiled.feature_normalizations)
    tpol.load_state_dict(flax_to_state_dict(params_flax))
    return jpol, tpol


def _compare(jpol, jparams, tpol, obs, seed):
    rng = np.random.default_rng(seed)
    B = obs.shape[0]
    H = tpol.cfg.latent_dim
    state = tuple(rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    apply = jax.jit(jpol.apply)
    want = apply(jparams, jnp.asarray(obs), tuple(map(jnp.asarray, state)))
    with torch.no_grad():
        got = tpol(torch.from_numpy(obs), tuple(map(torch.from_numpy, state)))
    names = ("logits", "value", "h_value")
    for name, g, w in zip(names, got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=name)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg="state")

    # segment mode: [T, B', K, 3] from a zero state
    seq = obs[: 4 * (B // 4)].reshape(4, B // 4, *obs.shape[1:])
    zero = jpol.initial_state(seq.shape[1])
    want = apply(jparams, jnp.asarray(seq), zero)
    with torch.no_grad():
        got = tpol(torch.from_numpy(seq), tpol.initial_state(seq.shape[1]))
    for name, g, w in zip(names, got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=f"segment {name}")
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg="segment state")


def test_v48_bundle_matches_flax(arena):
    compiled, obs = arena
    sd, cfg, spec = tck.load_policy_bundle(BUNDLE)
    assert cfg.core == "lstm" and spec["epoch"] == 48
    jparams, jcfg, _ = jload(BUNDLE)
    assert compiled.n_actions == sd["actor_head.weight"].shape[0] == 5
    arch = {k: getattr(jcfg, k) for k in ("latent_dim", "actor_hidden", "critic_hidden",
                                          "core_num_heads", "max_tokens", "core_num_latents",
                                          "token_embed_dim", "fourier_freqs", "core")}
    jpol, tpol = _pair(arch, compiled, jparams)
    tpol.load_state_dict(sd)
    _compare(jpol, jparams, tpol, obs.reshape(-1, *obs.shape[2:]), seed=1)


def test_random_params_match_flax(arena):
    compiled, obs = arena
    obs = obs.reshape(-1, *obs.shape[2:])[:16]
    drawn = ViTConfig(**SMALL).make(compiled.n_actions, compiled.feature_normalizations,
                                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():                       # LayerNorms away from 1 and 0 too
        for name, p in drawn.named_parameters():
            if name.endswith(("scale", "bias")):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(8)))
    jparams = state_dict_to_flax(drawn.state_dict(), SMALL["core_num_heads"])
    jpol, tpol = _pair(SMALL, compiled, jparams)
    _compare(jpol, jparams, tpol, obs, seed=2)


def test_port_init_has_flax_tree(arena):
    """The port's own parameters convert to exactly flax's tree of shapes."""
    compiled, obs = arena
    jpol = JViTConfig(**SMALL).make(compiled.n_actions, compiled.feature_normalizations)
    want = jax.eval_shape(lambda: jpol.init(jax.random.PRNGKey(0), jnp.asarray(obs[0]),
                                            jpol.initial_state(24)))
    tpol = ViTConfig(**SMALL).make(compiled.n_actions, compiled.feature_normalizations,
                                   generator=torch.Generator().manual_seed(0))
    got = flatten_tree(state_dict_to_flax(tpol.state_dict(), SMALL["core_num_heads"]))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in flatten_tree(jax.tree.map(lambda x: x, want)).items()}


def test_safetensors_parser_matches_library():
    got = tck.read_safetensors(BUNDLE / "weights.safetensors")
    want = load_file(str(BUNDLE / "weights.safetensors"))
    assert sorted(got) == sorted(want) and len(got) == 70
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_convert_round_trip_and_bundle_loads_in_jax(tmp_path):
    flat = load_file(str(BUNDLE / "weights.safetensors"))
    sd = flax_to_state_dict(flat)
    back = flatten_tree(state_dict_to_flax(sd, num_heads=4))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    sd, cfg, _ = tck.load_policy_bundle(BUNDLE)
    out = tmp_path / "run:v1"
    tck.save_policy_bundle(out, sd, cfg, extra={"epoch": 1})
    jparams, jcfg, spec = jload(out)
    assert spec["epoch"] == 1 and jcfg.core == "lstm" and jcfg.latent_dim == 128
    for k, v in flatten_tree(jparams).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
    sd2, _, _ = tck.load_policy_bundle(out)
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
