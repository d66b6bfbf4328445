"""K2's section ablation (``metta_tpu_torch/scripts/ablate_fused.py``) on the CPU.

Each of the script's five variants is a copy of the ``Tables`` with section
flags off (``has_assemblers``, ``has_attack``, ``has_swap``, as
``scripts/ablate_fused.py`` sets them). On the CPU the fused step runs the
plain span on those tables, and it must equal the JAX package's
``vmap(step_env_batched(..., render="defer"))`` with the same flags set on
the JAX ``Tables``, byte for byte in every ``EnvState`` field and in the
rewards, on combat and cooperation at E=4 (one jitted step per variant and
config; the Pallas ``call_fused`` is not run). The script's CLI runs with
``--device cpu``. The kernel's instantiation of each variant is held to the
same plain span on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metta_tpu.builder import envs as jenvs
from metta_tpu.engine.compiler import compile_game
from metta_tpu.engine.step import make_initial_state
from metta_tpu.engine.step_batched import step_env_batched as jstep
from metta_tpu.engine.tables import Tables
from metta_tpu_torch.convert import state_from_numpy, state_to_numpy, tables_from_compiled
from metta_tpu_torch.ops.sim_fused import fused_step_full
from metta_tpu_torch.scripts import ablate_fused

REPO = pathlib.Path(__file__).resolve().parents[1]
E, STEPS = 4, 6
CONFIGS = {"combat": jenvs.make_combat, "cooperation": jenvs.make_cooperation}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def config(request):
    cfg = CONFIGS[request.param](24)
    cfg.game.map_builder.seed = 1234
    compiled, init = compile_game(cfg.game, cfg.game.map_builder.create().build())
    ptables = tables_from_compiled(compiled, init, track_stats=False)
    state1 = make_initial_state(Tables(compiled, track_stats=False), init,
                                jnp.zeros((2,), jnp.uint32))
    state0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), state1)
    return request.param, compiled, ptables, state0


def _seeded(state, compiled, rng):
    """Seeded inventories, vibes (the attack and transfer vibes on a third
    of the agents each) and a few frozen agents, so that every section fires."""
    _, A, R = state.agent_inv.shape
    vibes = [0, 3]
    for mask in (compiled.attack_vibe_mask, compiled.transfer_vibe_mask):
        vibes += [int(v) for v in np.flatnonzero(mask)] * 2
    return state.replace(
        agent_inv=jnp.asarray(rng.integers(0, 4, (E, A, R)), jnp.int32),
        agent_vibe=jnp.asarray(rng.choice(vibes, (E, A)), jnp.int32),
        agent_frozen=jnp.asarray(rng.choice([0] * 9 + [3], (E, A)), jnp.int32),
    )


def _to_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


@pytest.mark.parametrize("variant", list(ablate_fused.VARIANTS))
def test_variant_matches_jax_step(config, variant):
    name, compiled, ptables, state0 = config
    jtables = Tables(compiled, track_stats=False)
    for k, v in ablate_fused.VARIANTS[variant].items():
        setattr(jtables, k, v)
    ptab = ablate_fused.variant_tables(ptables, variant)
    assert all(getattr(ptab, k) == v for k, v in ablate_fused.VARIANTS[variant].items())
    step = jax.jit(jax.vmap(lambda s, a, p: jstep(s, a, jtables, render="defer", perm=p)))
    rng = np.random.default_rng(11)
    jstate = _seeded(state0, compiled, rng)
    A = jstate.agent_r.shape[1]
    for i in range(STEPS):
        acts = np.where(rng.random((E, A)) < 0.5, rng.integers(1, 5, (E, A)),
                        rng.integers(-1, compiled.n_actions + 1, (E, A))).astype(np.int32)
        perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
        pstate = state_from_numpy(_to_numpy(jstate))
        jstate, jrew = step(jstate, jnp.asarray(acts), jnp.asarray(perm))
        pstate, prew = fused_step_full(pstate, torch.as_tensor(acts), ptab,
                                       perm=torch.as_tensor(perm))
        want = _to_numpy(jstate)
        for field, x in state_to_numpy(pstate).items():
            w = want[field].reshape(x.shape)
            assert w.dtype == x.dtype, field
            np.testing.assert_array_equal(w, x, err_msg=f"{name} {variant} step {i}: {field}")
        np.testing.assert_array_equal(np.asarray(jrew), prew.numpy())


def test_variant_copies_leave_the_tables_alone():
    """A variant's flags live on its copy: the production tables keep theirs."""
    cfg = jenvs.make_combat(24)
    cfg.game.map_builder.seed = 1234
    compiled, init = compile_game(cfg.game, cfg.game.map_builder.create().build())
    t = tables_from_compiled(compiled, init, track_stats=False)
    flags = (t.has_assemblers, t.has_attack, t.has_swap)
    bare = ablate_fused.variant_tables(t, "bare")
    assert (bare.has_assemblers, bare.has_attack, bare.has_swap) == (False, False, False)
    assert (t.has_assemblers, t.has_attack, t.has_swap) == flags == (True, True, True)
    with pytest.raises(ValueError):
        ablate_fused.main(["--device", "cpu", "--num-envs", "2", "--el", "128"])
    with pytest.raises(ValueError):
        ablate_fused.main(["--device", "cpu", "--num-envs", "2", "--only", "nochest"])


def test_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "metta_tpu_torch.scripts.ablate_fused", "--device", "cpu",
         "--num-envs", "4", "--steps", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln.split()[1] for ln in out.stdout.splitlines() if ln.startswith("variant ")]
    assert lines == list(ablate_fused.VARIANTS)
