"""The port's fused step against ``metta_tpu``'s ``step_env_batched``.

``metta_tpu_torch.ops.sim_fused.fused_step_full`` (on the CPU: the plain
span, ``interaction_span``) from the same state, actions and agent order
(``perm``) must equal the JAX ``vmap(step_env_batched(..., render="defer"))``
with ``track_stats=False`` byte for byte, in every ``EnvState`` field and in
the rewards the observations see. This is the reference that
``tests/test_sim_fused.py`` holds the TPU kernel to; the CUDA kernel itself is
held to the plain span on the card (``tests/test_torch_cuda.py``).
"""

import copy
import dataclasses

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
from metta_tpu_torch.ops.sim_fused import fused_step_full, supports_fused
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 20
# name: (builder, map seed, envs, force track_gained)
CONFIGS = {
    "combat": (lambda: jenvs.make_combat(24), 1234, 4, False),
    "cooperation": (lambda: jenvs.make_cooperation(24), 1234, 4, False),
    "arena_gained": (lambda: jenvs.make_arena(8), 6, 4, True),
    "navigation": (lambda: jenvs.make_navigation(4, width=20, height=20), 11, 4, False),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    make, map_seed, E, gained = CONFIGS[request.param]
    cfg = make()
    cfg.game.map_builder.seed = map_seed
    compiled, init = compile_game(cfg.game, cfg.game.map_builder.create().build())
    tables = Tables(compiled, track_stats=False)
    ptables = tables_from_compiled(compiled, init, track_stats=False)
    if gained:
        tables.track_gained = ptables.track_gained = True
    step = jax.jit(jax.vmap(
        lambda s, a, p: jstep(s, a, tables, render="defer", perm=p)
    ))
    # every env starts from the map's initial state (the keys are unused:
    # the agent order comes in as perm, and these configs draw nothing else)
    state1 = make_initial_state(tables, init, jnp.zeros((2,), jnp.uint32))
    state0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), state1)
    return request.param, compiled, step, ptables, state0


def _to_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def _seeded(state, compiled, rng):
    """Seeded inventories and vibes: a third of the agents show the attack
    vibe, a third the transfer vibe where the config has them."""
    E, A, R = state.agent_inv.shape
    vibes = [0, 3]
    for mask in (compiled.attack_vibe_mask, compiled.transfer_vibe_mask):
        vibes += [int(v) for v in np.flatnonzero(mask)] * 2
    return state.replace(
        agent_inv=jnp.asarray(rng.integers(0, 4, (E, A, R)), jnp.int32),
        agent_vibe=jnp.asarray(rng.choice(vibes, (E, A)), jnp.int32),
        agent_frozen=jnp.asarray(rng.choice([0] * 9 + [3], (E, A)), jnp.int32),
    )


def _transfers(before, after, acts, compiled):
    """Actors whose move into an agent resolved as a vibe transfer: the move
    succeeded, the actor shows a transfer vibe and stayed in place, and its
    target cell held an agent before the step."""
    arg = compiled.action_arg[acts.clip(0, compiled.n_actions - 1)]
    is_move = (acts >= 0) & (acts < compiled.n_actions) & (compiled.action_kind[
        acts.clip(0, compiled.n_actions - 1)] == 1)
    d = compiled.move_deltas[arg.clip(0, 7)]
    r1 = (before["agent_r"] + d[..., 0]).clip(0, compiled.height - 1)
    c1 = (before["agent_c"] + d[..., 1]).clip(0, compiled.width - 1)
    grid = before["agent_grid"].reshape(acts.shape[0], -1)
    occupied = np.take_along_axis(grid, r1 * compiled.width + c1, 1) > 0
    stayed = ((after["agent_r"] == before["agent_r"])
              & (after["agent_c"] == before["agent_c"]))
    tr_vibe = compiled.transfer_vibe_mask[after["agent_vibe"].clip(0, compiled.num_vibes - 1)]
    return int((after["action_success"] & is_move & stayed & occupied & tr_vibe).sum())


def test_fused_step_byte_identical(setup):
    name, compiled, step, ptables, state0 = setup
    assert supports_fused(ptables)
    E, A = state0.agent_r.shape
    rng = np.random.default_rng(7)
    jstate = _seeded(state0, compiled, rng)
    n_act = compiled.n_actions
    transfers = 0
    for i in range(STEPS):
        # half moves (interactions need them), half anything, invalid ids too
        acts = np.where(rng.random((E, A)) < 0.5, rng.integers(1, 5, (E, A)),
                        rng.integers(-1, n_act + 1, (E, A))).astype(np.int32)
        perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
        before = _to_numpy(jstate)
        pstate = state_from_numpy(before)
        jstate, jrew = step(jstate, jnp.asarray(acts), jnp.asarray(perm))
        pstate, prew = fused_step_full(pstate, torch.as_tensor(acts), ptables,
                                       perm=torch.as_tensor(perm))
        want = _to_numpy(jstate)
        got = state_to_numpy(pstate)
        for field, x in got.items():
            w = want[field].reshape(x.shape)
            assert w.dtype == x.dtype, field
            np.testing.assert_array_equal(w, x, err_msg=f"{name} step {i}: {field}")
        np.testing.assert_array_equal(np.asarray(jrew), prew.numpy())
        transfers += _transfers(before, got, acts, compiled)
    if name == "cooperation":
        assert transfers > 0


def test_kernel_layout_matches_wrapper():
    """The table order and the statics struct of ``csrc/sim_fused.cu`` are
    the ones the wrapper packs (the kernel cannot run here to catch a drift)."""
    import re
    from pathlib import Path

    from metta_tpu_torch.ops import sim_fused

    src = (Path(sim_fused.__file__).parent.parent / "csrc" / "sim_fused.cu").read_text()
    tabs = re.search(r"enum Tab \{(.*?)\};", src, re.S).group(1)
    names = [n.strip()[2:].lower() for n in tabs.split(",") if n.strip()]
    want = [n.replace("agent_lims", "lims").replace("loot_ids", "loot")
            for n in sim_fused.TABLES] + ["tab"]
    assert names == want
    body = re.search(r"struct Static \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:\[N_TAB\])?\s*[,;]", body)
    assert fields == [f for f, _ in sim_fused._Static._fields_]


def test_span_takes_chests():
    """K2's span takes chests: on the CPU the wrapper runs the plain span with
    its chest phase (no refusal), the pack carries the chest tables (and
    only where the config has chests), and ``MettaGridEnv`` steps such a
    config through the fused step. The chest config is ``make_mission
    ("basic")`` with the catalog's chest station
    (``scripts/common.py:chest_mission``, on a small map)."""
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.scripts.common import chest_mission
    from metta_tpu_torch.engine.step_batched import interaction_span, rank_from_perm
    from metta_tpu_torch.ops import sim_fused

    env = MettaGridEnv(chest_mission(size=10, chests=6, seed=3), num_envs=3, track_stats=False,
                       step_mode="batched", device="cpu")
    t = env.tables
    assert t.has_chests and supports_fused(t) and sim_fused.span_fits(t)
    assert env._sim_step is fused_step_full
    env.reset()
    state, gen = env.state.env, torch.Generator().manual_seed(1)
    acts = torch.randint(0, t.n_actions, (3, t.num_agents), generator=gen, dtype=torch.int32)
    rank = rank_from_perm(None, 3, t.num_agents, gen)
    got = sim_fused.fused_span(state, acts, rank, t)
    assert sim_fused.span_mismatches(got, interaction_span(state, acts, rank, t)) == []
    nt, v, r = t.chest_vibe_delta.shape
    chests = sum(a.size for a in sim_fused._pack_arrays(t))
    without = copy.copy(t)
    without.has_chests = False
    assert chests - sum(a.size for a in sim_fused._pack_arrays(without)) == nt * v * r + nt * v + nt * r
    assert sim_fused.pack_ints(t) == sim_fused.table_pack(t, "cpu")[0].numel() == chests + 1
