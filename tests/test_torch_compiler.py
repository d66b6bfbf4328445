"""The port's host side (config copy, map builders, compiler) against metta_tpu.

``metta_tpu_torch`` keeps its own copies of the framework-free modules; these
tests hold the copies' output equal to the JAX package's, field by field, on
the configs the port runs, and the port's device ``Tables`` statics equal to
the JAX ``Tables`` ones.
"""

import dataclasses

import numpy as np
import pytest

from metta_tpu.builder import envs as jenvs
from metta_tpu.engine.compiler import compile_game as jcompile
from metta_tpu.engine.tables import Tables as JTables
from metta_tpu_torch.builder import envs as penvs
from metta_tpu_torch.engine.compiler import compile_game as pcompile
from metta_tpu_torch.engine.tables import Tables as PTables

CONFIGS = {
    "combat": lambda m: m.make_combat(24),
    "cooperation": lambda m: m.make_cooperation(24),
    "navigation": lambda m: m.make_navigation(4),
}


def _compiled(name):
    out = []
    for mod, compile_game in ((jenvs, jcompile), (penvs, pcompile)):
        cfg = CONFIGS[name](mod)
        cfg.game.map_builder.seed = 1234
        game_map = cfg.game.map_builder.create().build()
        out.append((cfg, game_map, *compile_game(cfg.game, game_map)))
    return out


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compiled_config_matches_jax(name):
    (jcfg, jmap, jc, jinit), (pcfg, pmap, pc, pinit) = _compiled(name)
    # the serialized map builder names its module (metta_tpu vs the port)
    assert (jcfg.model_dump(exclude={"game": {"map_builder"}})
            == pcfg.model_dump(exclude={"game": {"map_builder"}}))
    np.testing.assert_array_equal(jmap.grid, pmap.grid)
    for f in dataclasses.fields(jc):
        _assert_same(getattr(jc, f.name), getattr(pc, f.name), f.name)
    assert sorted(jinit) == sorted(pinit)
    for k in jinit:
        _assert_same(jinit[k], pinit[k], f"init[{k}]")


@pytest.mark.parametrize("track_stats", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tables_statics_match_jax(name, track_stats):
    (_, _, jc, _), (_, _, pc, _) = _compiled(name)
    jt = JTables(jc, track_stats=track_stats)
    pt = PTables(pc, track_stats=track_stats, device="cpu")
    for n in JTables._STATIC_NAMES:
        if n != "obs_renderer":
            assert getattr(jt, n) == getattr(pt, n), n
    # singleton-group limits per agent (step_batched.py:_row_limits_all)
    cls = jc.agent_inv_class
    lims = np.clip(np.take_along_axis(jc.inv_group_base[cls], jc.inv_res_group[cls], 1),
                   0, 65535)
    np.testing.assert_array_equal(lims, pt.agent_lims.numpy())
