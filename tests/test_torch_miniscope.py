"""The port's miniscope renderer against the JAX package's, on the CPU.

Mirrors ``tests/test_miniscope.py`` (the reference's
``test_miniscope_state.py`` and ``test_miniscope_interactions.py``): the
state machine, and each frame and key result of the port's renderer held to
the JAX renderer's as the expected string, on navigation 12x12 with two
agents (map seeded), at reset, under key sequences (help, sidebar, agent
selection, manual control, the vibe picker, camera pans, the cursor over
every cell of the map) and after steps with the JAX env's agent orders fed
to the port's sequential step.
"""

import jax
import numpy as np
import pytest
import torch

from metta_tpu.builder.envs import make_navigation as jax_make_navigation
from metta_tpu.engine.env import MettaGridEnv as JaxEnv
from metta_tpu.renderer.miniscope import MiniscopeRenderer as JaxRenderer
from metta_tpu_torch.builder.envs import make_navigation
from metta_tpu_torch.engine.env import MettaGridEnv
from metta_tpu_torch.renderer.miniscope import SPEEDS, MiniscopeRenderer, MiniscopeState
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _renderers():
    """(port renderer, JAX renderer) over the same reset env."""
    out = []
    for make, Env, Renderer, kw in ((make_navigation, MettaGridEnv, MiniscopeRenderer,
                                     {"device": "cpu"}),
                                    (jax_make_navigation, JaxEnv, JaxRenderer, {})):
        cfg = make(num_agents=2, width=12, height=12)
        cfg.game.map_builder.seed = 3
        env = Env(cfg, num_envs=1, desync_episodes=False, **kw)
        env.reset(*(() if kw else (0,)))
        out.append(Renderer(env, viewport=(8, 12)))
    return out


@pytest.fixture
def pair():
    return _renderers()


def _same(pair, keys=()):
    """Each key's result and the frame after it equal in both renderers."""
    port, ref = pair
    for k in keys:
        assert port.handle_key(k) == ref.handle_key(k), k
        assert port.compose_frame() == ref.compose_frame(), k
    assert port.compose_frame() == ref.compose_frame()
    assert port.render_string() == ref.render_string()
    return port.compose_frame()


def test_state_playback_and_selection():
    st = MiniscopeState()
    st.reset_for_episode(num_agents=3, h=10, w=12)
    assert not st.paused
    st.toggle_pause()
    assert st.paused
    st.increase_speed()
    assert st.frame_delay == 1.0 / SPEEDS[3]
    for _ in range(3):
        st.select_next_agent()
    assert st.selected_agent == 0  # wraps
    st.select_previous_agent()
    assert st.selected_agent == 2
    st.toggle_manual_control()
    assert 2 in st.manual_agents
    st.toggle_manual_control()
    assert st.manual_agents == set()


def test_state_camera_and_cursor_clamped():
    st = MiniscopeState()
    st.reset_for_episode(num_agents=1, h=5, w=5)
    st.move_camera(-100, -100)
    assert (st.camera_r, st.camera_c) == (0, 0)
    assert not st.follow  # manual pan breaks follow
    st.move_cursor(100, 100)
    assert (st.cursor_r, st.cursor_c) == (4, 4)


def test_frame_at_reset_matches_jax(pair):
    frame = _same(pair)
    port, _ = pair
    assert "step 0" in frame and "agent 0" in frame and "inventory:" in frame
    assert port.symbols["agent_selected"] in frame
    assert "keys:" in _same(pair, "?")       # help overlay replaces the sidebar


@pytest.mark.parametrize("keys", ["t", "n", "np", "+-+", " ", "mss", "mde", "v0", "vx",
                                  "dddsaw", "fhjkl", "cssd", "q"],
                         ids=lambda k: repr(k))
def test_key_sequences_match_jax(pair, keys):
    _same(pair, keys)


def test_manual_control_and_vibe_picker(pair):
    port, _ = pair
    assert port.handle_key("m") is None           # selected agent now manual
    action, agent = port.handle_key("s")          # move south
    assert agent == 0 and "move" in port.compiled.action_names[action]
    port.handle_key("v")
    assert port.state.vibe_picker
    out = port.handle_key("0")
    assert out is not None and not port.state.vibe_picker
    port.handle_key("q")
    assert port.state.should_quit


def test_cursor_over_every_cell_matches_jax(pair):
    """The cursor panel (wall, assembler, agent, empty) at every cell."""
    port, _ = pair
    _same(pair, "c")
    seen = set()
    for r in range(port.compiled.height):
        for c in range(port.compiled.width):
            for rend in pair:
                rend.state.cursor_r, rend.state.cursor_c = r, c
            _same(pair)                  # the cursor may lie outside the viewport
            seen.add(port._cursor_panel(port.env.env_state(0))[1])
    assert {" wall", " empty", " agent 0", " agent 1"} <= seen
    assert any(s.startswith(" assembler") for s in seen)


@jax.jit
def _key_perms(keys):
    return jax.vmap(lambda k: jax.random.permutation(jax.random.split(k, 4)[1], 2))(keys)


def test_frames_after_steps_match_jax(pair, capsys):
    port, ref = pair
    rng = np.random.default_rng(0)
    for _ in range(6):
        perm = torch.from_numpy(np.asarray(_key_perms(ref.env.state.env.key)).copy())
        acts = rng.integers(0, port.compiled.n_actions, (1, 2)).astype(np.int32)
        port.env.step(acts, perm=perm)
        ref.env.step(acts)
        _same(pair, "n")
    port.render()
    ref.render()
    out = capsys.readouterr().out
    assert out.startswith("\x1b[2J\x1b[H")
    half = len(out) // 2
    assert out[:half] == out[half:]                     # the two frames, one after the other
    assert "step 6" in out
