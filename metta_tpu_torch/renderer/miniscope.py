"""Terminal renderer ("miniscope").

Counterpart of ``metta_tpu/renderer/miniscope.py`` (reference
``mettagrid/renderer/miniscope/``: miniscope.py, miniscope_state.py,
miniscope_panel.py, buffer.py, symbol.py): an interactive emoji-grid player
with playback control, camera follow and pan, a cursor, agent selection,
manual agent control, a vibe picker, and sidebar panels (selected-object
info, game stats, help). Frames are plain ANSI text, the same string as the
JAX renderer's for the same state. The state machine
(:class:`MiniscopeState`) and frame composition are pure; only the raw-tty
key loop touches the terminal. The env state is read as one env's host copy
(``MettaGridEnv.env_state``, a dict of numpy arrays).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from metta_tpu_torch.engine.state import KIND_ASSEMBLER, KIND_CHEST, KIND_WALL

DEFAULT_SYMBOLS = {
    "agent": "🤖",
    "agent_selected": "🟢",
    "agent_frozen": "🧊",
    "wall": "⬛",
    "assembler": "⭐",
    "chest": "📦",
    "empty": "⬜",
    "cursor": "🎯",
}

# playback speeds in frames/s (miniscope_state.py speed ladder)
SPEEDS = [1.0, 2.0, 5.0, 10.0, 20.0]

KEYMAP_HELP = [
    "space  pause/resume      +/-  speed",
    "n/p    select next/prev agent",
    "m      toggle manual control of selection",
    "wasd / hjkl  move (manual) or pan camera",
    "e      bump/use in facing dir (manual: last move dir)",
    "f      toggle camera follow",
    "c      cursor mode (wasd moves cursor)",
    "v      vibe picker (digits choose, esc cancels)",
    "t      toggle sidebar   ?  help   q  quit",
]


@dataclass
class MiniscopeState:
    """Pure playback/UI state (miniscope_state.py:32-255)."""

    num_agents: int = 0
    map_height: int = 0
    map_width: int = 0
    paused: bool = False
    speed_idx: int = 2
    selected_agent: int = 0
    follow: bool = True
    camera_r: int = 0
    camera_c: int = 0
    cursor_mode: bool = False
    cursor_r: int = 0
    cursor_c: int = 0
    manual_agents: set = field(default_factory=set)
    vibe_picker: bool = False
    help_visible: bool = False
    sidebar_visible: bool = True
    should_quit: bool = False
    last_move_arg: int = 1  # facing for manual bump-use (default: south)

    # -- playback ------------------------------------------------------
    def toggle_pause(self):
        self.paused = not self.paused

    def increase_speed(self):
        self.speed_idx = min(self.speed_idx + 1, len(SPEEDS) - 1)

    def decrease_speed(self):
        self.speed_idx = max(self.speed_idx - 1, 0)

    @property
    def frame_delay(self) -> float:
        return 1.0 / SPEEDS[self.speed_idx]

    # -- selection / control --------------------------------------------
    def select_next_agent(self):
        if self.num_agents:
            self.selected_agent = (self.selected_agent + 1) % self.num_agents

    def select_previous_agent(self):
        if self.num_agents:
            self.selected_agent = (self.selected_agent - 1) % self.num_agents

    def toggle_manual_control(self):
        a = self.selected_agent
        if a in self.manual_agents:
            self.manual_agents.discard(a)
        else:
            self.manual_agents.add(a)

    # -- camera / cursor --------------------------------------------------
    def move_camera(self, dr: int, dc: int):
        self.camera_r = int(np.clip(self.camera_r + dr, 0, max(self.map_height - 1, 0)))
        self.camera_c = int(np.clip(self.camera_c + dc, 0, max(self.map_width - 1, 0)))
        self.follow = False

    def move_cursor(self, dr: int, dc: int):
        self.cursor_r = int(np.clip(self.cursor_r + dr, 0, max(self.map_height - 1, 0)))
        self.cursor_c = int(np.clip(self.cursor_c + dc, 0, max(self.map_width - 1, 0)))

    def reset_for_episode(self, num_agents: int, h: int, w: int):
        self.num_agents = num_agents
        self.map_height, self.map_width = h, w
        self.selected_agent = min(self.selected_agent, max(num_agents - 1, 0))
        self.camera_r, self.camera_c = h // 2, w // 2
        self.cursor_r, self.cursor_c = h // 2, w // 2


# movement args in engine order (compiler move_deltas: 8 directions)
_DIR_KEYS = {
    "w": 0,  # north
    "s": 1,  # south
    "a": 2,  # west
    "d": 3,  # east
    "k": 0, "j": 1, "h": 2, "l": 3,
}


class MiniscopeRenderer:
    """Frame composition + (optional) interactive loop."""

    def __init__(self, env, symbols: Optional[dict] = None,
                 viewport: tuple[int, int] = (24, 40)):
        self.env = env
        self.compiled = env.compiled
        self.symbols = dict(DEFAULT_SYMBOLS)
        for obj_name, obj in env.cfg.game.objects.items():
            if obj.render_symbol:
                self.symbols[obj_name] = obj.render_symbol
        if symbols:
            self.symbols.update(symbols)
        self.viewport = viewport
        self.state = MiniscopeState()
        self.state.reset_for_episode(
            self.compiled.num_agents, self.compiled.height, self.compiled.width
        )

    # -- grid ------------------------------------------------------------

    def _grid_symbols(self, s) -> list[list[str]]:
        kind = np.asarray(s["static_kind"])
        stype = np.asarray(s["static_type"])
        H, W = kind.shape
        grid = [[self.symbols["empty"]] * W for _ in range(H)]
        names = self.compiled.object_type_names
        for r in range(H):
            for c in range(W):
                if kind[r, c] != 0:
                    grid[r][c] = self.symbols.get(names[stype[r, c]], "❓")
        for a in range(self.compiled.num_agents):
            r, c = int(s["agent_r"][a]), int(s["agent_c"][a])
            if s["agent_frozen"][a] > 0:
                grid[r][c] = self.symbols["agent_frozen"]
            elif a == self.state.selected_agent:
                grid[r][c] = self.symbols["agent_selected"]
            else:
                grid[r][c] = self.symbols["agent"]
        if self.state.cursor_mode:
            grid[self.state.cursor_r][self.state.cursor_c] = self.symbols["cursor"]
        return grid

    def _viewport_rows(self, grid) -> list[str]:
        H, W = len(grid), len(grid[0])
        vh, vw = self.viewport
        st = self.state
        if st.follow and self.compiled.num_agents:
            s = self.env.env_state(0)
            st.camera_r = int(s["agent_r"][st.selected_agent])
            st.camera_c = int(s["agent_c"][st.selected_agent])
        r0 = int(np.clip(st.camera_r - vh // 2, 0, max(H - vh, 0)))
        c0 = int(np.clip(st.camera_c - vw // 2, 0, max(W - vw, 0)))
        return ["".join(row[c0 : c0 + vw]) for row in grid[r0 : r0 + vh]]

    # -- sidebar panels (miniscope_panel.py parity) -----------------------

    def _agent_panel(self, s) -> list[str]:
        a = self.state.selected_agent
        names = self.compiled.resource_names
        inv = np.asarray(s["agent_inv"][a])
        lines = [
            f"agent {a}" + (" [manual]" if a in self.state.manual_agents else ""),
            f" pos ({int(s['agent_r'][a])},{int(s['agent_c'][a])})"
            f"  vibe {self.compiled.vibe_names[int(s['agent_vibe'][a])]}",
            f" frozen {int(s['agent_frozen'][a])}"
            f"  reward {float(np.asarray(s['episode_reward'])[a]):.2f}",
            " inventory:",
        ]
        for i, n in enumerate(names):
            if inv[i]:
                lines.append(f"   {n}: {int(inv[i])}")
        return lines

    def _cursor_panel(self, s) -> list[str]:
        """Inspect the object under the cursor (reference object-info panel)."""
        st = self.state
        if not st.cursor_mode:
            return []
        r, c = st.cursor_r, st.cursor_c
        kind = int(np.asarray(s["static_kind"])[r, c])
        lines = [f"cursor ({r},{c})"]
        names = self.compiled.object_type_names
        if kind == KIND_ASSEMBLER:
            idx = int(np.asarray(s["static_idx"])[r, c])
            lines += [
                f" assembler {names[int(np.asarray(s['asm_type'])[idx])]}",
                f" uses {int(np.asarray(s['asm_uses'])[idx])}"
                f" cooldown_end {int(np.asarray(s['asm_cooldown_end'])[idx])}"
                f" clipped {bool(np.asarray(s['asm_clipped'])[idx])}",
            ]
        elif kind == KIND_CHEST:
            idx = int(np.asarray(s["static_idx"])[r, c])
            inv = np.asarray(s["chest_inv"][idx])
            lines.append(" chest: " + ", ".join(
                f"{n}={int(v)}" for n, v in zip(self.compiled.resource_names, inv) if v
            ))
        elif kind == KIND_WALL:
            lines.append(" wall")
        else:
            for a in range(self.compiled.num_agents):
                if int(s["agent_r"][a]) == r and int(s["agent_c"][a]) == c:
                    lines.append(f" agent {a}")
                    break
            else:
                lines.append(" empty")
        return lines

    def _game_panel(self, s) -> list[str]:
        rew = np.asarray(s["episode_reward"])
        return [
            f"step {int(s['step'])}",
            f"total reward {rew.sum():.2f}",
            f"mean reward {rew.mean():.3f}",
        ]

    def _status_line(self) -> str:
        st = self.state
        mode = "PAUSED" if st.paused else f"{SPEEDS[st.speed_idx]:.0f}fps"
        bits = [mode, f"agent {st.selected_agent}"]
        if st.manual_agents:
            bits.append(f"manual {sorted(st.manual_agents)}")
        if st.cursor_mode:
            bits.append("cursor")
        if st.vibe_picker:
            vibes = self.compiled.vibe_names
            bits.append("vibe? " + " ".join(f"{i}={v}" for i, v in enumerate(vibes[:10])))
        bits.append("? for help")
        return "  ".join(bits)

    # -- frame -------------------------------------------------------------

    def compose_frame(self, e: int = 0) -> str:
        s = self.env.env_state(e)
        rows = self._viewport_rows(self._grid_symbols(s))
        if self.state.help_visible:
            side = ["keys:"] + KEYMAP_HELP
        elif self.state.sidebar_visible:
            side = (self._game_panel(s) + [""] + self._agent_panel(s)
                    + [""] + self._cursor_panel(s))
        else:
            side = []
        out = [self._status_line()]
        for i in range(max(len(rows), len(side))):
            left = rows[i] if i < len(rows) else " " * self.viewport[1]
            right = side[i] if i < len(side) else ""
            out.append(f"{left}  {right}" if right else left)
        return "\n".join(out)

    # back-compat simple API (used by tests / non-interactive play)
    def render_string(self, e: int = 0) -> str:
        s = self.env.env_state(e)
        header = f"step {int(s['step'])}  reward {np.asarray(s['episode_reward']).sum():.2f}"
        grid = self._grid_symbols(s)
        return header + "\n" + "\n".join("".join(row) for row in grid)

    def render(self, e: int = 0, clear: bool = True):
        if clear:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(self.compose_frame(e) + "\n")
        sys.stdout.flush()

    # -- input handling (miniscope.py key map) ------------------------------

    def handle_key(self, key: str) -> Optional[tuple[int, int]]:
        """Apply one key press. Returns a manual (action_kind_name, arg)
        override as (action_index, agent) when the key commands the selected
        agent, else None. Pure state transitions — unit-testable."""
        st = self.state
        if st.vibe_picker:
            if key.isdigit() and int(key) < self.compiled.num_vibes:
                action = self._action_index("change_vibe", int(key))
                st.vibe_picker = False
                return (action, st.selected_agent)
            st.vibe_picker = False
            return None
        if key == " ":
            st.toggle_pause()
        elif key == "+":
            st.increase_speed()
        elif key == "-":
            st.decrease_speed()
        elif key == "n":
            st.select_next_agent()
        elif key == "p":
            st.select_previous_agent()
        elif key == "m":
            st.toggle_manual_control()
        elif key == "f":
            st.follow = not st.follow
        elif key == "c":
            st.cursor_mode = not st.cursor_mode
        elif key == "t":
            st.sidebar_visible = not st.sidebar_visible
        elif key == "?":
            st.help_visible = not st.help_visible
        elif key == "v":
            st.vibe_picker = True
        elif key == "q":
            st.should_quit = True
        elif key in _DIR_KEYS:
            arg = _DIR_KEYS[key]
            if st.cursor_mode:
                dr, dc = [(-1, 0), (1, 0), (0, -1), (0, 1)][arg]
                st.move_cursor(dr, dc)
            elif st.selected_agent in st.manual_agents:
                st.last_move_arg = arg
                return (self._action_index("move", arg), st.selected_agent)
            else:
                dr, dc = [(-1, 0), (1, 0), (0, -1), (0, 1)][arg]
                st.move_camera(dr * 2, dc * 2)
        elif key == "e" and st.selected_agent in st.manual_agents:
            # bump-use: move into the facing direction (engine bump semantics)
            return (self._action_index("move", st.last_move_arg), st.selected_agent)
        return None

    def _action_index(self, kind_name: str, arg: int) -> int:
        names = self.compiled.action_names
        want = f"{kind_name}_{arg}"
        for i, n in enumerate(names):
            if n == want or (kind_name == "change_vibe" and n == f"change_vibe_{arg}"):
                return i
        # fall back: first action whose name starts with the kind
        for i, n in enumerate(names):
            if n.startswith(kind_name):
                return i
        return 0

    # -- interactive loop ----------------------------------------------------

    def interactive_loop(self, policy, max_steps: int = 10_000, e: int = 0):
        """Raw-tty play loop (miniscope.py run loop). Non-manual agents act
        from ``policy``; manual agents act from the keyboard."""
        import select
        import termios
        import tty

        env = self.env
        A = self.compiled.num_agents
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        obs = env.reset()
        try:
            tty.setcbreak(fd)
            pending: dict[int, int] = {}
            for _ in range(max_steps):
                t0 = time.time()
                while True:
                    ready, _, _ = select.select([sys.stdin], [], [], 0)
                    if not ready:
                        break
                    key = sys.stdin.read(1)
                    manual = self.handle_key(key)
                    if manual is not None:
                        action, agent = manual
                        pending[agent] = action
                if self.state.should_quit:
                    break
                if not self.state.paused or pending:
                    actions = policy.step_batch(obs[e]).cpu().numpy().reshape(A)
                    for a in self.state.manual_agents:
                        actions[a] = pending.pop(a, self._action_index("noop", 0))
                    obs, rew, done, trunc = env.step(actions.reshape(1, A))
                self.render(e)
                dt = self.state.frame_delay - (time.time() - t0)
                if dt > 0:
                    time.sleep(dt)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
