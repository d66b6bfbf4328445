"""Scripted baseline agents for cogames missions, the port's own copy of
``metta_tpu/cogames/scripted.py``. The agents plan on the host in numpy:
``step_batch`` takes the observations as a torch tensor on any device and
returns the actions on that device.

Parity: reference ``packages/cogames/src/cogames/policy/scripted_agent/``
(``baseline_agent.py``, ``unclipping_agent.py``, ``pathfinding.py``,
``utils.py``) — a stateful goal-driven policy able to complete the
diagnostic evals: it explores to find stations, gathers resources from
extractors, assembles hearts, delivers them to the chest, recharges, and
unclips clipped stations. Behavior set matched, implementation original:

- origin-relative persistent map built from token observations (occupancy +
  discovered stations by tag), dead-reckoned position (moves assumed to
  succeed except "move-into-to-use" bumps, reference utils.py:305-328)
- phase machine RECHARGE -> DELIVER -> UNCLIP -> ASSEMBLE -> GATHER with
  per-phase vibes (baseline_agent.py:363-453)
- BFS shortest paths over the known map; unknown cells are traversable so
  exploration and goal-seeking share one planner (pathfinding.py)
- heart-recipe discovery from assembler ``protocol_input:*`` tokens, with
  deficits driving the gather target (baseline_agent.py:455-469)
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from metta_tpu_torch.policy.policy import MultiAgentPolicy
from metta_tpu_torch.utils.transfer import to_device

EMPTY = 255
MAP = 256           # origin-relative map size (agent starts at center)
C0 = MAP // 2
UNKNOWN, FREE, WALL = 0, 1, 2

# default heart recipe when protocol tokens haven't been observed yet
DEFAULT_RECIPE = {"carbon": 2, "oxygen": 2, "germanium": 1, "silicon": 3}
RESOURCES = ("carbon", "oxygen", "germanium", "silicon")


@dataclass
class _Station:
    pos: Tuple[int, int]
    kind: str                     # "assembler" | "chest" | "charger" | resource
    cooldown: int = 0
    clipped: bool = False


@dataclass
class _AgentState:
    pos: Tuple[int, int] = (C0, C0)
    occ: np.ndarray = field(default_factory=lambda: np.zeros((MAP, MAP), np.int8))
    stations: Dict[Tuple[int, int], _Station] = field(default_factory=dict)
    vibe: str = "default"
    phase: str = "gather"
    last_move: Optional[Tuple[int, int]] = None
    using_object: bool = False
    explore_dir: int = 0
    stuck: int = 0
    recipe: Dict[str, int] = field(default_factory=dict)
    target_resource: Optional[str] = None
    step: int = 0


class ScriptedBaselineAgent(MultiAgentPolicy):
    """Goal-driven scripted baseline (reference ``baseline_agent.py``)."""

    #: station kinds this agent will bump when clipped (overridden by the
    #: unclipping variant)
    prioritize_clipped = False

    def __init__(self, env, seed: int = 0):
        comp = env.compiled
        self.compiled = comp
        self.rng = np.random.default_rng(seed)
        self.n_actions = comp.n_actions
        f = comp.feature_ids
        self.f_tag = f.get("tag", -1)
        self.f_cool = f.get("cooldown_remaining", -1)
        self.f_clip = f.get("clipped", -1)
        self.f_inv = {}
        for name, fid in f.items():
            if name.startswith("inv:") and not name.endswith(":p1"):
                self.f_inv[fid] = name[4:]
        self.f_pin = {fid: name.split(":", 1)[1] for name, fid in f.items()
                      if name.startswith("protocol_input:")}

        self.tag_names = self._tag_names(comp)

        self.acts = {n: i for i, n in enumerate(comp.action_names)}
        self.move_act = {(-1, 0): self.acts.get("move_north"),
                         (1, 0): self.acts.get("move_south"),
                         (0, -1): self.acts.get("move_west"),
                         (0, 1): self.acts.get("move_east")}
        self.ch, self.cw = comp.obs_height // 2, comp.obs_width // 2
        self.energy_low = 15
        self.states: List[_AgentState] = [
            _AgentState() for _ in range(comp.num_agents)
        ]

    @staticmethod
    def _tag_names(comp) -> Dict[int, str]:
        """tag id -> identifying name, derived from the compiled per-type and
        per-agent tag tables (tag ids are positions in IdMap's sorted union,
        config/id_map.py:84-93; cogames stations carry their type name)."""
        out: Dict[int, str] = {}
        ot = np.asarray(comp.type_tags)
        for t, name in enumerate(comp.object_type_names):
            for tagid in ot[t] if t < ot.shape[0] else ():
                if tagid >= 0:
                    out.setdefault(int(tagid), name)
        for row in np.asarray(comp.agent_tags):
            for tagid in row:
                if tagid >= 0:
                    out.setdefault(int(tagid), "agent")
        return out

    # ------------------------------------------------------------------
    # observation parsing + map update
    # ------------------------------------------------------------------

    def _parse(self, s: _AgentState, obs_row: np.ndarray):
        """Update position (dead reckoning), map, stations, inventory."""
        if s.last_move is not None and not s.using_object:
            s.pos = (s.pos[0] + s.last_move[0], s.pos[1] + s.last_move[1])
        s.using_object = False
        s.last_move = None

        r0, c0 = s.pos
        cells: Dict[Tuple[int, int], dict] = {}
        inv: Dict[str, int] = {}
        for loc, feat, val in obs_row:
            if loc == EMPTY and feat == EMPTY:
                continue
            loc, feat, val = int(loc), int(feat), int(val)
            dr = (loc >> 4) - self.ch
            dc = (loc & 0x0F) - self.cw
            if feat in self.f_inv and dr == 0 and dc == 0:
                inv[self.f_inv[feat]] = inv.get(self.f_inv[feat], 0) + val
                continue
            cell = cells.setdefault((dr, dc), {"tags": []})
            if feat == self.f_tag:
                cell["tags"].append(val)
            elif feat == self.f_cool:
                cell["cooldown"] = val
            elif feat == self.f_clip:
                cell["clipped"] = val
            elif feat in self.f_pin:
                cell.setdefault("pin", {})[self.f_pin[feat]] = val

        # every visible in-window cell with no tokens is free space
        for dr in range(-self.ch, self.ch + 1):
            for dc in range(-self.cw, self.cw + 1):
                rr, cc = r0 + dr, c0 + dc
                if not (0 <= rr < MAP and 0 <= cc < MAP):
                    continue
                info = cells.get((dr, dc))
                if info is None:
                    s.occ[rr, cc] = FREE
                    continue
                tags = {self.tag_names.get(t, "") for t in info["tags"]}
                if "wall" in tags:
                    s.occ[rr, cc] = WALL
                    continue
                s.occ[rr, cc] = FREE
                kind = None
                if "assembler" in tags:
                    kind = "assembler"
                elif "chest" in tags:
                    kind = "chest"
                elif "charger" in tags:
                    kind = "charger"
                else:
                    for rn in RESOURCES:
                        if f"{rn}_extractor" in tags:
                            kind = rn
                            break
                if kind is not None:
                    st = s.stations.setdefault((rr, cc), _Station((rr, cc), kind))
                    st.kind = kind
                    st.cooldown = info.get("cooldown", 0)
                    st.clipped = bool(info.get("clipped", 0))
                    # walls-like for pathing: stations block movement
                    s.occ[rr, cc] = WALL
                    if kind == "assembler" and "pin" in info:
                        s.recipe = {k: v for k, v in info["pin"].items()
                                    if k in RESOURCES and v > 0}
        return inv

    # ------------------------------------------------------------------
    # pathfinding (BFS over known map; unknown traversable)
    # ------------------------------------------------------------------

    def _bfs_step(self, s: _AgentState, goals: set) -> Optional[Tuple[int, int]]:
        """First move of a shortest path from s.pos to any goal cell."""
        if not goals:
            return None
        if s.pos in goals:
            return (0, 0)
        prev = {s.pos: None}
        q = deque([s.pos])
        found = None
        while q:
            cur = q.popleft()
            for d in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                nxt = (cur[0] + d[0], cur[1] + d[1])
                if nxt in prev:
                    continue
                if not (0 <= nxt[0] < MAP and 0 <= nxt[1] < MAP):
                    continue
                if nxt in goals:
                    prev[nxt] = cur
                    found = nxt
                    q.clear()
                    break
                if s.occ[nxt] == WALL:
                    continue
                prev[nxt] = cur
                q.append(nxt)
        if found is None:
            return None
        cur = found
        while prev[cur] != s.pos:
            cur = prev[cur]
            if cur is None:           # safety
                return None
        return (cur[0] - s.pos[0], cur[1] - s.pos[1])

    def _adjacent_cells(self, pos) -> set:
        return {(pos[0] - 1, pos[1]), (pos[0] + 1, pos[1]),
                (pos[0], pos[1] - 1), (pos[0], pos[1] + 1)}

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------

    def _vibe_action(self, s: _AgentState, vibe: str) -> Optional[int]:
        if s.vibe == vibe:
            return None
        a = self.acts.get(f"change_vibe_{vibe}")
        if a is None:
            return None
        s.vibe = vibe
        return a

    def _move(self, s: _AgentState, d: Tuple[int, int], use: bool = False) -> int:
        a = self.move_act.get(d)
        if a is None:
            return self.acts.get("noop", 0)
        s.last_move = d
        s.using_object = use
        return a

    def _goto_and_bump(self, s: _AgentState, station: _Station,
                       vibe: str) -> Optional[int]:
        """Navigate adjacent to the station, set the vibe, bump it."""
        adj = self._adjacent_cells(station.pos)
        if s.pos in adj:
            va = self._vibe_action(s, vibe)
            if va is not None:
                return va
            d = (station.pos[0] - s.pos[0], station.pos[1] - s.pos[1])
            return self._move(s, d, use=True)
        goals = {c for c in adj
                 if 0 <= c[0] < MAP and 0 <= c[1] < MAP and s.occ[c] != WALL}
        step = self._bfs_step(s, goals)
        if step is None or step == (0, 0):
            return None
        return self._move(s, step)

    def _explore(self, s: _AgentState) -> int:
        """Directional exploration: head toward the nearest unknown frontier."""
        free = np.argwhere(s.occ == FREE)
        # frontier: free cells adjacent to unknown
        unknown = s.occ == UNKNOWN
        front = set()
        for rr, cc in free:
            for d in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                nr, nc = rr + d[0], cc + d[1]
                if 0 <= nr < MAP and 0 <= nc < MAP and unknown[nr, nc]:
                    front.add((int(rr), int(cc)))
                    break
        step = self._bfs_step(s, front - {s.pos})
        if step and step != (0, 0):
            return self._move(s, step)
        # fully explored or boxed in: random walk
        dirs = list(self.move_act.keys())
        d = dirs[int(self.rng.integers(len(dirs)))]
        return self._move(s, d)

    # ------------------------------------------------------------------
    # phase machine
    # ------------------------------------------------------------------

    def _act_one(self, s: _AgentState, obs_row: np.ndarray) -> int:
        inv = self._parse(s, obs_row)
        s.step += 1
        recipe = s.recipe or DEFAULT_RECIPE
        deficits = {r: max(0, n - inv.get(r, 0)) for r, n in recipe.items()}
        stations = list(s.stations.values())

        def find(kind):
            best, bd = None, 10 ** 9
            for st in stations:
                if st.kind != kind:
                    continue
                d = abs(st.pos[0] - s.pos[0]) + abs(st.pos[1] - s.pos[1])
                if d < bd:
                    best, bd = st, d
            return best

        # RECHARGE: low energy and a charger is known
        energy = inv.get("energy", 0)
        charger = find("charger")
        if energy < self.energy_low and charger is not None:
            a = self._goto_and_bump(s, charger, "charger")
            if a is not None:
                s.phase = "recharge"
                return a

        # UNCLIP: clipped station known + gear in hand (or prioritized)
        clipped = [st for st in stations if st.clipped]
        if clipped and (inv.get("gear", 0) > 0 or self.prioritize_clipped):
            target = min(clipped, key=lambda st: abs(st.pos[0] - s.pos[0])
                         + abs(st.pos[1] - s.pos[1]))
            a = self._goto_and_bump(s, target, "gear")
            if a is not None:
                s.phase = "unclip"
                return a

        # DELIVER: carrying hearts -> chest (vibe must be default to deposit)
        chest = find("chest")
        if inv.get("heart", 0) > 0 and chest is not None:
            a = self._goto_and_bump(s, chest, "default")
            if a is not None:
                s.phase = "deliver"
                return a

        # ASSEMBLE: all recipe inputs in hand -> assembler with heart vibe
        assembler = find("assembler")
        if assembler is not None and not any(deficits.values()):
            a = self._goto_and_bump(s, assembler, "heart_a")
            if a is not None:
                s.phase = "assemble"
                return a

        # GATHER: target the largest-deficit resource with a known,
        # off-cooldown, unclipped extractor
        s.phase = "gather"
        order = sorted((r for r in deficits if deficits[r] > 0),
                       key=lambda r: -deficits[r])
        for rn in order:
            st = find(rn)
            if st is None or st.clipped:
                continue
            if st.cooldown > 0 and not self._adjacent_cells(st.pos) & {s.pos}:
                continue
            s.target_resource = rn
            a = self._goto_and_bump(s, st, f"{rn}_a")
            if a is not None:
                return a

        # nothing reachable: explore
        return self._explore(s)

    def step_batch(self, obs: torch.Tensor) -> torch.Tensor:
        rows = obs.cpu().numpy()
        out = np.zeros((rows.shape[0],), np.int32)
        for i in range(rows.shape[0]):
            out[i] = self._act_one(self.states[i], rows[i])
        return to_device(torch.from_numpy(out), obs.device)


class ScriptedUnclippingAgent(ScriptedBaselineAgent):
    """Baseline variant that seeks out clipped stations first
    (reference ``unclipping_agent.py``)."""

    prioritize_clipped = True
