"""Chip smoke test of the PyTorch/CUDA port (``metta_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each one a hard failure):

1. build every CUDA kernel of the port from ``metta_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the card's name and
   power limit;
2. K1 (``csrc/obs_render3.cu``) against its plain torch version
   (``render_obs3_plain``) at the shapes of the ``track_stats=True`` path: the
   combat map, 24 agents, 4096 envs, 20 random steps, byte-equal;
3. K2 (``csrc/sim_fused.cu``) against its plain torch version
   (``fused_span_plain``), every output byte-equal on every step of 20 random
   steps from seeded inventories and vibes: combat and cooperation at 4096
   envs (the count of vibe transfers is printed and must be positive), arena
   at 1024 envs with gained/lost tracking forced on;
4. the port on the GPU against the port on the CPU: 8 envs, 30 steps, the
   same agent orders and desync draws, state and obs byte-identical, for
   combat with ``track_stats=True`` (the torch-ops step) and combat and
   cooperation with ``track_stats=False`` (the fused span);
5. throughput of the main path, ``MettaGridEnv.step`` on combat at 4096 envs
   with ``track_stats=False`` as ``bench.py`` runs it: 100 steps after 10
   warm-up steps, obs consumed every step, median of 5 windows; K2's and K1's
   launch counts in that run; each kernel's time per launch, its plain
   version's time and its bound; a short profile of where the step's device
   time goes; ``hardware_sanity`` (ore and a converted resource present in the
   inventories, as ``bench.py`` checks). Then the ``track_stats=True`` path's
   throughput, 3 windows.

Prints a JSON line of kernels, the card's name and power limit, then as the
last line ``{"ok": true, "device": {...}}``. Exits nonzero, printing no
result, without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

E_MAIN = 4096
AGENTS = 24
SEED = 1234
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM int32 rate outside the tensor cores: half the data sheet's 67 T/s
# float32 rate (64 int32 lanes per SM against 128 float32 lanes), counted alike
INT32_OPS_PER_S = 33.5e12


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def make_cfg(name="combat"):
    from metta_tpu_torch.builder import envs

    cfg = getattr(envs, f"make_{name}")(AGENTS)
    cfg.game.map_builder.seed = SEED
    return cfg


def cuda_time_ms(fn, reps: int, queue_ahead: bool = True) -> float:
    """Milliseconds per call of ``fn`` between CUDA events around ``reps``
    calls. With ``queue_ahead`` the stream first spins for about 0.25 s, so
    the host queues the calls while the device is busy and the events time
    the device's work alone; without it a wrapper whose host side outlasts its
    kernel is timed at the host's pace."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(500_000_000)                 # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build(res):
    from metta_tpu_torch.ops import build

    log(f"[card] {card_line()}")
    t0 = time.time()
    paths = build.build(log=log)
    log(f"[build] {sorted(paths)} built in {time.time() - t0:.1f} s")


def render_args(tables):
    return (tables.obs_scan, tables.num_obs_tokens, tables.obs_height // 2,
            tables.obs_width // 2)


def k1_work(args, scan, T):
    """What K1 must do for these inputs: (bytes, operations, parts in bytes).

    Each output byte is written once. Each input byte the render needs is
    read once: the distinct grid cells of the windows up to the cell that
    fills the T slots (the walk stops there), the count of each distinct
    block those cells hold and the tokens taken from it, the agents'
    positions, global-token counts and global tokens, the window offsets.
    Operations: one add per walked cell (the prefix sum) and one select per
    output slot."""
    sb, tok, counts, rc, g_count, g_tok = args
    E, H, W = sb.shape
    A, NB, S = rc.shape[1], tok.shape[1], scan.shape[0]
    rr = rc[..., 0:1].long() + scan[:, 0].long()                        # [E, A, S]
    cc = rc[..., 1:2].long() + scan[:, 1].long()
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = (rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)).reshape(E, -1)
    b = torch.where(inb, sb.reshape(E, -1).gather(1, flat).reshape(E, A, S), 0).long()
    n = counts.gather(1, b.reshape(E, -1)).reshape(E, A, S).long()
    g = g_count.long().clamp(max=T)[..., None]
    free = T - g - (n.cumsum(-1) - n)                 # slots left on reaching the cell
    walked = inb & (free > 0)
    taken = torch.where(walked, torch.minimum(n, free), 0)
    cells = torch.zeros((E, H * W + 1), dtype=torch.int8, device=sb.device)
    cells.scatter_(1, torch.where(walked, flat.reshape(E, A, S), H * W).reshape(E, -1), 1)
    cells = cells[:, :H * W]                          # the spare column takes the unwalked
    blocks = torch.zeros((E, NB), dtype=torch.int64, device=sb.device)
    blocks.scatter_reduce_(1, b.reshape(E, -1), torch.where(walked, taken + 1, 0).reshape(E, -1),
                           reduce="amax")             # 1 + tokens taken, 0 = unread
    parts = {
        "grid": 4 * int(cells.sum()),
        "counts": 4 * int((blocks > 0).sum()),
        "tokens": 2 * int((blocks - 1).clamp(min=0).sum()),
        "rc+gcnt": 12 * E * A,
        "gtok": 3 * int(g.sum()),
        "scan": 8 * S,
        "out": 3 * E * A * T,
    }
    ops = int(walked.sum()) + E * A * T
    return sum(parts.values()), ops, parts


def phase_k1_vs_plain(res):
    """K1 against its plain version on 20 real steps at E=4096."""
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.engine.step_batched import step_env_batched
    from metta_tpu_torch.ops import obs_render3 as k1

    env = MettaGridEnv(make_cfg(), num_envs=E_MAIN, seed=0, track_stats=True,
                       device="cuda")
    env.reset()
    t = env.tables
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = env.state.env
    max_err = 0
    for i in range(20):
        acts = torch.randint(0, t.n_actions, (E_MAIN, AGENTS), generator=gen, device="cuda")
        state, rew_at_obs = step_env_batched(state, acts, t, generator=gen)
        args = k1.prep_env3(state, t, state.executed_action, rew_at_obs)
        got = k1.render_obs3(*args, *render_args(t))
        want = k1.render_obs3_plain(*args, *render_args(t))
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at step {i}: "
                                 f"{int((got != want).sum())} bytes")
    tokens = (want[..., 0] != 255).sum(-1)
    log(f"[k1] byte-equal to the plain version on 20 steps at E={E_MAIN}; "
        f"tokens per agent mean {tokens.float().mean():.1f} max {int(tokens.max())}")
    res["k1_max_abs_err"] = max_err


def seeded_env(name, n_envs, track_gained=False, seed=5):
    """A ``track_stats=False`` env on the card, reset, with seeded inventories
    (0-3 of each resource) and vibes (the config's attack and transfer vibes
    on a third of the agents each), so that every section of the span fires."""
    from metta_tpu_torch.engine.env import MettaGridEnv

    env = MettaGridEnv(make_cfg(name), num_envs=n_envs, seed=0, track_stats=False,
                       device="cuda")
    if track_gained:
        env.tables.track_gained = True
    env.reset()
    t, s = env.tables, env.state.env
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vibes = [0, 3] + [int(v) for m in (t.attack_vibe_mask, t.transfer_vibe_mask)
                      for v in torch.nonzero(m).flatten()] * 2
    vibes = torch.tensor(vibes, device="cuda")
    pick = torch.randint(0, len(vibes), s.agent_vibe.shape, generator=gen, device="cuda")
    env._state = env.state.replace(env=s.replace(
        agent_inv=torch.randint(0, 4, s.agent_inv.shape, generator=gen, device="cuda",
                                dtype=torch.int32),
        agent_vibe=vibes[pick].to(torch.int32),
    ))
    return env, gen


def random_actions(n_envs, n_actions, gen):
    """[E, A] int32: half moves, half any id in [-1, n_actions] (invalid too)."""
    moves = torch.randint(1, 5, (n_envs, AGENTS), generator=gen, device="cuda")
    anything = torch.randint(-1, n_actions + 1, (n_envs, AGENTS), generator=gen, device="cuda")
    half = torch.rand((n_envs, AGENTS), generator=gen, device="cuda") < 0.5
    return torch.where(half, moves, anything).to(torch.int32)


def count_transfers(prev, new, acts, t):
    """Actors whose move into an agent resolved as a vibe transfer: the move
    succeeded, the actor shows a transfer vibe and stayed in place, and its
    target cell held an agent before the step."""
    from metta_tpu_torch.engine.compiler import ACT_MOVE

    E = acts.shape[0]
    a = acts.long().clamp(0, t.n_actions - 1)
    is_move = (acts >= 0) & (acts < t.n_actions) & (t.action_kind[a] == ACT_MOVE)
    d = t.move_deltas[t.action_arg[a].long().clamp(0, 7)]
    r1 = (prev.agent_r + d[..., 0]).clamp(0, t.height - 1).long()
    c1 = (prev.agent_c + d[..., 1]).clamp(0, t.width - 1).long()
    occupied = prev.agent_grid.reshape(E, -1).gather(1, r1 * t.width + c1) > 0
    stayed = (new.agent_r == prev.agent_r) & (new.agent_c == prev.agent_c)
    tr_vibe = t.transfer_vibe_mask[new.agent_vibe.long().clamp(0, t.num_vibes - 1)]
    return int((new.action_success & is_move & stayed & occupied & tr_vibe).sum())


def phase_k2_vs_plain(res):
    """K2 against its plain version on 20 real steps of three configs."""
    import dataclasses

    from metta_tpu_torch.engine.step_batched import batched_step
    from metta_tpu_torch.ops import sim_fused as k2

    max_err = 0

    def checked(state, actions, rank, tables):
        nonlocal max_err
        got = k2.fused_span(state, actions, rank, tables)
        want = k2.fused_span_plain(state, actions, rank, tables)
        torch.cuda.synchronize()
        bad = k2.span_mismatches(got, want)
        pairs = [(getattr(got[0], f.name), getattr(want[0], f.name))
                 for f in dataclasses.fields(got[0])] + list(zip(got[1:], want[1:]))
        for x, y in pairs:
            if x.shape == y.shape and x.numel():
                max_err = max(max_err, int((x.long() - y.long()).abs().max()))
        if bad:
            raise AssertionError(f"K2 differs from its plain version in {bad}")
        return got

    for name, n_envs, gained in (("combat", E_MAIN, False), ("cooperation", E_MAIN, False),
                                 ("arena", 1024, True)):
        env, gen = seeded_env(name, n_envs, track_gained=gained)
        t, state = env.tables, env.state.env
        transfers = attacks = 0
        for _ in range(20):
            acts = random_actions(n_envs, t.n_actions, gen)
            prev = state
            state, _ = batched_step(state, acts, t, checked, generator=gen)
            transfers += count_transfers(prev, state, acts, t)
            attacks += int((state.agent_frozen > prev.agent_frozen).sum())
        created = int(state.asm_uses.sum())
        log(f"[k2] {name} E={n_envs} track_gained={t.track_gained}: byte-equal to the plain "
            f"version on 20 steps; {transfers} vibe transfers, {attacks} agents frozen by "
            f"attacks, {created} assembler uses")
        if name == "cooperation" and transfers == 0:
            raise AssertionError("no vibe transfer fired on cooperation")
    res["k2_max_abs_err"] = max_err


def phase_gpu_vs_cpu(res):
    """The port on the GPU against the port on the CPU, byte for byte."""
    from metta_tpu_torch.convert import state_to_numpy
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.ops import sim_fused as k2

    E, steps = 8, 30
    for name, track_stats in (("combat", True), ("combat", False), ("cooperation", False)):
        envs = [MettaGridEnv(make_cfg(name), num_envs=E, seed=0, track_stats=track_stats,
                             device=d) for d in ("cuda", "cpu")]
        rng = np.random.default_rng(2)
        desync = rng.integers(1, steps, E)
        obs = [env.reset(desync_step=desync) for env in envs]
        if not torch.equal(obs[0].cpu(), obs[1]):
            raise AssertionError("reset observations differ between GPU and CPU")
        n_actions = envs[0].tables.n_actions
        ended = 0
        k2_before = k2.launches
        for i in range(steps):
            acts = rng.integers(0, n_actions, (E, AGENTS))
            perm = torch.as_tensor(np.stack([rng.permutation(AGENTS) for _ in range(E)]))
            outs = [env.step(acts, perm=perm) for env in envs]
            for field, g, c in zip(("obs", "reward", "done", "truncated"), *outs):
                if not torch.equal(g.cpu(), c):
                    raise AssertionError(f"{name} step {i}: {field} differs between GPU and CPU")
            ended += int((outs[1][2] | outs[1][3]).sum())
            sg, sc = state_to_numpy(envs[0].state), state_to_numpy(envs[1].state)
            for field in sc["env"]:
                if not np.array_equal(sg["env"][field], sc["env"][field]):
                    raise AssertionError(f"{name} step {i}: state field {field} differs")
        k2_runs = k2.launches - k2_before
        if k2_runs != (0 if track_stats else steps):
            raise AssertionError(f"{name} track_stats={track_stats}: K2 launched {k2_runs} "
                                 f"times in {steps} steps")
        log(f"[gpu-vs-cpu] {name} track_stats={track_stats}: state and obs byte-identical "
            f"over {steps} steps at E={E}; {ended} episode ends (auto-reset); "
            f"K2 launches {k2_runs}")


def profile_steps(run, step_ms, n=10):
    """Where the step's device time goes: kernels by total device time over
    a short profiled window, the torch ops that launch them by input shape,
    and the device's busy share of the unprofiled step time ``step_ms`` (the
    profiler slows the host, not the device)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run(n)
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages(group_by_input_shape=True)
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.device_time_total, e.count) for e in events
            if e.device_type == cuda and e.device_time_total > 0]
    dev_us = sum(r[1] for r in rows)
    if dev_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    ops = [(e.key, e.input_shapes, e.self_device_time_total, e.count) for e in events
           if e.device_type != cuda and e.self_device_time_total > 0]
    dev_step_ms = dev_us / 1e3 / n
    log(f"[profile] {n} steps: profiled wall {wall_us / 1e3:.1f} ms, device busy "
        f"{dev_us / 1e3:.1f} ms = {dev_step_ms:.3f} ms a step, "
        f"{100 * dev_step_ms / step_ms:.1f}% of the unprofiled step "
        f"({step_ms:.3f} ms); {sum(r[2] for r in rows)} kernel launches "
        f"= {sum(r[2] for r in rows) / n:.1f} a step")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / dev_us:5.1f}% x{count:5d} {key[:90]}")
    log("[profile] torch ops by input shape, self device time:")
    for key, shapes, us, count in sorted(ops, key=lambda r: -r[2])[:12]:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / dev_us:5.1f}% x{count:5d} "
            f"{key} {str(shapes)[:80]}")


def k2_work(state, acts, t):
    """What K2 must do for these inputs: (bytes, operations, parts in bytes).

    Each input byte the span needs is read once and each output byte written
    once, in the kernel's layout: the agents' actions, ranks, positions,
    vibes, freezes and inventories (and gained/lost where tracked), the
    step, the three grid cells at each mover's target, every station's
    cooldowns, uses, clip state and unclip protocol (they pass through to the
    new tensors), and type, validity and position of each bumped station; the
    table pack. Out: positions, vibes, freezes, inventories (gained/lost),
    success (1 byte) and executed action per agent, the station fields.
    Operations: the pair terms, A*A compares each (winner per target for
    attack, transfer and swap, four move rounds of occupancy and cell
    winner, the station winner), and A*R per agent per inventory phase."""
    from metta_tpu_torch.engine.compiler import ACT_MOVE
    from metta_tpu_torch.engine.state import KIND_ASSEMBLER
    from metta_tpu_torch.ops import sim_fused as k2

    E, A = acts.shape
    R, NA, H, W = t.num_resources, t.n_assembler_slots, t.height, t.width
    a = acts.long().clamp(0, t.n_actions - 1)
    act_ok = (acts >= 0) & (acts < t.n_actions)
    has_req = (state.agent_inv >= t.action_required[a]).all(-1)
    d = t.move_deltas[t.action_arg[a].long().clamp(0, 7)]
    r1, c1 = state.agent_r + d[..., 0], state.agent_c + d[..., 1]
    movers = (act_ok & (state.agent_frozen == 0) & has_req & (t.action_kind[a] == ACT_MOVE)
              & (r1 >= 0) & (r1 < H) & (c1 >= 0) & (c1 < W))
    flat = (r1.clamp(0, H - 1) * W + c1.clamp(0, W - 1)).long()
    kind = state.static_kind.reshape(E, -1).gather(1, flat)
    sidx = state.static_idx.reshape(E, -1).gather(1, flat).long().clamp(0, NA - 1)
    bumped = torch.zeros((E, NA + 1), dtype=torch.bool, device=acts.device)
    bumped.scatter_(1, torch.where(movers & (kind == KIND_ASSEMBLER), sidx, NA), True)
    gl = 8 * E * A * R if t.track_gained else 0
    pack, _ = k2.table_pack(t, acts.device)
    parts = {
        "agents in": 24 * E * A + 4 * E * A * R + gl + 4 * E,
        "target cells": 12 * int(movers.sum()),
        "stations in": 17 * E * NA + 13 * int(bumped[:, :NA].sum()),
        "tables": 4 * pack.numel(),
        "agents out": 21 * E * A + 4 * E * A * R + gl,
        "stations out": 17 * E * NA,
    }
    pair_terms = 3 + 4 * 2 + 1
    ops = E * A * A * pair_terms + E * A * R * 5
    return sum(parts.values()), ops, parts


def bound_of(nbytes, ops):
    """(bound ms, what binds): bytes at 3.35 TB/s against int32 ops at 33.5 T/s."""
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), ops_ms


def warmed_runner(env, gen, acc):
    """A function stepping ``env`` n times with random actions, obs consumed
    every step (summed into ``acc``), after 10 warm-up steps."""
    t = env.tables

    def run(n):
        for _ in range(n):
            acts = torch.randint(0, t.n_actions, (env.num_envs, AGENTS), generator=gen,
                                 device="cuda")
            obs, rew, done, trunc = env.step(acts)
            acc.add_(obs.sum(dtype=torch.int64))       # consume every byte of obs

    run(10)
    torch.cuda.synchronize()
    return run


def timed_windows(run, windows, steps):
    """Wall seconds of each of ``windows`` runs of ``steps`` steps."""
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def phase_throughput(res):
    """The main path: MettaGridEnv.step at E=4096 with track_stats=False (the
    fused span), obs consumed; then the track_stats=True path."""
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.engine.step_batched import rank_from_perm
    from metta_tpu_torch.ops import obs_render3 as k1
    from metta_tpu_torch.ops import sim_fused as k2

    env = MettaGridEnv(make_cfg(), num_envs=E_MAIN, seed=0, track_stats=False, device="cuda")
    env.reset()
    t = env.tables
    gen = torch.Generator(device="cuda").manual_seed(3)
    acc = torch.zeros((), dtype=torch.int64, device="cuda")
    run = warmed_runner(env, gen, acc)
    k1.launches = k2.launches = 0                      # the main path's run starts
    steps = 100
    walls = timed_windows(run, 5, steps)
    launches = {"k1": k1.launches, "k2": k2.launches}  # ... and ends
    n_steps = 5 * steps
    for k, n in launches.items():
        if n < n_steps:
            raise AssertionError(f"{k.upper()} launched {n} times in {n_steps} main-path steps")
    wall = statistics.median(walls)
    res["env_steps_per_s"] = E_MAIN * steps / wall
    log(f"[throughput] track_stats=False E={E_MAIN} A={AGENTS}: "
        f"{res['env_steps_per_s']:.1f} env-steps/s, "
        f"{res['env_steps_per_s'] * AGENTS:.1f} agent-steps/s; "
        f"step {1e3 * wall / steps:.3f} ms (median of 5 windows of {steps} steps; "
        f"windows s {[round(w, 4) for w in walls]}); obs checksum {int(acc)}")
    log(f"[throughput] launches in {n_steps} steps: K2 {launches['k2']} = "
        f"{launches['k2'] / n_steps:.2f} a step, K1 {launches['k1']} = "
        f"{launches['k1'] / n_steps:.2f} a step")

    # K2 alone at the main path's shapes (the last state, fresh actions)
    s = env.state.env
    acts = torch.randint(0, t.n_actions, (E_MAIN, AGENTS), generator=gen, device="cuda",
                         dtype=torch.int32)
    rank = rank_from_perm(None, E_MAIN, AGENTS, gen, "cuda")
    before = k2.launches
    ms2 = cuda_time_ms(lambda: k2.launch_fused_span(s, acts, rank, t), 50)
    host2 = cuda_time_ms(lambda: k2.launch_fused_span(s, acts, rank, t), 50,
                         queue_ahead=False)
    plain2 = cuda_time_ms(lambda: k2.fused_span_plain(s, acts, rank, t), 5)
    k2.launches = before                               # timing launches do not count
    nbytes, ops, parts = k2_work(s, acts, t)
    bound2, by2, ops_ms2 = bound_of(nbytes, ops)
    log(f"[k2] {ms2:.4f} ms per launch on the device ({host2:.4f} ms a call at the "
        f"wrapper's host pace), plain {plain2:.4f} ms, bound {bound2:.4f} ms: "
        f"{nbytes / 1e6:.2f} MB needed at 3.35 TB/s "
        f"{ {k: round(v / 1e6, 3) for k, v in parts.items()} } MB, "
        f"{ops / 1e6:.1f} M int32 ops at 33.5 T/s = {ops_ms2:.4f} ms; "
        f"{100 * bound2 / ms2:.1f}% of the bound")

    # K1 alone at the main path's shapes (inputs of the last state)
    args = k1.prep_env3(s, t, s.executed_action, s.reward)
    out = k1.render_obs3(*args, *render_args(t))
    before = k1.launches
    ms1 = cuda_time_ms(lambda: k1.render_obs3(*args, *render_args(t)), 50)
    host1 = cuda_time_ms(lambda: k1.render_obs3(*args, *render_args(t)), 50,
                         queue_ahead=False)
    plain1 = cuda_time_ms(lambda: k1.render_obs3_plain(*args, *render_args(t)), 5)
    k1.launches = before                               # timing launches do not count
    nbytes, ops, parts = k1_work(args, t.obs_scan, t.num_obs_tokens)
    bound1, by1, ops_ms1 = bound_of(nbytes, ops)
    whole = sum(x.numel() * x.element_size() for x in (*args, t.obs_scan, out))
    log(f"[k1] {ms1:.4f} ms per launch on the device ({host1:.4f} ms a call at the "
        f"wrapper's host pace), plain {plain1:.4f} ms, bound {bound1:.4f} ms: "
        f"{nbytes / 1e6:.2f} MB needed at 3.35 TB/s "
        f"{ {k: round(v / 1e6, 2) for k, v in parts.items()} } MB, "
        f"{ops / 1e6:.1f} M int32 ops at 33.5 T/s = {ops_ms1:.4f} ms; "
        f"{100 * bound1 / ms1:.1f}% of the bound "
        f"(every input read whole: {whole / 1e6:.1f} MB, {1e3 * whole / HBM_BYTES_PER_S:.4f} ms)")
    res["kernels"] = [{
        "name": "obs_render3",
        "route": "cuda",
        "source": "metta_tpu_torch/csrc/obs_render3.cu",
        "replaces": "metta_tpu/ops/obs_render3.py:110",
        "launches": launches["k1"],
        "max_abs_err": res.get("k1_max_abs_err"),
        "ms": ms1,
        "plain_ms": plain1,
        "bound_ms": bound1,
        "bound_by": by1,
        "library_ms": None,
    }, {
        "name": "sim_fused",
        "route": "cuda",
        "source": "metta_tpu_torch/csrc/sim_fused.cu",
        "replaces": "metta_tpu/ops/sim_fused.py:150",
        "launches": launches["k2"],
        "max_abs_err": res.get("k2_max_abs_err"),
        "ms": ms2,
        "plain_ms": plain2,
        "bound_ms": bound2,
        "bound_by": by2,
        "library_ms": None,
    }]

    profile_steps(run, 1e3 * wall / steps)

    # hardware sanity: the conversion chain is alive on this device
    inv = env.state.env.agent_inv.sum(dim=(0, 1)).cpu().numpy()
    names = env.compiled.resource_names
    by_name = {n: int(inv[i]) for i, n in enumerate(names) if inv[i]}
    ore_ok = any(n.startswith("ore") and v > 0 for n, v in by_name.items())
    conv_ok = any((n.startswith("battery") or n in ("heart", "armor", "laser")) and v > 0
                  for n, v in by_name.items())
    res["hardware_sanity"] = "ok" if (ore_ok and conv_ok) else "FAIL"
    log(f"[sanity] hardware_sanity {res['hardware_sanity']}: inventories {by_name}")
    if res["hardware_sanity"] != "ok":
        raise AssertionError("conversion chain dead on this device")

    # the track_stats=True path (torch-ops step, K1), fewer windows
    del env, s, args, out
    env = MettaGridEnv(make_cfg(), num_envs=E_MAIN, seed=0, track_stats=True, device="cuda")
    env.reset()
    run = warmed_runner(env, gen, acc)
    walls = timed_windows(run, 3, steps)
    wall = statistics.median(walls)
    log(f"[throughput] track_stats=True E={E_MAIN} A={AGENTS}: "
        f"{E_MAIN * steps / wall:.1f} env-steps/s, "
        f"{E_MAIN * steps / wall * AGENTS:.1f} agent-steps/s; "
        f"step {1e3 * wall / steps:.3f} ms (median of 3 windows of {steps} steps; "
        f"windows s {[round(w, 4) for w in walls]})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import metta_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    res, failed = {}, []
    t_start = time.time()
    for phase in (phase_build, phase_k1_vs_plain, phase_k2_vs_plain, phase_gpu_vs_cpu,
                  phase_throughput):
        t0 = time.time()
        try:
            phase(res)
            log(f"[{phase.__name__}] ok in {time.time() - t0:.1f} s")
        except Exception:
            failed.append(phase.__name__)
            log(f"[{phase.__name__}] FAILED\n{traceback.format_exc()}")
            if phase is phase_build:
                break
        torch.cuda.synchronize()
    log(f"[done] {time.time() - t_start:.1f} s; failed phases: {failed or 'none'}")
    if failed:
        return 1
    print(json.dumps({"kernels": res["kernels"]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
