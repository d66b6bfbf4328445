"""Chip smoke test of the PyTorch/CUDA port (``metta_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each one a hard failure):

1. build every CUDA kernel of the port from ``metta_tpu_torch/csrc`` (K1-K5;
   S5 and S4 in K1's and K4's sources, each a template on its section mask;
   S1's GEMMs and its other cases in two sources, S2 and S3; one ``nvcc``
   per source, all started together), keep ``ptxas -v``'s
   registers and shared memory of the redesigned K1, K2, K3, K4, K5, S1 fold,
   M2, M3, M4 and S1 GEMM kernels, and print the card's name and power limit;
2. K1 (``csrc/obs_render3.cu``) against its plain torch version
   (``render_obs3_plain``) at the shapes of the ``track_stats=True`` path: the
   combat map, 24 agents, 4096 envs, 20 random steps, byte-equal;
3. K2 (``csrc/sim_fused.cu``) against its plain torch version
   (``fused_span_plain``), every output byte-equal on every step of 20 random
   steps from seeded inventories and vibes: combat and cooperation at 4096
   envs (the count of vibe transfers is printed and must be positive), arena
   at 1024 envs with gained/lost tracking forced on;
4. K4 (``csrc/obs_render2.cu``) against its plain torch version
   (``render_obs2_plain``) on every step of three runs of 20 steps: the
   curriculum env (``MultiTaskEnv`` over the arena curriculum's 16 tasks,
   E=170, the learner's env), ``make_arena(30)`` (149 block ids) at E=4096,
   and combat at E=4096, where K1 renders the same inputs too; K4's time per
   launch and its bound at each shape, K1's time beside it on combat;
5. the port on the GPU against the port on the CPU: 8 envs, 30 steps, the
   same agent orders and desync draws, state and obs byte-identical, for
   combat with ``track_stats=True`` (the torch-ops step) and combat and
   cooperation with ``track_stats=False`` (the fused span); then the
   multi-task env over the curriculum's 16 tasks (E=10, K4), 24 steps with
   auto-reset, task resampling from the same draws, a ``set_weights`` and a
   ``set_task``;
6. throughput of the env path, ``MettaGridEnv.step`` on combat at 4096 envs
   with ``track_stats=False`` as ``bench.py`` runs it: 100 steps after 10
   warm-up steps, obs consumed every step, median of 5 windows; K2's and K1's
   launch counts in that run; each kernel's time per launch, its plain
   version's time and its bound (K2's from ``ops/sim_fused.py:span_work``,
   the bytes and operations the span needs whatever the design), and K1 on
   the same windows with no tokens (every row 255); a short profile of
   where the step's device time goes; ``hardware_sanity`` (ore and a converted resource present in the
   inventories, as ``bench.py`` checks). Then the ``track_stats=True`` path's
   throughput, 3 windows;
7. K3 (``csrc/discounted_sum.cu``) against its plain torch version
   (``discounted_sum_plain``) at the learner's shapes, [255, 4080] (the
   advantages of an update) and [255, 60] (the TD(λ) targets of a
   minibatch): forward, and backward through ``autograd.grad`` against
   autograd through the plain version, bit for bit; the wrapper refuses bad
   inputs; times and bounds at both shapes (the kernels line gives the
   shape that takes most of the launches, and each shape under ``shapes``);
8. the v48 policy (``devops_runs/stable_100m``) on the GPU against the CPU at
   float32 with TF32 off, on real arena observations, step and segment mode
   (tolerance 1e-4), and at the bf16 default (each output within 5e-2 of its
   largest magnitude); bf16 against f32 logged beside them;
9. the single-task learner: ``Trainer`` on the shaped arena, 170 envs, 24
   agents, the default ``TrainerConfig`` (bptt 256, minibatch 16,384,
   GTD(λ), schedule-free AdamW), the v48 ViT with its ``"lstm"`` core; one
   warm-up ``update``, one update through ``train`` with K4/K2/K3's launch
   counts (E=170 fails ``pick_eps``, so K4 renders, as in the JAX env),
   agent-steps/s, the rollout/learn split and peak memory; finite metrics,
   moved parameters, ``hardware_sanity``; the env step alone and a profiled
   learner minibatch; then K4 and K2 on the learner's own env (the shaped
   arena at 170 envs, ``track_stats=False``, 20 steps through
   ``step_state``) and K3 on the rollout's own data, each byte- or bit-equal
   to its plain version;
10. this slice's main path, the arena curriculum learner at ``arena_100m``'s
   shape: ``Trainer`` over the curriculum's 16 tasks (``MultiTaskEnv``,
   E=170, ``track_env_stats=True``), the v48 ViT; one warm-up update, two
   timed updates with a curriculum sync between them (per-task scores,
   ``update_task_performance``, ``set_task`` on an evicted slot,
   ``set_weights``); K4 = 256, K3 = 137, K1 = K2 = 0 launches an update,
   agent-steps/s, the rollout/learn split, peak memory, each task's score,
   finite metrics, moved parameters, the multi-task env step alone;
11. K5 (``csrc/obs_render.cu``) against its plain torch version
   (``render_obs1_plain``) on every render of the sequential env with
   ``obs_renderer="pl"``: combat at E=1, 10 and 4096 and ``make_arena(30)``
   (149 block ids) at E=1024; ``initial_observations`` through K5 against the
   plain renderer; K5's time per launch, host pace, plain time and bound at
   each shape;
12. this slice's main path, the exact sequential step (``MettaGridEnv``'s
   default step mode) on combat with ``obs_renderer="pl"``: env-steps/s at
   E=4096 and E=1 (median of 3 windows after warm-up, obs consumed), K5
   exactly once a step and K1 = K2 = K4 = 0 over the timed steps, launches and
   the device's busy share of a profiled step; then the sequential env on the
   GPU against the CPU over 30 steps with auto-reset and desync: combat with
   K5, and the arena with a shared limit group over laser and armor, asked
   for ``step_mode="batched"`` and taken into the sequential step;
13. the analysis path, the six kernel-analysis scripts of
   ``metta_tpu_torch/scripts`` through their ``main`` at the JAX scripts'
   default sizes: S5 and S4, the section ablations of the production K1
   and K4 (each mask an instantiation of ``csrc/obs_render3.cu`` or
   ``csrc/obs_render2.cu``; combat, E=4096: ``none``, each section stubbed
   alone, all stubbed), every variant equal to its plain version in the
   bytes it defines and ``none`` byte-equal to the production kernel and
   timed beside it on the same inputs, K1's ``none`` beside phase 6's K1
   and K4's beside phase 4's; K2's section ablation (``ablate_fused``: combat,
   E=4096, the seeded state of phase 3; ``full``, ``noasm``, ``noattack``,
   ``noswap``, ``bare``, each the kernel instantiation of its flags, byte-equal
   to its plain version), its launches counted and each section's cost
   (``full`` minus the variant) logged; S3, the sim-kernel smoke check, at
   E=256 and 257, timed also in turns with ``copy_`` of its inv; S2,
   the nine pair-mat cases at E=4096, byte-equal, each with its bound, its
   share and its issue floor from the SASS (``s2_issue_floors``), the four
   cases nearest their floor timed in turns with a launch of the same grid
   that only loads and stores x, and pair_full (24 shuffles a rep) in turns
   with its form by K2's warp match, and tdiv on x across all of int32
   bit-equal to its plain version and timed in turns with the script's x;
   S1, the ten primitive
   cases at G=1024, reps 16, eps 4 (float32 within rtol 1e-6, the bf16
   GEMMs within 1e-3 of their largest magnitude); each variant's and case's
   time, bound and plain time; the launch counts of the scripts' run; one
   PyTorch call for each S1 case that one computes (M5's ``torch.add``, the
   folds', M2's and M4's ``torch.sum`` over an expanded view), held to the
   plain version and timed as the library yardstick; M5, M2 and M4 timed
   in turns with that call and (M5, M2) with ``copy_`` of the same bytes,
   M3 in turns with ``copy_`` of its x;
   each repeat loop found in the SASS (``cuobjdump -sass``) with the loads
   and arithmetic it must hold (M7's, the compaction in registers: ``FSETP``
   and ``SHFL`` with no ``LDS``; the fold's, M2's and M3's, from shared
   memory: ``FADD`` and ``LDS`` with no ``LDG``; S2's pair_full ``SHFL``
   with no ``MATCH``, red_a ``REDUX``, tdiv ``I2F``, ``FMUL`` and ``F2I``
   with no ``MUFU`` or ``CALL`` and its second loop, the IEEE route,
   ``FCHK``; S3's kernel ``SHFL``, ``VOTE``, ``ATOMS`` and ``LDS``; M5's
   ``FADD``; M4's ``FADD`` and ``LDG``, at least 11 adds for every float
   loaded; M5's and M4's kernels holding 16-byte global loads and stores),
   its instruction count printed,
   and the S1
   GEMM kernel's main loops holding ``HGMMA`` (the consumers' ``wgmma``) and
   ``UTMALDG`` (the producer's TMA loads), K2's production kernel
   holding ``MATCH`` and ``REDUX`` (its per-key winners), K3's chain loops
   holding ``FMUL``, ``FADD`` and ``LDS`` with no ``FFMA`` or ``LDG`` (the
   bit-exact chain from shared memory), and K4's and K5's per-agent loops
   holding ``SHFL`` and no block barrier; K1's, K2's, K3's, K4's and K5's
   production kernels at their registers (K1's and K4's the mask-0
   instantiations), and they, every stubbed mask of K1 and K4, K2's chest
   instantiation, M7, the fold, M2, M3, M4, S2's eleven instantiations and
   S3's kernel with no stack or local memory; the
   launch shape (registers and shared memory from ``ptxas
   -v``, blocks an SM, the fold's ring stages) of the redesigned K1, K2
   (combat, arena, the chest config), K3, K4, K5, S1 fold, M2, M3, M4 and
   S1 GEMMs;
   ``torch.bmm`` on the S1 GEMMs' operands as the library yardstick;
14. K2's chest phase: the chest config (``scripts/common.py:chest_mission``,
   the basic mission with the catalog's chest station twice; no catalog
   mission reaches K2) at E=4096, agents beside the chests, 20 steps
   through K2 byte-equal to its plain version every step, the count of
   chest uses that moved an item printed and required; the path through
   ``MettaGridEnv.step`` with K2 and one render a step; K2's time on it,
   its plain time and its bound (the K2 entry's ``chest`` in the kernels
   line);
15. the clipped mission (``MISSIONS["clipped"]``) batched at E=4096 with
   ``track_stats=False``: K2 with the regen and clipper tail and K1 or K4,
   GPU against CPU over 10 steps with the same draws (clips and regen ticks
   required), then env-steps/s and the launches of that run;
16. Cogs vs Clips in the sequential step with K5 every step:
   ``training_facility.harvest``, ``evals.diagnostic_chest_deposit_near``
   and ``training_facility.repair`` (start-clipped stations, the clipper),
   GPU against CPU at E=1 and E=1024 over 20 steps with auto-reset, the
   same draws (orders, clipper, desync, reset and template unclip
   protocols) and agents starting beside the stations they probe (chest
   uses and unclips required); harvest's env-steps/s at E=1 and E=1024
   with K5 exactly once a step.

Prints a JSON line of kernels, the card's name and power limit, then as the
last line ``{"ok": true, "device": {...}}``. Exits nonzero, printing no
result, without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import functools
import json
import re
import statistics
from collections import Counter
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

try:
    from metta_tpu_torch.ops.ablate_obs import render_work
    from metta_tpu_torch.ops.timing import (F32_OPS_PER_S, HBM_BYTES_PER_S, bound_of,
                                            cuda_time_ms)
    PORT_MISSING = None
except ImportError as e:          # outside a checkout of the repository: main() refuses
    PORT_MISSING = e

E_MAIN = 4096
AGENTS = 24
SEED = 1234


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


def phase_build(res):
    from metta_tpu_torch.ops import build

    log(f"[card] {card_line()}")
    t0 = time.time()
    res["build_log"] = []

    def keep(text):
        res["build_log"].append(text)
        log(text)
    paths = build.build(log=keep)
    log(f"[build] {sorted(paths)} built in {time.time() - t0:.1f} s")


def render_args(tables):
    return (tables.obs_scan, tables.num_obs_tokens, tables.obs_height // 2,
            tables.obs_width // 2)


def checked_render(err):
    """``render_obs3`` that also runs K1's plain version on the same inputs
    and fails on the first byte that differs; ``err[0]`` keeps the largest
    difference seen."""
    from metta_tpu_torch.ops import obs_render3 as k1

    def render(*args):
        got = k1.render_obs3(*args)
        want = k1.render_obs3_plain(*args)
        torch.cuda.synchronize()
        err[0] = max(err[0], int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version in "
                                 f"{int((got != want).sum())} bytes")
        return got
    return render


def checked_render2(err):
    """``render_obs2`` that also runs K4's plain version on the same inputs
    and fails on the first byte that differs; ``err[0]`` keeps the largest
    difference seen."""
    from metta_tpu_torch.ops import obs_render2 as k4

    def render(*args):
        got = k4.render_obs2(*args)
        want = k4.render_obs2_plain(*args)
        torch.cuda.synchronize()
        err[0] = max(err[0], int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K4 differs from its plain version in "
                                 f"{int((got != want).sum())} bytes")
        return got
    return render


def render2_args(tables):
    from metta_tpu_torch.ops.obs_render2 import rank_table

    return (rank_table(tables.obs_scan, tables.obs_width), tables.num_obs_tokens,
            tables.obs_height, tables.obs_width)


def curriculum_setup(max_steps=None):
    """The arena curriculum over the shaped arena with the map seeded (1234,
    so that every device builds the same tasks): (curriculum, its 16 active
    tasks, their configs)."""
    from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped, make_curriculum

    base = make_arena_basic_easy_shaped(AGENTS)
    base.game.map_builder.seed = SEED
    if max_steps is not None:
        base.game.max_steps = max_steps
    curriculum = make_curriculum(base)
    tasks = curriculum.active_tasks()
    return curriculum, tasks, [t.get_env_cfg() for t in tasks]


def checked_span(err):
    """``fused_span`` that also runs K2's plain version on the same inputs
    and fails on the first output that differs; ``err[0]`` keeps the largest
    difference seen."""
    import dataclasses

    from metta_tpu_torch.ops import sim_fused as k2

    def span(state, actions, rank, tables):
        got = k2.fused_span(state, actions, rank, tables)
        want = k2.fused_span_plain(state, actions, rank, tables)
        torch.cuda.synchronize()
        bad = k2.span_mismatches(got, want)
        pairs = [(getattr(got[0], f.name), getattr(want[0], f.name))
                 for f in dataclasses.fields(got[0])] + list(zip(got[1:], want[1:]))
        for x, y in pairs:
            if x.shape == y.shape and x.numel():
                err[0] = max(err[0], int((x.long() - y.long()).abs().max()))
        if bad:
            raise AssertionError(f"K2 differs from its plain version in {bad}")
        return got
    return span


def phase_k1_vs_plain(res):
    """K1 against its plain version on 20 real steps at E=4096."""
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.engine.step_batched import step_env_batched
    from metta_tpu_torch.ops import obs_render3 as k1

    env = MettaGridEnv(make_cfg(), num_envs=E_MAIN, seed=0, track_stats=True,
                       step_mode="batched", device="cuda")
    env.reset()
    t = env.tables
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = env.state.env
    err = [0]
    render = checked_render(err)
    for i in range(20):
        acts = torch.randint(0, t.n_actions, (E_MAIN, AGENTS), generator=gen, device="cuda")
        state, rew_at_obs = step_env_batched(state, acts, t, generator=gen)
        obs = render(*k1.prep_env3(state, t, state.executed_action, rew_at_obs),
                     *render_args(t))
    tokens = (obs[..., 0] != 255).sum(-1)
    log(f"[k1] byte-equal to the plain version on 20 steps at E={E_MAIN}; "
        f"tokens per agent mean {tokens.float().mean():.1f} max {int(tokens.max())}")
    res["k1_max_abs_err"] = err[0]


def seeded_env(name, n_envs, track_gained=False, seed=5):
    """A ``track_stats=False`` env on the card, reset, with seeded inventories
    (0-3 of each resource) and vibes (the config's attack and transfer vibes
    on a third of the agents each), so that every section of the span fires
    (``scripts/common.py:seeded_span_env``, shared with K2's ablation)."""
    from metta_tpu_torch.scripts.common import seeded_span_env

    return seeded_span_env(name, n_envs, AGENTS, SEED, seed, "cuda", track_gained)


def random_actions(n_envs, n_actions, gen):
    """[E, A] int32: half moves, half any id in [-1, n_actions] (invalid too)."""
    from metta_tpu_torch.scripts.common import span_actions

    return span_actions(n_envs, AGENTS, n_actions, gen)


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
    from metta_tpu_torch.engine.step_batched import batched_step

    err = [0]
    checked = checked_span(err)

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
    res["k2_max_abs_err"] = err[0]


def phase_k4_vs_plain(res):
    """K4 against its plain version on every step of three runs: the
    curriculum env (16 stacked tasks, E=170, the learner's env), make_arena(30)
    (149 block ids) and combat at E=4096, where K1 renders the same inputs
    too; then K4's time per launch at each shape, K1's beside it on combat."""
    from metta_tpu_torch.builder.envs import make_arena
    from metta_tpu_torch.engine import env as env_mod
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.engine.tables import tables_at
    from metta_tpu_torch.engine.taskset import MultiTaskEnv
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops import obs_render3 as k1

    err = [0]
    render2 = env_mod.render_obs2
    env_mod.render_obs2 = checked_render2(err)
    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = {}

    def time_k4(name, args, t, k1_too=False):
        r2 = render2_args(t)
        before, before1 = k4.launches, k1.launches
        entry = dict(
            ms=cuda_time_ms(lambda: k4.render_obs2(*args, *r2), 50),
            host_ms=cuda_time_ms(lambda: k4.render_obs2(*args, *r2), 50, queue_ahead=False),
            plain_ms=cuda_time_ms(lambda: k4.render_obs2_plain(*args, *r2), 3),
        )
        if k1_too:
            entry["k1_ms"] = cuda_time_ms(lambda: k1.render_obs3(*args, *render_args(t)), 50)
        k4.launches, k1.launches = before, before1               # timing only
        nbytes, ops, parts = render_work(args, t.obs_scan, t.num_obs_tokens)
        entry["bound_ms"], entry["bound_by"], _ = bound_of(nbytes, ops)
        entry["mb"] = nbytes / 1e6
        shapes[name] = entry
        log(f"[k4] {name}: {entry['ms']:.4f} ms per launch on the device "
            f"({entry['host_ms']:.4f} ms at the wrapper's host pace), plain "
            f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB "
            f"at 3.35 TB/s, {entry['bound_by']}), {100 * entry['bound_ms'] / entry['ms']:.1f}% "
            f"of the bound" + (f"; K1 on the same inputs {entry['k1_ms']:.4f} ms"
                               if k1_too else ""))

    try:
        _, _, cfgs = curriculum_setup()
        env = MultiTaskEnv(cfgs, num_envs=E_TRAIN, seed=0, track_stats=True, device="cuda")
        env.reset()
        n0 = k4.launches
        for _ in range(20):
            env.step(torch.randint(0, env.compiled.n_actions, (E_TRAIN, AGENTS), generator=gen,
                                   device="cuda"))
        if k4.launches - n0 != 20:
            raise AssertionError(f"the curriculum env rendered {k4.launches - n0} times "
                                 f"through K4 in 20 steps")
        st = env.state
        log(f"[k4] curriculum env E={E_TRAIN}, {len(cfgs)} tasks "
            f"(leaves per env: {sorted(env.tsdata.tables.varying)}): byte-equal to the plain "
            f"version on 20 steps; tasks in use {sorted(set(st.task_id.tolist()))}")
        s = st.env
        args = k1.prep_env3(s, tables_at(env.tsdata.tables, st.task_id), s.executed_action,
                            s.reward)
        time_k4(f"curriculum E={E_TRAIN}", args, env.tables)
        del env, st, s, args

        cfg = make_arena(30)
        cfg.game.map_builder.seed = SEED
        env = MettaGridEnv(cfg, num_envs=E_MAIN, seed=0, track_stats=True, step_mode="batched",
                           device="cuda")
        t = env.tables
        nb = 1 + t.num_agents + t.n_object_types + t.n_assembler_slots + t.n_chest_slots
        env.reset()
        n0 = k4.launches
        for _ in range(20):
            env.step(torch.randint(0, t.n_actions, (E_MAIN, 30), generator=gen, device="cuda"))
        if k4.launches - n0 != 20:
            raise AssertionError("make_arena(30) did not render through K4")
        log(f"[k4] make_arena(30) {t.height}x{t.width}, {nb} block ids, E={E_MAIN}: "
            f"byte-equal to the plain version on 20 steps")
        s = env.state.env
        time_k4(f"arena30 E={E_MAIN}", k1.prep_env3(s, t, s.executed_action, s.reward), t)
        del env, s

        env = MettaGridEnv(make_cfg(), num_envs=E_MAIN, seed=0, track_stats=False,
                           step_mode="batched", device="cuda")
        t = env.tables
        env.reset()
        check = checked_render2(err)
        for _ in range(20):
            obs, *_ = env.step(torch.randint(0, t.n_actions, (E_MAIN, AGENTS), generator=gen,
                                             device="cuda"))
            s = env.state.env
            args = k1.prep_env3(s, t, s.executed_action, s.reward)
            if not torch.equal(check(*args, *render2_args(t)), k1.render_obs3(*args,
                                                                            *render_args(t))):
                raise AssertionError("K4 and K1 differ on combat")
        log(f"[k4] combat E={E_MAIN}: K4 byte-equal to its plain version and to K1 on 20 steps")
        time_k4(f"combat E={E_MAIN}", args, t, k1_too=True)
    finally:
        env_mod.render_obs2 = render2
    res["k4_max_abs_err"] = err[0]
    res["k4_shapes"] = shapes


def phase_gpu_vs_cpu(res):
    """The port on the GPU against the port on the CPU, byte for byte."""
    from metta_tpu_torch.convert import state_to_numpy
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.ops import sim_fused as k2

    E, steps = 8, 30
    for name, track_stats in (("combat", True), ("combat", False), ("cooperation", False)):
        envs = [MettaGridEnv(make_cfg(name), num_envs=E, seed=0, track_stats=track_stats,
                             step_mode="batched", device=d) for d in ("cuda", "cpu")]
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
    multitask_gpu_vs_cpu()


def multitask_gpu_vs_cpu(E=10, steps=24):
    """The multi-task env over the curriculum's 16 tasks (``track_stats`` on,
    episodes of 9 steps, desync on; E=10 fails ``pick_eps``, so K4 renders)
    on the GPU against the CPU, with the same task ids, desync steps, agent
    orders and task draws, a ``set_weights`` and a ``set_task`` mid-run."""
    from metta_tpu_torch.convert import state_to_numpy
    from metta_tpu_torch.engine.taskset import MultiTaskEnv
    from metta_tpu_torch.ops import obs_render2 as k4

    _, _, cfgs = curriculum_setup(max_steps=9)
    K = len(cfgs)
    envs = [MultiTaskEnv(cfgs, num_envs=E, seed=0, desync_episodes=True, track_stats=True,
                         device=d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(8)
    tid, desync = rng.integers(0, K, E), rng.integers(1, 9, E)
    obs = [env.reset(task_id=tid, desync_step=desync) for env in envs]
    if not np.array_equal(*obs):
        raise AssertionError("multi-task reset observations differ between GPU and CPU")
    ended, seen, k4_before = 0, set(tid.tolist()), k4.launches
    for i in range(steps):
        if i == 8:
            w = rng.uniform(0.1, 1.0, K)
            for env in envs:
                env.set_weights(w)
        if i == 12:
            for env in envs:
                env.set_task(3, cfgs[5].model_copy(deep=True))
        acts = rng.integers(0, envs[1].compiled.n_actions, (E, AGENTS))
        perm = torch.as_tensor(np.stack([rng.permutation(AGENTS) for _ in range(E)]))
        draws = rng.integers(0, K, E)
        outs = [env.step(acts, perm=perm, task_draws=draws) for env in envs]
        for field, g, c in zip(("obs", "reward", "done", "truncated"), *outs):
            if not np.array_equal(g, c):
                raise AssertionError(f"multi-task step {i}: {field} differs between GPU and CPU")
        sg, sc = (state_to_numpy(env.state.env) for env in envs)
        for field in sc:
            if not np.array_equal(sg[field], sc[field]):
                raise AssertionError(f"multi-task step {i}: state field {field} differs")
        for field in ("task_id", "last_episode_task", "episodes_done", "desync_step"):
            if not torch.equal(getattr(envs[0].state, field).cpu(), getattr(envs[1].state, field)):
                raise AssertionError(f"multi-task step {i}: {field} differs")
        ended += int((outs[1][2] | outs[1][3]).sum())
        seen |= set(envs[1].state.task_id.tolist())
    if k4.launches - k4_before != steps:
        raise AssertionError(f"K4 launched {k4.launches - k4_before} times in {steps} steps")
    if ended < E:
        raise AssertionError(f"only {ended} episodes ended")
    log(f"[gpu-vs-cpu] multi-task curriculum env, {K} tasks, track_stats=True: state and obs "
        f"byte-identical over {steps} steps at E={E}; {ended} episode ends with task "
        f"resampling ({len(seen)} tasks used), set_weights and set_task mid-run; "
        f"K4 launches {k4.launches - k4_before}")


def profile_steps(run, step_ms, n=10, what="step"):
    """Where a step's device time goes: kernels by total device time over
    a short profiled window of ``n`` calls of ``run``, the torch ops that
    launch them by input shape, and the device's busy share of the
    unprofiled time of one ``what``, ``step_ms`` (the profiler slows the
    host, not the device)."""
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
    log(f"[profile] {n} {what}s: profiled wall {wall_us / 1e3:.1f} ms, device busy "
        f"{dev_us / 1e3:.1f} ms = {dev_step_ms:.3f} ms a {what}, "
        f"{100 * dev_step_ms / step_ms:.1f}% of the unprofiled {what} "
        f"({step_ms:.3f} ms); {sum(r[2] for r in rows)} kernel launches "
        f"= {sum(r[2] for r in rows) / n:.1f} a {what}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / dev_us:5.1f}% x{count:5d} {key[:90]}")
    log("[profile] torch ops by input shape, self device time:")
    for key, shapes, us, count in sorted(ops, key=lambda r: -r[2])[:12]:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / dev_us:5.1f}% x{count:5d} "
            f"{key} {str(shapes)[:80]}")


def warmed_runner(env, gen, acc, warm=10):
    """A function stepping ``env`` n times with random actions, obs consumed
    every step (summed into ``acc``), after ``warm`` warm-up steps."""
    t = env.tables

    def run(n):
        for _ in range(n):
            acts = torch.randint(0, t.n_actions, (env.num_envs, AGENTS), generator=gen,
                                 device="cuda")
            obs, rew, done, trunc = env.step(acts)
            acc.add_(obs.sum(dtype=torch.int64))       # consume every byte of obs

    run(warm)
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

    env = MettaGridEnv(make_cfg(), num_envs=E_MAIN, seed=0, track_stats=False,
                       step_mode="batched", device="cuda")
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
    nbytes, ops, parts = k2.span_work(s, acts, t)
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
    # the same windows with no tokens (every count and global count 0, so every
    # row is all 255)
    empty = (args[0], args[1], torch.zeros_like(args[2]), args[3], torch.zeros_like(args[4]),
             args[5])
    floor1 = cuda_time_ms(lambda: k1.render_obs3(*empty, *render_args(t)), 50)
    k1.launches = before                               # timing launches do not count
    log(f"[k1] with no tokens (every row 255): {floor1:.4f} ms")
    nbytes, ops, parts = render_work(args, t.obs_scan, t.num_obs_tokens)
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
    env = MettaGridEnv(make_cfg(), num_envs=E_MAIN, seed=0, track_stats=True,
                       step_mode="batched", device="cuda")
    env.reset()
    run = warmed_runner(env, gen, acc)
    walls = timed_windows(run, 3, steps)
    wall = statistics.median(walls)
    log(f"[throughput] track_stats=True E={E_MAIN} A={AGENTS}: "
        f"{E_MAIN * steps / wall:.1f} env-steps/s, "
        f"{E_MAIN * steps / wall * AGENTS:.1f} agent-steps/s; "
        f"step {1e3 * wall / steps:.3f} ms (median of 3 windows of {steps} steps; "
        f"windows s {[round(w, 4) for w in walls]})")


BUNDLE = "devops_runs/stable_100m/checkpoints/stable_100m:v48"
E_TRAIN = 170                  # the learner's envs (metta_tpu/devops/stable.py:91-107)


def k3_work(T, B):
    """What K3 must do over [T, B]: (bytes, operations). Reads x and decay
    once and writes out once (4 bytes each); one multiply and one add a step."""
    return 12 * T * B, 2 * T * B


def k3_chain_floor_ms(T):
    """The serial chain's floor, which no bit-exact K3 beats: T dependent
    multiply-then-add pairs (a 4-cycle FMUL, then a 4-cycle FADD) at the
    card's top SM clock (``nvidia-smi``'s clocks.max.sm); None without it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=30)
    try:
        mhz = float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None, None
    return 8 * T / (1e3 * mhz), mhz


def phase_k3_vs_plain(res):
    """K3 against its plain version at the learner's shapes: forward (reverse
    in time) and backward (``autograd.grad`` through the kernel's backward
    against autograd through the plain version), random decays in [0, 1],
    bit for bit; the wrapper refuses bad inputs; times at both shapes."""
    from metta_tpu_torch.ops import discounted_sum as k3

    gen = torch.Generator(device="cuda").manual_seed(7)
    max_err = 0.0
    for T, B in ((255, E_TRAIN * AGENTS), (255, 60)):
        x = torch.randn((T, B), generator=gen, device="cuda")
        decay = torch.rand((T, B), generator=gen, device="cuda")
        w = torch.randn((T, B), generator=gen, device="cuda")
        outs, grads = [], []
        for fn in (k3.discounted_sum, k3.discounted_sum_plain):
            xg, dg = x.clone().requires_grad_(), decay.clone().requires_grad_()
            out = fn(xg, dg)
            grads.append(torch.autograd.grad((out * w).sum(), (xg, dg)))
            outs.append(out.detach())
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in
                ((outs[0], outs[1]), (grads[0][0], grads[1][0]), (grads[0][1], grads[1][1]))]
        max_err = max(max_err, *errs)
        if max(errs) != 0 or not torch.isfinite(outs[0]).all():
            raise AssertionError(f"K3 differs from its plain version at [{T}, {B}]: "
                                 f"out {errs[0]}, gx {errs[1]}, gdecay {errs[2]}")
        log(f"[k3] [{T}, {B}]: forward and backward (gx, gdecay) bit-equal to the plain "
            f"version (max abs err 0); |out| max {float(outs[0].abs().max()):.3f}")
    x = torch.zeros((255, 60), device="cuda")
    for bad in ((x, torch.zeros((255, 61), device="cuda")), (x.t(), x.t()),
                (x, x.double()), (x.cpu(), x.cpu())):
        try:
            k3.launch_discounted_sum(*bad)
        except ValueError:
            continue
        raise AssertionError("K3's wrapper took an input it must refuse")
    res["k3_max_abs_err"] = max_err

    times = {}
    before = k3.launches
    for T, B in ((255, E_TRAIN * AGENTS), (255, 60)):
        x = torch.randn((T, B), generator=gen, device="cuda")
        decay = torch.rand((T, B), generator=gen, device="cuda")
        fwd = cuda_time_ms(lambda: k3.launch_discounted_sum(x, decay), 50)
        bwd = cuda_time_ms(lambda: k3.launch_discounted_sum(x, decay, forward_in_time=True), 50)
        host = cuda_time_ms(lambda: k3.launch_discounted_sum(x, decay), 50, queue_ahead=False)
        plain = cuda_time_ms(lambda: k3.discounted_sum_plain(x, decay), 5)
        nbytes, ops = k3_work(T, B)
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
        times[(T, B)] = dict(ms=fwd, bwd_ms=bwd, plain_ms=plain,
                             bound_ms=max(bytes_ms, ops_ms),
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        floor, mhz = k3_chain_floor_ms(T)             # an estimate: logged, not reported
        log(f"[k3] [{T}, {B}]: forward {fwd:.4f} ms, backward {bwd:.4f} ms a launch on the "
            f"device ({host:.4f} ms a call at the wrapper's host pace), plain {plain:.4f} ms, "
            f"bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s; "
            f"{ops / 1e6:.2f} M float32 ops at 67 T/s = {ops_ms:.5f} ms); the serial chain's "
            f"floor {T} x 8 cycles at {mhz} MHz = "
            + (f"{floor:.4f} ms" if floor is not None else "not measured"))
    k3.launches = before                               # timing launches do not count
    res["k3"] = times


def load_v48():
    from pathlib import Path

    from metta_tpu_torch.rl.checkpoint import load_policy_bundle

    return load_policy_bundle(Path(__file__).resolve().parent / BUNDLE)


def train_cfg():
    from metta_tpu_torch.builder.envs import make_arena_basic_easy_shaped

    cfg = make_arena_basic_easy_shaped(AGENTS)
    cfg.game.map_builder.seed = SEED
    return cfg


def phase_policy(res):
    """The v48 policy on the GPU against the CPU at float32 (TF32 off) on real
    arena observations, step and segment mode; the bf16 default beside it."""
    import dataclasses

    from metta_tpu_torch.engine.env import MettaGridEnv

    sd, cfg, _ = load_v48()
    env = MettaGridEnv(train_cfg(), num_envs=8, seed=0, track_stats=False, step_mode="batched",
                       device="cuda")
    env.reset()
    gen = torch.Generator(device="cuda").manual_seed(4)
    for _ in range(12):
        obs, *_ = env.step(torch.randint(0, env.compiled.n_actions, (8, AGENTS),
                                         generator=gen, device="cuda"))
    obs = obs.reshape(-1, *obs.shape[2:])                                  # [192, 200, 3]
    seq = obs.reshape(4, -1, *obs.shape[1:])                               # [4, 48, 200, 3]
    norms = env.compiled.feature_normalizations
    outs = {}
    for name, dtype, dev in (("f32 cpu", "float32", "cpu"), ("f32 gpu", "float32", "cuda"),
                             ("bf16 cpu", "bfloat16", "cpu"), ("bf16 gpu", "bfloat16", "cuda")):
        pol = dataclasses.replace(cfg, compute_dtype=dtype).make(env.compiled.n_actions, norms)
        pol.load_state_dict(sd)
        pol = pol.to(dev)
        with torch.no_grad():
            step = pol(obs.to(dev), pol.initial_state(obs.shape[0], dev))
            segment = pol(seq.to(dev), pol.initial_state(seq.shape[1], dev))
        outs[name] = [t.float().cpu() for t in (*step[:3], *step[3], *segment[:3])]
    tol, tol_bf16 = 1e-4, 5e-2
    err = max(float((a - b).abs().max()) for a, b in zip(outs["f32 gpu"], outs["f32 cpu"]))
    # bf16: each output's largest difference over its largest magnitude (the
    # CPU tests hold the port's bf16 policy to flax's within the same 5e-2)
    err_bf16 = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(outs["bf16 gpu"], outs["bf16 cpu"]))
    gap_bf16 = max(float((a - b).abs().max()) for a, b in zip(outs["bf16 gpu"], outs["f32 gpu"]))
    finite = all(torch.isfinite(t).all() for o in outs.values() for t in o)
    log(f"[policy] v48 on {obs.shape[0]} arena obs, step and segment [4, 48]: f32 GPU vs CPU "
        f"max abs diff {err:.3e} (tolerance {tol:g}, TF32 off); bf16 GPU vs bf16 CPU "
        f"{err_bf16:.3e} of each output's largest magnitude (tolerance {tol_bf16:g}); "
        f"bf16 GPU vs f32 GPU max abs diff {gap_bf16:.3e} (logged); "
        f"logits std {float(outs['f32 gpu'][0].std()):.3f}")
    if err > tol or err_bf16 > tol_bf16 or not finite:
        raise AssertionError(f"policy on the GPU differs from the CPU by {err} (f32), "
                             f"{err_bf16} (bf16)")
    res["policy_gpu_cpu_err"] = err


def phase_train(res):
    """The single-task learner: ``Trainer`` on the shaped arena, E=170, 24
    agents, default ``TrainerConfig``, the v48 ViT (``"lstm"`` core, bf16)
    from its weights; one warm-up ``update``, then one update through
    ``train``; K4 (E=170 fails ``pick_eps``, so K4 renders, as in the JAX
    env), K2 and K3 launches, agent-steps/s, the rollout/learn split, peak
    memory; finite metrics, changed parameters, ``hardware_sanity``."""
    from metta_tpu_torch.ops import discounted_sum as k3
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops import obs_render3 as k1
    from metta_tpu_torch.ops import sim_fused as k2
    from metta_tpu_torch.rl.config import TrainerConfig
    from metta_tpu_torch.rl.trainer import Trainer

    sd, cfg, _ = load_v48()
    tr = Trainer(train_cfg(), TrainerConfig(num_envs=E_TRAIN), cfg, device="cuda")
    log(f"[train] E={tr.E} A={tr.A} B={tr.B} T={tr.T}: {tr.rows_per_mb} rows a minibatch, "
        f"{tr.n_minibatches} minibatches, {tr.layout.size} parameters, "
        f"compute {cfg.compute_dtype}, core {cfg.core}")
    ts = tr.init_state(params=sd)
    p0 = ts.params.clone()
    t0 = time.perf_counter()
    ts, _ = tr.update(ts)
    torch.cuda.synchronize()
    log(f"[train] warm-up update {time.perf_counter() - t0:.2f} s")

    split = {"rollout": [], "learn": []}               # seconds of each timed update

    def timed(attr, name):
        fn = getattr(tr, attr)

        def run(*args):
            torch.cuda.synchronize()
            a = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            split[name].append(time.perf_counter() - a)
            split[name + " out"] = out
            return out
        return run

    tr._rollout = timed("_rollout", "rollout")
    tr._learn_phase = timed("_learn_phase", "learn")
    logs = []
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = k3.launches = k4.launches = 0  # the training path's run starts
    t0 = time.perf_counter()
    ts = tr.train(total_timesteps=tr.B * tr.T, ts=ts, log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": k1.launches, "k2": k2.launches, "k3": k3.launches,
                "k4": k4.launches}                     # ... and ends
    del tr._rollout, tr._learn_phase
    peak = torch.cuda.max_memory_allocated()
    for k, want in (("k1", 0), ("k4", tr.T), ("k2", tr.T), ("k3", 1 + 2 * tr.n_minibatches)):
        if launches[k] != want:
            raise AssertionError(f"{k.upper()} launched {launches[k]} times in one update, "
                                 f"expected {want}")
    sps = tr.B * tr.T / wall
    log(f"[train] one update in {wall:.2f} s: {sps:.1f} agent-steps/s "
        f"(train's own sps {logs[-1]['sps']:.1f}); rollout s "
        f"{[round(r, 3) for r in split['rollout']]}, learn s "
        f"{[round(r, 3) for r in split['learn']]}; peak memory "
        f"{peak / 2**30:.2f} GiB; launches per update K4 {launches['k4']}, K1 "
        f"{launches['k1']}, K2 {launches['k2']}, K3 {launches['k3']}")
    for m in logs:
        log("[train] metrics " + json.dumps({k: round(v, 6) for k, v in m.items()}))
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"metrics not finite: {bad}")
    moved = float((ts.params - p0).abs().max())
    if not moved > 0:
        raise AssertionError("parameters did not change")
    log(f"[train] parameters moved by up to {moved:.3e} over two updates")
    res["train_sps"] = sps

    # where the time goes: the env alone at E=170, and one learner minibatch
    # (loss, backward, optimizer) under the profiler
    env, vstate = tr.env, split["rollout out"][0].vstate
    gen = torch.Generator(device="cuda").manual_seed(9)

    def env_steps(n):
        nonlocal vstate
        for _ in range(n):
            acts = torch.randint(0, tr.env.compiled.n_actions, (tr.E, tr.A), generator=gen,
                                 device="cuda", dtype=torch.int32)
            vstate = env.step_state(vstate, acts)[0]
    env_ms = 1e3 * statistics.median(timed_windows(env_steps, 3, 20)) / 20
    rollout_ms = 1e3 * statistics.median(split["rollout"]) / tr.T
    log(f"[train] rollout {rollout_ms:.3f} ms a step, of which the env step alone "
        f"{env_ms:.3f} ms (median of 3 windows of 20 steps) and the policy step, "
        f"sampling and trajectory writes about {rollout_ms - env_ms:.3f} ms")
    traj = split["rollout out"][1]
    rows = torch.arange(tr.rows_per_mb, device="cuda")
    mb = {k: getattr(traj, k).index_select(1, rows)
          for k in ("obs", "actions", "logprob", "value", "reward", "done")}
    mb["advantages"] = torch.zeros_like(mb["value"])
    hp = tr.default_hp()

    def minibatches(n):
        for _ in range(n):
            p = ts.params.detach().requires_grad_()
            loss, _ = tr._loss_fn(p, mb, hp)
            (g,) = torch.autograd.grad(loss, p)
            tr.tx.update(g, ts.opt_state, ts.params)
    minibatches(1)
    profile_steps(minibatches, 1e3 * statistics.median(split["learn"]) / tr.n_minibatches,
                  n=2, what="minibatch")

    inv = ts.vstate.env.agent_inv.sum(dim=(0, 1)).cpu().numpy()
    names = tr.env.compiled.resource_names
    by_name = {n: int(inv[i]) for i, n in enumerate(names) if inv[i]}
    ore_ok = any(n.startswith("ore") and v > 0 for n, v in by_name.items())
    conv_ok = any((n.startswith("battery") or n in ("heart", "armor", "laser")) and v > 0
                  for n, v in by_name.items())
    log(f"[sanity] training env hardware_sanity {'ok' if ore_ok and conv_ok else 'FAIL'}: "
        f"inventories {by_name}")
    if not (ore_ok and conv_ok):
        raise AssertionError("conversion chain dead in the training env")

    learner_kernels_vs_plain(tr, ts.vstate, split["rollout out"][1], res)



def learner_kernels_vs_plain(tr, vstate, traj, res):
    """K4 and K2 on the learner's own env (the shaped arena, E=170,
    ``track_stats=False``), stepped 20 times from the trainer's last state
    through ``step_state`` as the rollout steps it, and K3 on the rollout's
    own values, rewards and done flags (the advantages, [255, 4080], and one
    minibatch's TD(λ) targets with their gradient, [255, 60]): each kernel
    against its plain version on the same inputs, bit for bit."""
    from metta_tpu_torch.engine import env as env_mod
    from metta_tpu_torch.engine.step_batched import batched_step
    from metta_tpu_torch.ops import discounted_sum as k3
    from metta_tpu_torch.ops.sim_fused import fused_step_full
    from metta_tpu_torch.rl import advantage

    env = tr.env
    if env._sim_step is not fused_step_full or tr.cfg.track_env_stats:
        raise AssertionError("the learner's env does not step through the fused span")
    e1, e2 = [0], [0]
    span = checked_span(e2)
    render = env_mod.render_obs2
    env._sim_step = lambda s, a, t, perm=None, generator=None, clip_draws=None: batched_step(
        s, a.to(torch.int32), t, span, perm, generator, clip_draws)
    env_mod.render_obs2 = checked_render2(e1)
    gen = torch.Generator(device="cuda").manual_seed(11)
    ended = 0
    try:
        for _ in range(20):
            acts = torch.randint(0, env.compiled.n_actions, (tr.E, tr.A), generator=gen,
                                 device="cuda", dtype=torch.int32)
            vstate, _, _, done, trunc = env.step_state(vstate, acts)
            ended += int((done | trunc).sum())
    finally:
        env._sim_step, env_mod.render_obs2 = fused_step_full, render
    res["k4_max_abs_err"] = max(res.get("k4_max_abs_err", 0), e1[0])
    res["k2_max_abs_err"] = max(res.get("k2_max_abs_err", 0), e2[0])

    a = tr.cfg.advantage
    cols = torch.arange(tr.rows_per_mb, device="cuda")
    v, r, d = traj.value, traj.reward, traj.done
    w = torch.randn((tr.T, tr.rows_per_mb), generator=gen, device="cuda")
    outs = []
    try:
        for fn in (k3.discounted_sum, k3.discounted_sum_plain):
            advantage.discounted_sum = fn
            adv = advantage.puff_advantage(v, r, d, torch.ones_like(v), a.gamma, a.gae_lambda,
                                           a.vtrace_rho_clip, a.vtrace_c_clip)
            vg = v.index_select(1, cols).requires_grad_()
            dl = advantage.compute_delta_lambda(vg, r.index_select(1, cols),
                                                d.index_select(1, cols), a.gamma, a.gae_lambda)
            (g,) = torch.autograd.grad((dl * w).sum(), vg)
            outs.append((adv, dl.detach(), g))
    finally:
        advantage.discounted_sum = k3.discounted_sum
    torch.cuda.synchronize()
    errs = [float((x - y).abs().max()) for x, y in zip(*outs)]
    res["k3_max_abs_err"] = max(res.get("k3_max_abs_err", 0.0), *errs)
    if max(errs) != 0:
        raise AssertionError(f"K3 differs from its plain version on the learner's data: "
                             f"advantages {errs[0]}, TD(λ) targets {errs[1]}, gradient {errs[2]}")
    log(f"[learner-check] K4 and K2 byte-equal to their plain versions on 20 steps of the "
        f"learner's env (shaped arena, E={tr.E}, track_stats=False, {ended} episode ends); "
        f"K3 bit-equal on the rollout's advantages [{tr.T - 1}, {tr.B}] and on a minibatch's "
        f"TD(λ) targets and their gradient [{tr.T - 1}, {tr.rows_per_mb}] "
        f"(|adv| max {float(outs[0][0].abs().max()):.3f})")


def curriculum_sync(curriculum, env, slots, vstate):
    """The curriculum between two updates, as ``metta_tpu/tools/train.py:
    225-250`` drives it: each slot's score (the mean per-step reward of the
    envs' last finished episodes of that task) to ``update_task_performance``,
    evicted slots refilled by ``set_task``, the weights by ``set_weights``.
    One task is spawned first, so that the pool overflows and the
    curriculum's own rule evicts one (its pool never grows by itself).
    Returns {task id: score}."""
    ep_len = vstate.episode_len.cpu().numpy()
    ep_task = vstate.last_episode_task.cpu().numpy()
    ep_rew = vstate.last_episode_reward.mean(1).cpu().numpy()
    curriculum._spawn_task()
    scores = {}
    for k, t in enumerate(slots):
        m = (ep_task == k) & (ep_len > 0)
        if m.any():
            scores[t.task_id] = float((ep_rew[m] / np.maximum(ep_len[m], 1)).mean())
            curriculum.update_task_performance(t.task_id, scores[t.task_id])
    live = {t.task_id: t for t in curriculum.active_tasks()}
    in_slots = {t.task_id for t in slots}
    fresh_pool = [t for tid, t in live.items() if tid not in in_slots]
    for k, t in enumerate(slots):
        if t.task_id not in live and fresh_pool:
            new_t = fresh_pool.pop()
            env.set_task(k, new_t.get_env_cfg())
            log(f"[curriculum] slot {k}: task {t.task_id} evicted, task {new_t.task_id} in "
                f"its place ({new_t.get_slice_values()})")
            slots[k] = new_t
    env.set_weights(curriculum.task_weights([t.task_id for t in slots]))
    return scores


def phase_curriculum(res):
    """This slice's main path, the arena curriculum learner at
    ``arena_100m``'s shape: ``Trainer`` over the curriculum's 16 tasks
    (``MultiTaskEnv``, E=170, 24 agents, ``track_env_stats=True``, the
    default ``TrainerConfig``: bptt 256, minibatch 16,384, GTD(λ),
    schedule-free AdamW), the v48 ViT (``"lstm"`` core, bf16) from its
    weights; one warm-up update, then two timed updates with a curriculum
    sync between them. K4 = 256 and K3 = 137 launches an update, K1 = K2 = 0;
    agent-steps/s, the rollout/learn split, peak memory, each task's score;
    finite metrics, moved parameters; the env step alone and its profile."""
    from metta_tpu_torch.engine.taskset import MultiTaskEnv
    from metta_tpu_torch.ops import discounted_sum as k3
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops import obs_render3 as k1
    from metta_tpu_torch.ops import sim_fused as k2
    from metta_tpu_torch.rl.config import TrainerConfig
    from metta_tpu_torch.rl.trainer import Trainer

    sd, cfg, _ = load_v48()
    curriculum, tasks, cfgs = curriculum_setup()
    tr = Trainer(None, TrainerConfig(num_envs=E_TRAIN, track_env_stats=True), cfg,
                 device="cuda", task_cfgs=cfgs)
    if not isinstance(tr.env, MultiTaskEnv):
        raise AssertionError("the curriculum trainer does not step a MultiTaskEnv")
    slots = list(tasks)
    tr.env.set_weights(curriculum.task_weights([t.task_id for t in slots]))
    log(f"[curriculum] E={tr.E} A={tr.A} B={tr.B} T={tr.T}, {len(slots)} tasks "
        f"(leaves read per env: {sorted(tr.env.tsdata.tables.varying)}), "
        f"{tr.n_minibatches} minibatches of {tr.rows_per_mb} rows")
    ts = tr.init_state(params=sd)
    p0 = ts.params.clone()
    t0 = time.perf_counter()
    ts, _ = tr.update(ts)
    torch.cuda.synchronize()
    log(f"[curriculum] warm-up update {time.perf_counter() - t0:.2f} s")

    split = {"rollout": [], "learn": []}
    rollout, learn = tr._rollout, tr._learn_phase

    def timed(fn, name):
        def run(*args):
            torch.cuda.synchronize()
            a = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            split[name].append(time.perf_counter() - a)
            return out
        return run

    tr._rollout, tr._learn_phase = timed(rollout, "rollout"), timed(learn, "learn")
    torch.cuda.reset_peak_memory_stats()
    walls, metrics, scores = [], [], {}
    k1.launches = k2.launches = k3.launches = k4.launches = 0   # the main path's run starts
    for i in range(2):
        if i == 1:
            a = time.perf_counter()
            scores = curriculum_sync(curriculum, tr.env, slots, ts.vstate)
            sync_s = time.perf_counter() - a
        a = time.perf_counter()
        ts, m = tr.update(ts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - a)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {"k1": k1.launches, "k2": k2.launches, "k3": k3.launches,
                "k4": k4.launches}                     # ... and ends
    tr._rollout, tr._learn_phase = rollout, learn
    peak = torch.cuda.max_memory_allocated()
    for k, want in (("k4", 2 * tr.T), ("k3", 2 * (1 + 2 * tr.n_minibatches)), ("k1", 0),
                    ("k2", 0)):
        if launches[k] != want:
            raise AssertionError(f"{k.upper()} launched {launches[k]} times in two updates, "
                                 f"expected {want}")
    sps = 2 * tr.B * tr.T / sum(walls)
    log(f"[curriculum] two updates in {sum(walls):.2f} s ({[round(w, 3) for w in walls]}): "
        f"{sps:.1f} agent-steps/s; rollout s {[round(r, 3) for r in split['rollout']]}, "
        f"learn s {[round(r, 3) for r in split['learn']]}; curriculum sync {sync_s:.3f} s; "
        f"peak memory {peak / 2**30:.2f} GiB; launches per update K4 {launches['k4'] / 2:.0f}, "
        f"K3 {launches['k3'] / 2:.0f}, K1 {launches['k1']}, K2 {launches['k2']}")
    log(f"[curriculum] task scores after the first update ({len(scores)} of {len(slots)} "
        f"tasks had a finished episode): "
        + json.dumps({str(k): round(v, 6) for k, v in scores.items()}))
    log(f"[curriculum] weights {[round(w, 4) for w in tr.env.tsdata.weights.tolist()]}; "
        f"episodes finished {int(ts.vstate.episodes_done.sum())}; tasks in use "
        f"{len(set(ts.vstate.task_id.tolist()))}")
    for m in metrics:
        log("[curriculum] metrics " + json.dumps({k: round(v, 6) for k, v in m.items()}))
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"metrics not finite: {bad}")
    moved = float((ts.params - p0).abs().max())
    if not moved > 0:
        raise AssertionError("parameters did not change")
    log(f"[curriculum] parameters moved by up to {moved:.3e} over three updates")
    res["curriculum_sps"] = sps

    # where the time goes: the multi-task env step alone, and its profile
    env, vstate = tr.env, ts.vstate
    gen = torch.Generator(device="cuda").manual_seed(12)

    def env_steps(n):
        nonlocal vstate
        for _ in range(n):
            acts = torch.randint(0, env.compiled.n_actions, (tr.E, tr.A), generator=gen,
                                 device="cuda", dtype=torch.int32)
            vstate = env.step_state(vstate, acts)[0]
    env_ms = 1e3 * statistics.median(timed_windows(env_steps, 3, 20)) / 20
    rollout_ms = 1e3 * statistics.median(split["rollout"]) / tr.T
    log(f"[curriculum] rollout {rollout_ms:.3f} ms a step, of which the env step alone "
        f"{env_ms:.3f} ms (median of 3 windows of 20 steps) and the policy step, "
        f"sampling and trajectory writes about {rollout_ms - env_ms:.3f} ms")
    profile_steps(env_steps, env_ms, n=5, what="multi-task env step")

    k3_shapes = [dict(shape=[tr.T - 1, n], launches=count, **res["k3"][(tr.T - 1, n)])
                 for n, count in ((tr.B, 2), (tr.rows_per_mb, launches["k3"] - 2))]
    head = max(k3_shapes, key=lambda e: e["launches"])
    k4_shapes = [dict(shape=name, **{k: v for k, v in e.items()})
                 for name, e in res["k4_shapes"].items()]
    main4 = res["k4_shapes"][f"curriculum E={E_TRAIN}"]
    res["kernels"] += [{
        "name": "discounted_sum",
        "route": "cuda",
        "source": "metta_tpu_torch/csrc/discounted_sum.cu",
        "replaces": "metta_tpu/ops/discounted_sum.py:32",
        "launches": launches["k3"],
        "max_abs_err": res.get("k3_max_abs_err"),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": head["shape"],
        "shapes": k3_shapes,
    }, {
        "name": "obs_render2",
        "route": "cuda",
        "source": "metta_tpu_torch/csrc/obs_render2.cu",
        "replaces": "metta_tpu/ops/obs_render2.py:48",
        "launches": launches["k4"],
        "max_abs_err": res.get("k4_max_abs_err"),
        "ms": main4["ms"],
        "plain_ms": main4["plain_ms"],
        "bound_ms": main4["bound_ms"],
        "bound_by": main4["bound_by"],
        "library_ms": None,
        "shape": f"curriculum E={E_TRAIN}",
        "shapes": k4_shapes,
    }]


# ---------------------------------------------------------------------------
# the sequential step and K5 (the v1 per-env render)
# ---------------------------------------------------------------------------


def seq_env(n_envs, name="combat", agents=AGENTS, renderer="pl", device="cuda", **kw):
    """The sequential env (the default step mode) over ``make_<name>(agents)``
    with the map seeded, rendering through ``obs_renderer`` (set after
    construction, as ``metta_tpu/scripts/hlo_census.py`` sets it)."""
    from metta_tpu_torch.builder import envs
    from metta_tpu_torch.engine.env import MettaGridEnv

    cfg = getattr(envs, f"make_{name}")(agents)
    cfg.game.map_builder.seed = SEED
    env = MettaGridEnv(cfg, num_envs=n_envs, seed=0, device=device, **kw)
    if env.step_mode != "sequential":
        raise AssertionError(f"{name} at E={n_envs} does not take the sequential step")
    env.tables.obs_renderer = renderer
    return env


def k5_args(tables):
    return (tables.obs_scan, tables.num_obs_tokens, tables.obs_height // 2,
            tables.obs_width // 2)


def k5_work(args, scan, T):
    """What K5 must do for these inputs: (bytes, operations, parts in bytes).

    Each output byte is written once. Each input byte the render needs is
    read once: the distinct in-map cells of the windows from the agent plane,
    and from the static plane where no agent stands (K5 reads every window
    cell: its prefix sum runs over all of them), the count of each distinct
    block those cells hold and the tokens taken from it before T, the
    agents' positions, global-token counts and global tokens, the window
    offsets. Operations: one add per window cell (the prefix sum) and one
    select per output slot."""
    agent_grid, sblock, tok, counts, rc, g_count, g_tok = args
    E, H, W = agent_grid.shape
    A, NB, S, G = rc.shape[1], tok.shape[1], scan.shape[0], g_tok.shape[2]
    rr = rc[..., 0:1].long() + scan[:, 0].long()                        # [E, A, S]
    cc = rc[..., 1:2].long() + scan[:, 1].long()
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = (rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)).reshape(E, -1)
    a1 = torch.where(inb, agent_grid.reshape(E, -1).gather(1, flat).reshape(E, A, S), 0).long()
    st = sblock.reshape(E, -1).gather(1, flat).reshape(E, A, S).long()
    b = torch.where(inb, torch.where(a1 > 0, a1, st), 0)
    n = counts.gather(1, b.reshape(E, -1)).reshape(E, A, S).long()
    start = g_count.long().clamp(max=T)[..., None] + n.cumsum(-1) - n
    taken = torch.where(inb, torch.minimum(n, T - start).clamp(min=0), 0)

    def distinct(mask):
        cells = torch.zeros((E, H * W + 1), dtype=torch.int8, device=rc.device)
        cells.scatter_(1, torch.where(mask, flat.reshape(E, A, S), H * W).reshape(E, -1), 1)
        return int(cells[:, :H * W].sum())

    blocks = torch.zeros((E, NB), dtype=torch.int64, device=rc.device)
    blocks.scatter_reduce_(1, b.reshape(E, -1), torch.where(inb, taken + 1, 0).reshape(E, -1),
                           reduce="amax")                             # 1 + tokens taken
    parts = {
        "agent plane": 4 * distinct(inb),
        "static plane": 4 * distinct(inb & (a1 == 0)),
        "counts": 4 * int((blocks > 0).sum()),
        "tokens": 2 * int((blocks - 1).clamp(min=0).sum()),
        "rc+gcnt": 12 * E * A,
        "gtok": 3 * int(g_count.long().clamp(max=min(G, T)).sum()),
        "scan": 8 * S,
        "out": 3 * E * A * T,
    }
    return sum(parts.values()), E * A * S + E * A * T, parts


def checked_render1(err):
    """``render_obs1`` that also runs K5's plain version on the same inputs
    and fails on the first byte that differs; ``err[0]`` keeps the largest
    difference seen."""
    from metta_tpu_torch.ops import obs_render as k5

    launch = k5.render_obs1

    def render(*args):
        got = launch(*args)
        want = k5.render_obs1_plain(*args)
        torch.cuda.synchronize()
        err[0] = max(err[0], int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K5 differs from its plain version in "
                                 f"{int((got != want).sum())} bytes")
        return got
    return render


def phase_k5_vs_plain(res):
    """K5 against its plain version on every step of the sequential env's
    own renders: combat (24 agents) at E=1, 10 and 4096, and make_arena(30)
    (149 block ids) at E=1024; ``initial_observations`` through K5 against
    the plain renderer; K5's time per launch, its host pace, its plain
    version's time and its bound at each shape."""
    from metta_tpu_torch.engine.step import initial_observations
    from metta_tpu_torch.ops import obs_render as k5

    err = [0]
    launch = k5.render_obs1
    k5.render_obs1 = checked_render1(err)
    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = {}
    try:
        for name, agents, n_envs, steps in (("combat", AGENTS, 1, 20), ("combat", AGENTS, 10, 20),
                                            ("combat", AGENTS, E_MAIN, 6),
                                            ("arena", 30, 1024, 6)):
            env = seq_env(n_envs, name, agents)
            t = env.tables
            env.reset()
            n0 = k5.launches
            for _ in range(steps):
                env.step(torch.randint(0, t.n_actions, (n_envs, agents), generator=gen,
                                       device="cuda"))
            if k5.launches - n0 != steps:
                raise AssertionError(f"{name} E={n_envs}: K5 rendered {k5.launches - n0} of "
                                     f"{steps} sequential steps")
            s = env.state.env
            args = k5.prep_obs1(s, t, s.executed_action, s.reward)
            extra = k5_args(t)
            tokens = (launch(*args, *extra)[..., 0] != 255).sum(-1)
            before = k5.launches
            entry = dict(
                ms=cuda_time_ms(lambda: launch(*args, *extra), 50),
                host_ms=cuda_time_ms(lambda: launch(*args, *extra), 50, queue_ahead=False),
                plain_ms=cuda_time_ms(lambda: k5.render_obs1_plain(*args, *extra), 3),
            )
            k5.launches = before                       # timing launches do not count
            nbytes, ops, parts = k5_work(args, t.obs_scan, t.num_obs_tokens)
            entry["bound_ms"], entry["bound_by"], ops_ms = bound_of(nbytes, ops)
            entry["mb"] = nbytes / 1e6
            key = f"{name} E={n_envs}"
            shapes[key] = entry
            nb = 1 + t.num_agents + t.n_object_types + t.n_assembler_slots + t.n_chest_slots
            log(f"[k5] {key} ({t.height}x{t.width}, {nb} block ids): byte-equal to the plain "
                f"version on {steps} sequential steps; tokens per agent mean "
                f"{tokens.float().mean():.1f} max {int(tokens.max())}; "
                f"{entry['ms']:.4f} ms per launch on the device ({entry['host_ms']:.4f} ms at "
                f"the wrapper's host pace), plain {entry['plain_ms']:.4f} ms, bound "
                f"{entry['bound_ms']:.4f} ms ({nbytes / 1e6:.3f} MB at 3.35 TB/s "
                f"{ {k: round(v / 1e6, 3) for k, v in parts.items()} } MB, {ops / 1e6:.2f} M "
                f"int32 ops = {ops_ms:.4f} ms, {entry['bound_by']}), "
                f"{100 * entry['bound_ms'] / entry['ms']:.1f}% of the bound")
            if name == "combat" and n_envs == 10:
                # the reset template's render through K5 against the plain renderer
                template = env._template[0]
                got = initial_observations(template, t)
                t.obs_renderer = "ref"
                want = initial_observations(template, t)
                t.obs_renderer = "pl"
                if not torch.equal(got, want) or not torch.equal(got, env._template[1]):
                    raise AssertionError("initial_observations through K5 differ from the "
                                         "plain renderer")
                log("[k5] initial_observations through K5 byte-equal to the plain renderer "
                    "and to the env's reset template")
            del env, s, args
    finally:
        k5.render_obs1 = launch
    res["k5_max_abs_err"] = err[0]
    res["k5_shapes"] = shapes


def sequential_gpu_vs_cpu(E=8, steps=30):
    """The sequential env on the GPU against the CPU, byte for byte, with
    the same agent orders and desync draws, through auto-reset: combat with
    ``obs_renderer="pl"`` (K5 on the card), and the arena with a shared limit
    group over laser and armor, asked for ``step_mode="batched"`` and taken
    into the sequential step (its default renderer)."""
    from metta_tpu_torch.config.mettagrid_config import ResourceLimitsConfig
    from metta_tpu_torch.convert import state_to_numpy
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.ops import obs_render as k5

    def gear(device):
        from metta_tpu_torch.builder.envs import make_arena

        cfg = make_arena(12)
        cfg.game.map_builder.seed = SEED
        cfg.game.max_steps = 12
        cfg.game.agent.inventory.limits["gear"] = ResourceLimitsConfig(
            limit=2, resources=["laser", "armor"])
        return MettaGridEnv(cfg, num_envs=E, seed=0, step_mode="batched", device=device)

    for label, make in (("combat pl", lambda d: seq_env(E, device=d)), ("gear arena", gear)):
        envs = [make(d) for d in ("cuda", "cpu")]
        if any(env.step_mode != "sequential" for env in envs):
            raise AssertionError(f"{label}: not the sequential step")
        A = envs[1].num_agents
        rng = np.random.default_rng(14)
        desync = rng.integers(1, steps, E)
        obs = [env.reset(desync_step=desync) for env in envs]
        if not torch.equal(obs[0].cpu(), obs[1]):
            raise AssertionError(f"{label}: reset observations differ between GPU and CPU")
        ended, k5_before = 0, k5.launches
        for i in range(steps):
            acts = rng.integers(0, envs[1].tables.n_actions, (E, A))
            perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(E)]))
            outs = [env.step(acts, perm=perm) for env in envs]
            for field, g, c in zip(("obs", "reward", "done", "truncated"), *outs):
                if not torch.equal(g.cpu(), c):
                    raise AssertionError(f"{label} step {i}: {field} differs between GPU and CPU")
            ended += int((outs[1][2] | outs[1][3]).sum())
            sg, sc = state_to_numpy(envs[0].state), state_to_numpy(envs[1].state)
            for field in sc["env"]:
                if not np.array_equal(sg["env"][field], sc["env"][field]):
                    raise AssertionError(f"{label} step {i}: state field {field} differs")
        k5_runs = k5.launches - k5_before
        want = steps if envs[0].tables.obs_renderer == "pl" else 0
        if k5_runs != want or ended < E:
            raise AssertionError(f"{label}: K5 launched {k5_runs} times in {steps} steps, "
                                 f"{ended} episode ends")
        log(f"[gpu-vs-cpu] sequential {label} (inv_vector_ok={envs[1].tables.inv_vector_ok}, "
            f"obs_renderer={envs[1].tables.obs_renderer}): state and obs byte-identical over "
            f"{steps} steps at E={E}; {ended} episode ends (auto-reset); K5 launches {k5_runs}")


def phase_sequential(res):
    """This slice's main path: the sequential env (combat, 24 agents,
    ``obs_renderer="pl"``) at E=4096 and E=1, ``MettaGridEnv.step`` with obs
    consumed: env-steps/s (median of 3 windows after warm-up), K5 exactly
    once a step and K1 = K2 = K4 = 0 over the timed steps, launches and the
    device's busy share of a profiled step; then the GPU-against-CPU runs."""
    from metta_tpu_torch.ops import obs_render as k5
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops import obs_render3 as k1
    from metta_tpu_torch.ops import sim_fused as k2

    gen = torch.Generator(device="cuda").manual_seed(15)
    acc = torch.zeros((), dtype=torch.int64, device="cuda")
    runs = {}
    for n_envs, steps in ((E_MAIN, 4), (1, 10)):
        env = seq_env(n_envs)
        env.reset()
        run = warmed_runner(env, gen, acc, warm=2)
        k1.launches = k2.launches = k4.launches = k5.launches = 0   # the main path's run starts
        walls = timed_windows(run, 3, steps)
        launches = {"k1": k1.launches, "k2": k2.launches, "k4": k4.launches,
                    "k5": k5.launches}                              # ... and ends
        if launches != {"k1": 0, "k2": 0, "k4": 0, "k5": 3 * steps}:
            raise AssertionError(f"sequential E={n_envs}: launches in {3 * steps} steps "
                                 f"{launches}, expected K5 once a step and no other render")
        wall = statistics.median(walls)
        sps = n_envs * steps / wall
        runs[n_envs] = dict(env_steps_per_s=sps, step_ms=1e3 * wall / steps, launches=launches)
        log(f"[sequential] combat E={n_envs} A={AGENTS} obs_renderer=pl: {sps:.1f} env-steps/s, "
            f"{sps * AGENTS:.1f} agent-steps/s; step {1e3 * wall / steps:.3f} ms (median of 3 "
            f"windows of {steps} steps; windows s {[round(w, 4) for w in walls]}); launches in "
            f"{3 * steps} steps: K5 {launches['k5']}, K1 {launches['k1']}, K2 {launches['k2']}, "
            f"K4 {launches['k4']}; obs checksum {int(acc)}")
        profile_steps(run, 1e3 * wall / steps, n=2, what=f"sequential step at E={n_envs}")
        del env, run
    res["sequential"] = runs
    sequential_gpu_vs_cpu()

    main = res["k5_shapes"][f"combat E={E_MAIN}"]
    res.setdefault("kernels", []).append({
        "name": "obs_render",
        "route": "cuda",
        "source": "metta_tpu_torch/csrc/obs_render.cu",
        "replaces": "metta_tpu/ops/obs_render.py:39",
        "launches": runs[E_MAIN]["launches"]["k5"],
        "max_abs_err": res.get("k5_max_abs_err"),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": f"combat E={E_MAIN}",
        "shapes": [dict(shape=k, **v) for k, v in res["k5_shapes"].items()],
    })


# Registers of the production kernels, as `ptxas -v` gave them in this
# script's build log: K1's persistent kernel, K4's and K5's persistent
# kernels at one pass (S <= 128), K2's instantiation for combat (attack, swap
# and assemblers, no transfer) and for the chest config (swap, assemblers,
# chests), and K3's instantiations at the learner's tiles
# (8 columns at B=60, 32 at B=4080): the forward pass, its gradient, the
# gradient with gdecay; S1's M7 (its row in registers), fold (its
# shared-memory ring), M2 (its staged tile) and M4 (its 44 accumulators) at
# any count (None), with no stack or local memory either. K1 and K4 are the
# mask-0 instantiations of their section templates; every other
# instantiation of the two, a stubbed mask of S5 or S4, must have no stack
# or local memory either (SECTION_TEMPLATES).
K2_COMBAT = "sim_fused_kernelILb1ELb0ELb1ELb1ELb0E"
# K2 with its chest phase, the instantiation of the chest config (swap,
# assemblers and chests)
K2_CHESTS = "sim_fused_kernelILb0ELb0ELb1ELb1ELb1E"
K4_MAIN = "obs_render2_kernelILi1ELi0EE"
K5_MAIN = "obs_render_kernelILi1E"
K3_KERNELS = {(direction, cols): f"discounted_sum_kernelIL{flags}ELi{cols}E"
              for direction, flags in (("forward", "b0ELb0"), ("backward", "b1ELb0"),
                                       ("backward with gdecay", "b1ELb1"))
              for cols in (8, 32)}
K1_MAIN = "obs_render3_kernelILi0E"
PRODUCTION_REGISTERS = [("obs_render3", K1_MAIN, 48),
                        ("obs_render2", K4_MAIN, 47),
                        ("obs_render", K5_MAIN, 40),
                        ("sim_fused", K2_COMBAT, 64),
                        ("sim_fused", K2_CHESTS, 64),
                        *[("discounted_sum", K3_KERNELS[key], regs) for key, regs in (
                            (("forward", 8), 82), (("forward", 32), 81),
                            (("backward", 8), 84), (("backward", 32), 84),
                            (("backward with gdecay", 8), 79),
                            (("backward with gdecay", 32), 114))],
                        ("ubench_mosaic", "compact_kernel", None),
                        ("ubench_mosaic", "fold_kernel", None),
                        ("ubench_mosaic", "transpose_kernel", None),
                        ("ubench_mosaic", "rep_kernel", None),
                        ("ubench_mosaic", "droll_kernel", None),
                        # S2: the nine cases, then pair_full_match and load_store
                        *[("ubench_pairmat", f"pairmat_kernelILi{i}E", None) for i in range(11)],
                        ("smoke_sim", "smoke_sim_kernel", None)]
SECTION_TEMPLATES = [("obs_render3", "obs_render3_kernel"), ("obs_render2", "obs_render2_kernel")]
# PERF.md's kernel table, combat E=4096
PRODUCTION_MS = {"K1": 0.0909, "K4": 0.0884, "K2": 0.0304}
# Warp instructions K2's production kernel must hold (cuobjdump -sass
# opcodes): the match and the reduce of each per-key winner.
K2_SASS_OPS = ("MATCH", "REDUX")
# Each micro-benchmark kernel's repeat loop, found in the SASS: (library,
# fragment of the mangled name, opcodes the loop body must hold: the rep's
# arithmetic and, where the TPU body reads its block every rep, the load;
# opcodes it must not hold). M7 keeps its row in registers: its loop holds
# the compares and the shuffles, and no shared load. The fold, M2 and M3
# read each rep from shared memory: their loops hold shared loads, no global
# one. S2's pair_full counts by 24 shuffles a rep (no warp match: its match
# form, pair_full_match, timed beside it, was slower), red_a sums by the
# warp reduce, and tdiv's fast loop multiplies by a reciprocal taken before
# the loop (no reciprocal and no call of the division's slow path in it);
# its second loop, taken where a rep leaves the reciprocal's domain, holds
# the IEEE divide (FCHK, the divide's range check) and is listed after the
# S2 block, so that the fast loop is the one s2_issue_floors reads (the
# fast loop, unrolled as the IEEE loop is, is the smaller of the two that
# hold its opcodes). S3 has no repeat loop: its shuffles, ballot, shared
# atomics and shared loads are counted in the function. M5's and M4's
# kernels must also hold 16-byte global loads
# and stores (VECTOR_OPS: opcode prefix and width suffix of the full
# mnemonic), and M4's loop at least one add a copy of the tile
# (ops/ubench_mosaic.py:COPIES) for every float its loads bring: one load a
# rep feeds every copy.
SASS_LOOPS = [
    *[("ubench_pairmat", f"pairmat_kernelILi{i}E", *spec) for i, spec in enumerate((
        (("ISETP",),), (("IADD3",),), (("SHFL",),), (("IADD3",),),
        (("SHFL", "ISETP"), ("MATCH",)), (("REDUX",),), (("IADD3",),), (("ISETP",),),
        (("I2F", "FMUL", "F2I"), ("CALL", "MUFU")), (("MATCH",), ("SHFL",))))],
    ("ubench_pairmat", "pairmat_kernelILi8E", ("I2F", "F2I", "FCHK")),
    ("ubench_mosaic", "tiny_kernel", ("FADD",)),
    ("ubench_mosaic", "fold_kernel", ("FADD", "LDS"), ("LDG",)),
    ("ubench_mosaic", "transpose_kernel", ("FADD", "LDS"), ("LDG",)),
    ("ubench_mosaic", "droll_kernel", ("FADD", "LDS"), ("LDG",)),
    ("ubench_mosaic", "rep_kernel", ("FADD", "LDG")),
    ("ubench_mosaic", "compact_kernel", ("FSETP", "SHFL"), ("LDS",)),
    # S1's GEMMs: the consumers' loop issues wgmma, the producer's TMA loads
    ("ubench_gemm", "gemm_tma_kernel", ("HGMMA",)),
    ("ubench_gemm", "gemm_tma_kernel", ("UTMALDG",)),
]
# S2's issue floors (s2_issue_floors): each case's reps an element and the
# reps its repeat loop in the SASS covers (its unroll in
# csrc/ubench_pairmat.cu). A warp's loop issues at most four instructions a
# clock an SM (one a scheduler), and each pipe takes its opcodes at its
# lanes a clock an SM, from the throughput table of NVIDIA's CUDA C++
# Programming Guide for compute capability 9.0: the int32 pipe 64, shuffles
# 32, conversions and population counts 16; the float32 pipe 128, which is
# taken to run IMAD, VIADD, I2FP and MOV too (the table's int32 rate for
# them would put the floor above the measured times); warp reduces 16, and
# MATCH, which the table does not list, at REDUX's 16. Branches, convergence
# barriers and uniform-datapath instructions take issue slots only.
S2_LOOP = dict(elemwise=(768, 4), flat=(32, 4), bT=(32, 4), bA=(32, 4), pair_full=(32, 2),
               red_a=(32, 4), repeat_na=(352, 8), iota_div=(32, 4), tdiv=(256, 4),
               pair_full_match=(32, 4))
PIPE_OF = {"FADD": "f32", "FMUL": "f32", "FFMA": "f32", "IMAD": "f32", "VIADD": "f32",
           "I2FP": "f32", "MOV": "f32", "SHFL": "shuffle", "I2F": "conversion",
           "F2I": "conversion", "MUFU": "conversion", "POPC": "conversion", "FLO": "conversion",
           "REDUX": "warp reduce", "MATCH": "warp reduce"}
PIPE_LANES = {"int32": 64, "f32": 128, "shuffle": 32, "conversion": 16, "warp reduce": 16}
ISSUE_ONLY = ("BRA", "BSSY", "BSYNC", "NOP", "WARPSYNC", "EXIT")
SM_CLOCK_MHZ = 1980
VECTOR_OPS = (("LDG", ".128"), ("STG", ".128"))
VECTOR_KERNELS = ("tiny_kernel", "rep_kernel")
SASS_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def sass_functions(text):
    """{mangled name: [(address, instruction)]} from ``cuobjdump -sass``."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = SASS_ADDR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def opcode(ins):
    toks = ins.split()
    if toks and toks[0].startswith("@"):
        toks = toks[1:]
    return toks[0].split(".")[0] if toks else ""


def sass_loops(instrs):
    """Every loop of a function (a backward branch's span): its bodies."""
    loops = []
    for addr, ins in instrs:
        m = re.search(r"\b0x([0-9a-f]+)", ins)
        if opcode(ins) == "BRA" and m and int(m.group(1), 16) <= addr:
            loops.append([i for a, i in instrs if int(m.group(1), 16) <= a <= addr])
    return loops


def sass_loop(instrs, ops, absent=()):
    """The smallest loop whose body holds every opcode of ``ops``:
    (instructions in the body, {op: count} over ``ops`` and ``absent``, the
    body), or None."""
    best = None
    for body in sass_loops(instrs):
        counts = {op: sum(opcode(i).startswith(op) for i in body) for op in ops + absent}
        if all(counts[op] for op in ops) and (best is None or len(body) < best[0]):
            best = (len(body), counts, body)
    return best


def mnemonic(ins):
    """The full mnemonic of a SASS instruction (``LDG.E.128``), its predicate dropped."""
    toks = ins.split()
    return toks[1] if toks[0].startswith("@") else toks[0]


def words_loaded(body):
    """4-byte words the global loads of a loop body bring (``.128`` 4, ``.64`` 2)."""
    return sum(4 if ".128" in m else 2 if ".64" in m else 1
               for m in map(mnemonic, body) if m.startswith("LDG"))


def check_sass():
    """Every micro-benchmark's repeat loop is in the SASS (hard failure), with
    its instruction count and without the opcodes it must not hold; S3's
    shuffles, ballot, shared atomics and shared loads are there; K2's match and reduce;
    K3's chain loops multiply and add from shared memory without FFMA or LDG;
    K4's and K5's per-agent loops shuffle without a block barrier."""
    from metta_tpu_torch.ops import build
    from metta_tpu_torch.ops.ubench_mosaic import COPIES

    dumps = {lib: sass_functions(build.cuobjdump(lib, "-sass"))
             for lib in ("ubench_pairmat", "ubench_mosaic", "ubench_gemm", "smoke_sim",
                         "sim_fused", "discounted_sum", "obs_render2", "obs_render")}
    found = {}
    for lib, frag, ops, *absent in SASS_LOOPS:
        absent = absent[0] if absent else ()
        names = [n for n in dumps[lib] if frag in n]
        if not names:
            raise AssertionError(f"{lib}: no kernel {frag} in the SASS ({sorted(dumps[lib])})")
        loop = sass_loop(dumps[lib][names[0]], ops, absent)
        if loop is None:
            head = "\n".join(i for _, i in dumps[lib][names[0]][:80])
            raise AssertionError(f"{lib} {frag}: no loop holding {ops} in the SASS:\n{head}")
        if any(loop[1][op] for op in absent):
            raise AssertionError(f"{lib} {frag}: its loop holds {loop[1]}, none of {absent} "
                                 f"allowed")
        found[f"{frag} {'+'.join(ops)}"] = dict(
            loop_instructions=loop[0], ops=loop[1],
            function_instructions=len(dumps[lib][names[0]]),
            opcodes=dict(Counter(opcode(i) for i in loop[2])))
        log(f"[sass] {lib} {frag}: repeat loop of {loop[0]} instructions, {loop[1]}; "
            f"{len(dumps[lib][names[0]])} instructions in the kernel")
    for frag in VECTOR_KERNELS:
        (name, instrs), = [(n, i) for n, i in dumps["ubench_mosaic"].items() if frag in n]
        mnemonics = [mnemonic(ins) for _, ins in instrs]
        vector_ops = {op + width: sum(m.startswith(op) and width in m for m in mnemonics)
                      for op, width in VECTOR_OPS}
        if not all(vector_ops.values()):
            raise AssertionError(f"ubench_mosaic {frag}: no 16-byte global loads or stores in "
                                 f"the SASS: {vector_ops}")
        log(f"[sass] ubench_mosaic {frag}: {vector_ops}")
        found[f"{frag} vectors"] = vector_ops
    # M4: at least COPIES adds in its repeat loop for every float loaded
    (name, instrs), = [(n, i) for n, i in dumps["ubench_mosaic"].items() if "rep_kernel" in n]
    _, ops, body = sass_loop(instrs, ("FADD", "LDG"))
    words = words_loaded(body)
    if ops["FADD"] < COPIES * words:
        raise AssertionError(f"ubench_mosaic rep_kernel: its repeat loop holds {ops['FADD']} "
                             f"FADDs for {words} floats loaded, under {COPIES} a float")
    log(f"[sass] ubench_mosaic rep_kernel: {ops['FADD']} FADDs for {words} floats loaded in its "
        f"repeat loop ({ops['FADD'] / words:.2f} a float)")
    found["rep_kernel adds a float"] = dict(fadd=ops["FADD"], words_loaded=words)
    (name, instrs), = [(n, i) for n, i in dumps["smoke_sim"].items() if "smoke_sim_kernel" in n]
    ops = {op: sum(opcode(i).startswith(op) for _, i in instrs)
           for op in ("SHFL", "VOTE", "ATOMS", "LDS")}
    if not all(ops.values()):
        raise AssertionError(f"smoke_sim: warp primitives or shared loads missing from the "
                             f"SASS: {ops}")
    log(f"[sass] smoke_sim_kernel: {len(instrs)} instructions; {ops}")
    found["smoke_sim_kernel"] = dict(function_instructions=len(instrs), **ops)
    (name, instrs), = [(n, i) for n, i in dumps["sim_fused"].items() if K2_COMBAT in n]
    ops = {op: sum(opcode(i) == op for _, i in instrs) for op in K2_SASS_OPS}
    if not all(ops.values()):
        raise AssertionError(f"sim_fused {K2_COMBAT}: warp match or reduce missing from the "
                             f"SASS: {ops}")
    log(f"[sass] sim_fused {K2_COMBAT}: {len(instrs)} instructions; {ops}")
    found[K2_COMBAT] = dict(function_instructions=len(instrs), **ops)
    # K3: each chain loop multiplies, then adds, reading shared memory, with
    # no fused multiply-add and no global load
    for frag in K3_KERNELS.values():
        (name, instrs), = [(n, i) for n, i in dumps["discounted_sum"].items() if frag in n]
        loop = sass_loop(instrs, ("FMUL", "FADD", "LDS"), absent=("FFMA", "LDG"))
        if loop is None or loop[1]["FFMA"] or loop[1]["LDG"]:
            raise AssertionError(f"discounted_sum {frag}: no chain loop of FMUL, FADD and LDS "
                                 f"without FFMA or LDG in the SASS: {loop}")
        log(f"[sass] discounted_sum {frag}: chain loop of {loop[0]} instructions, {loop[1]}; "
            f"{len(instrs)} instructions in the kernel")
        found[frag] = dict(loop_instructions=loop[0], ops=loop[1],
                           function_instructions=len(instrs))
    # K4 and K5: shuffles in the per-agent loop (the largest), and no block
    # barrier; K4's production kernels are the mask-0 instantiations (its
    # stubbed masks are S4's)
    for lib, production in (("obs_render2", r"obs_render2_kernelILi\d+ELi0EE"),
                            ("obs_render", r"obs_render_kernelILi\d+E")):
        for name, instrs in dumps[lib].items():
            frag = re.search(production, name)
            if frag is None:
                continue
            frag = frag.group(0)
            agent_loop = max(sass_loops(instrs), key=len)
            ops = {op: sum(opcode(i) == op for i in agent_loop) for op in ("SHFL", "BAR")}
            if not ops["SHFL"] or ops["BAR"]:
                raise AssertionError(f"{lib} {name}: the per-agent loop holds {ops}, not "
                                     f"shuffles without a block barrier")
            log(f"[sass] {lib} {frag}: per-agent loop of {len(agent_loop)} instructions, "
                f"{ops}; {sum(opcode(i) == 'BAR' for _, i in instrs)} block barriers in the "
                f"kernel")
            found[frag] = dict(loop_instructions=len(agent_loop),
                               function_instructions=len(instrs), **ops)
    return found


def resource_usage(lib):
    """{mangled name: {REG, STACK, LOCAL, ...}} of kernel library ``lib``
    from ``cuobjdump -res-usage``."""
    from metta_tpu_torch.ops import build

    usage, cur = {}, None
    for line in build.cuobjdump(lib, "-res-usage").splitlines():
        m = re.search(r"Function (\S+?):?$", line.strip())
        if m:
            cur = m.group(1)
        elif "REG:" in line and cur is not None:
            usage[cur] = dict((k, int(v)) for k, v in re.findall(r"(\w+):(\d+)", line))
    return usage


def check_registers():
    """K1's, K2's, K3's, K4's and K5's production kernels use the registers
    they were built with, and they, every instantiation of K1's and K4's
    section templates, S1's M7, fold, M2, M3 and M4, S2's eleven
    instantiations and S3's kernel use no stack or local memory."""
    out, dumps = {}, {}
    for lib, frag, want in PRODUCTION_REGISTERS:
        if lib not in dumps:
            dumps[lib] = resource_usage(lib)
        usage = dumps[lib]
        hits = [u for n, u in usage.items() if frag in n]
        if not hits:
            raise AssertionError(f"{lib}: no {frag} in the resource usage ({sorted(usage)})")
        u = hits[0]
        log(f"[registers] {lib} {frag}: {u.get('REG')} registers (want {want or 'any'}), "
            f"stack {u.get('STACK')}, local {u.get('LOCAL')}; {len(usage)} instantiations")
        if want not in (None, u.get("REG")) or u.get("STACK", 0) or u.get("LOCAL", 0):
            raise AssertionError(f"{lib} {frag} compiled to {u}, not {want} registers unspilled")
        out[frag] = u
    for lib, frag in SECTION_TEMPLATES:
        masks = {re.search(rf"{frag}I\w*?EE", n).group(0): u
                 for n, u in (dumps.get(lib) or resource_usage(lib)).items() if frag in n}
        spilled = {n: u for n, u in masks.items() if u.get("STACK", 0) or u.get("LOCAL", 0)}
        log(f"[registers] {lib}: {len(masks)} instantiations of its section template at "
            f"{sorted({u.get('REG') for u in masks.values()})} registers, "
            f"{len(spilled)} with stack or local memory")
        if len(masks) < 9 or spilled:
            raise AssertionError(f"{lib}: {len(masks)} instantiations, spilled: {spilled}")
        out[f"{frag} masks"] = masks
    return out


def ptxas_usage(build_log, lib, frag):
    """(registers, static shared bytes) of kernel ``frag`` in library ``lib``
    from this run's ``ptxas -v`` build log, or None where the library was
    built before the run."""
    text = "\n".join(t for t in build_log if t.startswith(f"[nvcc {lib}]"))
    for m in re.finditer(r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry function|\Z)",
                         text, re.S):
        if frag in m.group(1):
            regs = re.search(r"Used (\d+) registers", m.group(2))
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            return (int(regs.group(1)) if regs else None, int(smem.group(1)) if smem else 0)
    return None


def redesign_shapes(res):
    """The launch shape of the redesigned K1 (combat's 121 window cells), K4
    and K5 (the same window; K5 also the 17x17 window's 289 cells), K3 (the
    learner's [255, 60] and [255, 4080], forward and backward), S1's fold
    (M1 and M1b: its ring stages), M2 (phase 13's 96 rows), M3 (its 16) and
    M4, S1 GEMMs
    (M6a's and M6b/c's shapes at eps 4) and K2
    (combat's and the arena's tables): registers and static shared memory
    from ``ptxas -v``, dynamic shared memory, blocks an SM, SMs."""
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.ops import discounted_sum as k3
    from metta_tpu_torch.ops import obs_render as k5
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops import obs_render3 as k1
    from metta_tpu_torch.ops import sim_fused as k2
    from metta_tpu_torch.ops import ubench_mosaic as s1

    def k2_tables(name):
        return MettaGridEnv(make_cfg(name), num_envs=1, seed=0, track_stats=False,
                            step_mode="batched", device="cuda").tables

    log_ = res.get("build_log", [])
    shapes = {"K1 (S=121, T=200)": dict(k1.launch_shape(121, 200)),
              "K4 (S=121, T=200)": dict(k4.launch_shape(121, 200)),
              "K5 (S=121, T=200)": dict(k5.launch_shape(121, 200)),
              "K5 (S=289, T=200)": dict(k5.launch_shape(289, 200)),
              "S1 fold (M1, M1b)": dict(s1.fold_launch_shape()),
              "S1 M2 (rows 96)": dict(s1.relayout_launch_shape("M2", 96)),
              "S1 M3 (rows 16)": dict(s1.relayout_launch_shape("M3", 16)),
              "S1 M4": dict(s1.relayout_launch_shape("M4")),
              "S1 GEMM M6a (nE=4, Kd=72)": dict(s1.gemm_launch_shape(4, 72)),
              "S1 GEMM M6b/c (nE=1, Kd=288)": dict(s1.gemm_launch_shape(1, 288)),
              "K2 combat": dict(k2.launch_shape(k2_tables("combat"))),
              "K2 arena": dict(k2.launch_shape(k2_tables("arena"))),
              "K2 chest config": dict(k2.launch_shape(chest_env(1)[0].tables))}
    uses = {}
    for (direction, cols), frag in K3_KERNELS.items():
        B = 60 if cols == 8 else E_TRAIN * AGENTS
        name = f"K3 {direction} [255, {B}]"
        shapes[name] = k3.launch_shape(255, B, direction != "forward", "gdecay" in direction)
        uses[name] = ptxas_usage(log_, "discounted_sum", frag)
    uses.update({"K1": ptxas_usage(log_, "obs_render3", K1_MAIN),
            "K4": ptxas_usage(log_, "obs_render2", K4_MAIN),
            "K5 (S=121": ptxas_usage(log_, "obs_render", K5_MAIN),
            "K5 (S=289": ptxas_usage(log_, "obs_render", "obs_render_kernelILi0E"),
            "S1 fold": ptxas_usage(log_, "ubench_mosaic", "fold_kernel"),
            "S1 M2": ptxas_usage(log_, "ubench_mosaic", "transpose_kernel"),
            "S1 M3": ptxas_usage(log_, "ubench_mosaic", "droll_kernel"),
            "S1 M4": ptxas_usage(log_, "ubench_mosaic", "rep_kernel"),
            "S1 GEMM": ptxas_usage(log_, "ubench_gemm", "gemm_tma_kernel"),
            "K2 combat": ptxas_usage(log_, "sim_fused", K2_COMBAT),
            "K2 arena": ptxas_usage(log_, "sim_fused", "sim_fused_kernelILb0ELb0ELb1ELb1ELb0E"),
            "K2 chest config": ptxas_usage(log_, "sim_fused", K2_CHESTS)})
    for name, shape in shapes.items():
        use = next(u for k, u in uses.items() if name.startswith(k))
        missing = ("not in this run's build log",) * 2
        shape["registers"], shape["static_smem"] = use if use else missing
        log(f"[shape] {name}: {shape}")
    return shapes


def sum_entry(rows, key):
    """The sum of ``key`` over the rows, or None unless every row has one."""
    vals = [r.get(key) for r in rows]
    return None if not vals or None in vals else sum(vals)


def s1_library_call(case, x, reps):
    """One PyTorch call that computes S1 case ``case``'s whole accumulator on
    input ``x`` (the yardstick; the port never calls it), or None where no
    single call computes it (M3 sums rolls by different shifts, M7 runs a
    compaction; the GEMMs have ``torch.bmm``)."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    G = x.shape[0]
    if case == "M5":
        return torch.add(x, float(reps))
    if case in ("M1", "M1b"):
        v = x.view(G, 1, -1, 2048 if case == "M1" else 128 * s1.COPIES)
        return torch.sum(v.expand(G, reps, *v.shape[2:]), dim=1)
    if case == "M2":
        v = x.transpose(1, 2).unsqueeze(1)
        return torch.sum(v.expand(G, reps, *v.shape[2:]), dim=1)
    if case == "M4":
        return torch.sum(x.view(G, 1, 1, *x.shape[1:]).expand(G, reps, s1.COPIES, *x.shape[1:]),
                         dim=1)
    return None


def s1_library_parts(case, acc, x):
    """The library call's accumulator as (slots, checksum), the form of
    ``ops/ubench_mosaic.py:plain``: the columns or rows the TPU output keeps,
    and the bits of the rest."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    if case in ("M1", "M1b"):
        return acc[..., :128], s1.bitsum(acc[..., 128:])
    if case == "M4":
        acc = acc.reshape(x.shape[0], -1, 128)
        return acc[:, :x.shape[1]], s1.bitsum(acc[:, x.shape[1]:])
    return acc, None


def s1_in_turns(row):
    """S1 case ``row["case"]`` (M5, M2, M3 or M4) on the script's inputs
    (G=1024, eps 4, reps 16) timed in turns with its one PyTorch call
    (``s1_library_call``; M3 has none) and, for M5, M2 and M3, with a
    one-pass copy of the same bytes (the stream with no arithmetic: ``copy_``
    of x, or of M2's transposed view): kernel, call, copy, copy, call,
    kernel. Adds each's first time to ``row``; for M4 also the kernel's time
    at reps 1, 16 and 32, whose step is what each rep's adds cost."""
    from metta_tpu_torch.ops import ubench_mosaic as s1

    case = row["case"]
    inputs = s1.make_inputs(case, 1024, 4, 0, "cuda")
    x = inputs[0]
    before = s1.launches
    calls = dict(kernel=lambda: s1.run(case, inputs, 16))
    if case != "M3":
        calls["library"] = lambda: s1_library_call(case, x, 16)
    if case in ("M5", "M3"):
        out = torch.empty_like(x)
        calls["copy"] = lambda: out.copy_(x)
    elif case == "M2":
        out = torch.empty(x.shape[0], x.shape[2], x.shape[1], device=x.device)
        calls["copy"] = lambda: out.copy_(x.transpose(1, 2))
    order = list(calls) + list(calls)[::-1]
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(cuda_time_ms(calls[name], 10))
    row.update({f"{name}_in_turns_ms": t[0] for name, t in times.items()})
    if case == "M4":            # what grows with the reps (their adds) and what does not
        row["kernel_ms_at_reps"] = {reps: cuda_time_ms(lambda: s1.run(case, (x,), reps), 10)
                                    for reps in (1, 16, 32)}
        per_rep = (row["kernel_ms_at_reps"][32] - row["kernel_ms_at_reps"][16]) / 16
        _, _, adds_ms = bound_of(0, s1.work(case, 1024, 4, 1)[1], "f32")
        log(f"[analysis] S1 M4 at reps 1, 16, 32: {row['kernel_ms_at_reps']} ms; a rep "
            f"{per_rep:.5f} ms, its adds at the FADD issue rate (33.5 T/s) "
            f"{2 * adds_ms:.5f} ms; the part that does not grow "
            f"{row['kernel_ms_at_reps'][16] - 16 * per_rep:.4f} ms")
    s1.launches = before                                   # timing launches do not count
    label = dict(kernel="kernel", library="torch.add" if case == "M5" else "torch.sum",
                 copy="copy_")
    log(f"[analysis] S1 {case} in turns ({', '.join(label[n] for n in order)}): "
        + ", ".join(f"{label[n]} {t} ms" for n, t in times.items())
        + f"; bound {row['bound_ms']:.4f} ms")
    del x, inputs


def s2_in_turns(rows):
    """S2 on the script's inputs (E=4096, x from seed 0), timed in turns:
    the four cases nearest their launch's floor (flat, bT, bA, iota_div)
    with load_store, the thread-per-element grid that only loads x and
    stores it; pair_full (24 shuffles a rep) with pair_full_match (K2's warp
    match), each order run forwards, then backwards. The extras are first
    held byte-equal to their plain versions. Adds each case's first time to
    its row; returns {name: [times]}."""
    from metta_tpu_torch.ops import ubench_pairmat as s2

    x = torch.from_numpy(np.random.default_rng(0).integers(0, 24, (s2.A, E_MAIN),
                                                           dtype=np.int32)).cuda()
    before = s2.launches
    for extra in s2.EXTRAS:
        if not torch.equal(s2.run(extra, x), s2.plain(extra, x)):
            raise AssertionError(f"S2 {extra} differs from its plain version")
    times = {}
    for group in (("flat", "bT", "bA", "iota_div", "load_store"),
                  ("pair_full", "pair_full_match")):
        for case in group + group[::-1]:
            times.setdefault(case, []).append(
                cuda_time_ms(functools.partial(s2.run, case, x), 20))
        log(f"[analysis] S2 in turns ({', '.join(group + group[::-1])}): "
            + ", ".join(f"{c} {times[c]} ms" for c in group))
    s2.launches = before                                   # timing launches do not count
    for row in rows:
        if row["case"] in times:
            row["in_turns_ms"] = times[row["case"]]
    return times


def s2_issue_floors(rows, sass):
    """Each S2 case's issue floor at E=4096 (and pair_full_match's) from its
    repeat loop in the SASS (``S2_LOOP``, ``PIPE_LANES``): the larger of the
    loop's instructions over four a clock an SM and each pipe's lanes, times
    the loop's iterations and the warps the launch runs, over the SMs at
    ``SM_CLOCK_MHZ``. Adds ``issue_floor_ms`` and ``loop_instructions_a_rep``
    to each row; returns {case: floor ms}."""
    from metta_tpu_torch.ops import ubench_pairmat as s2

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floors = {}
    for i, case in enumerate(s2.CASES + s2.EXTRAS[:1]):
        loop = next(v for k, v in sass.items() if k.startswith(f"pairmat_kernelILi{i}E "))
        reps, unroll = S2_LOOP[case]
        pipes = Counter()
        for op, n in loop["opcodes"].items():
            if op not in ISSUE_ONLY and not op.startswith("U"):
                pipes[PIPE_OF.get(op, "int32")] += n * 32 / PIPE_LANES[PIPE_OF.get(op, "int32")]
        clocks = max(loop["loop_instructions"] / 4, *pipes.values())  # an SM's, a warp-iteration
        warps = (-(-E_MAIN // s2.ENVS) * s2.ENVS if case in s2.WARP_PER_ENV
                 else s2.A * -(-E_MAIN // s2.THREADS) * s2.THREADS // 32)
        floors[case] = clocks * reps / unroll * warps / sms / (SM_CLOCK_MHZ * 1e3)
        log(f"[analysis] S2 {case}: repeat loop {loop['loop_instructions']} instructions for "
            f"{unroll} reps ({loop['opcodes']}); issue floor {floors[case]:.5f} ms "
            f"({warps} warps, {reps} reps, {sms} SMs at {SM_CLOCK_MHZ} MHz)")
        for row in rows:
            if row["case"] == case:
                row["issue_floor_ms"] = floors[case]
                row["loop_instructions_a_rep"] = loop["loop_instructions"] / unroll
    return floors


def s3_timed(n):
    """S3 on the script's draw at E=``n`` (seed n): its time over 50 launches,
    then in turns with ``copy_`` of inv into a buffer (0.25 MB at E=256, most
    of S3's bytes, a launch that moves them with no compute): kernel, copy,
    copy, kernel; its bound, its plain version's time. Returns its row."""
    from metta_tpu_torch.ops import smoke_sim as s3

    rng = np.random.default_rng(n)
    r = torch.as_tensor(rng.integers(0, 5, (s3.A, n), dtype=np.int32), device="cuda")
    inv = torch.as_tensor(rng.integers(0, 3, (s3.R, s3.A, n), dtype=np.int32), device="cuda")
    buf = torch.empty_like(inv)
    calls = dict(kernel=lambda: s3.smoke_sim(r, inv), copy=lambda: buf.copy_(inv))
    before = s3.launches
    ms = cuda_time_ms(calls["kernel"], 50)
    turns = {"kernel": [], "copy": []}
    for name in ("kernel", "copy", "copy", "kernel"):
        turns[name].append(cuda_time_ms(calls[name], 50))
    s3.launches = before                               # timing launches do not count
    bound, by, _ = bound_of(4 * s3.A * n * (2 + s3.R), 2 * s3.A * s3.A * n + s3.R * s3.A * n)
    row = dict(shape=f"E={n}", ms=ms, bound_ms=bound, bound_by=by,
               plain_ms=cuda_time_ms(lambda: s3.smoke_sim_plain(r, inv), 5), max_abs_err=0,
               in_turns_ms=turns["kernel"], copy_inv_in_turns_ms=turns["copy"],
               blocks=-(-n // s3.ENVS))
    log(f"[analysis] S3 E={n}: {ms:.4f} ms, bound {bound:.5f} ms ({by}), plain "
        f"{row['plain_ms']:.4f} ms; {row['blocks']} blocks of {s3.ENVS} envs; in turns "
        f"(kernel, copy_ of inv, copy_, kernel): kernel {turns['kernel']} ms, copy_ "
        f"{turns['copy']} ms")
    return row


def s2_tdiv_across_int32():
    """S2's tdiv on x drawn from all of int32 at E=4096 (seed 16), with both
    edges of its reciprocal route's domain, INT_MIN and INT_MAX - 255 in row
    0: bit-equal to the plain version (the IEEE loop on nearly every
    element), then timed in turns with the script's x (all in the domain):
    script, int32, int32, script. Returns the times."""
    from metta_tpu_torch.ops import ubench_pairmat as s2

    lim, reps = s2.TDIV_LIMIT, s2.TDIV_REPS
    x = np.random.default_rng(16).integers(-2 ** 31, 2 ** 31, (s2.A, E_MAIN))
    x[0, :6] = [-lim + 1, -lim, lim - reps, lim - reps + 1, -2 ** 31, 2 ** 31 - reps]
    x = torch.as_tensor(x.astype(np.int32), device="cuda")
    script = torch.from_numpy(np.random.default_rng(0).integers(0, 24, (s2.A, E_MAIN),
                                                                dtype=np.int32)).cuda()
    before = s2.launches
    if not torch.equal(s2.run("tdiv", x), s2.plain("tdiv", x)):
        raise AssertionError("S2 tdiv on x across int32 differs from its plain version")
    times = {"script": [], "int32": []}
    for name in ("script", "int32", "int32", "script"):
        times[name].append(cuda_time_ms(functools.partial(s2.run, "tdiv",
                                                          script if name == "script" else x), 20))
    s2.launches = before                                   # timing launches do not count
    log(f"[analysis] S2 tdiv on x across int32 (E={E_MAIN}, the domain's edges, INT_MIN and "
        f"INT_MAX - 255 among them): bit-equal to its plain version; in turns with the "
        f"script's x: script {times['script']} ms, across int32 {times['int32']} ms")
    return times


def phase_analysis(res):
    """Phase 13, the analysis path: the six kernel-analysis scripts at the
    JAX scripts' default sizes, each kernel held to its plain version inside
    the script; the launch counts of the scripts' run; S3's time (also in
    turns with ``copy_`` of its inv) and the S1 GEMMs' ``torch.bmm`` time
    (the library yardstick) after the run; S2's tdiv across int32; then
    the redesigned kernels' launch shapes, the SASS's loops and the
    production kernels' registers."""
    from metta_tpu_torch.ops import ablate_obs as ab
    from metta_tpu_torch.ops import sim_fused as k2
    from metta_tpu_torch.ops import smoke_sim as s3
    from metta_tpu_torch.ops import ubench_mosaic as s1
    from metta_tpu_torch.ops import ubench_pairmat as s2
    from metta_tpu_torch.scripts import (ablate_fused, ablate_obs, ablate_obs3,
                                         smoke_sim_kernel, ubench_mosaic, ubench_pairmat)

    ab.launches_obs3 = ab.launches_obs2 = s3.launches = s2.launches = 0
    s1.launches = s1.launches_gemm = k2.launches = 0
    t0 = time.time()
    s5_rows = ablate_obs3.main([])
    s4_rows = ablate_obs.main([])
    k2_rows = ablate_fused.main([])
    for n in (256, 257):
        smoke_sim_kernel.main(["--num-envs", str(n)])
    s2_rows = ubench_pairmat.main([])
    s1_rows = ubench_mosaic.main([])
    launches = {"S5": ab.launches_obs3, "S4": ab.launches_obs2, "K2 ablation": k2.launches,
                "S3": s3.launches, "S2": s2.launches, "S1": s1.launches,
                "S1 GEMMs": s1.launches_gemm}                          # the run ends
    log(f"[analysis] the six scripts in {time.time() - t0:.1f} s; launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the analysis path never launched: {launches}")
    if len(k2_rows) != len(ablate_fused.VARIANTS):
        raise AssertionError(f"K2's ablation timed {len(k2_rows)} variants")
    full = next(r for r in k2_rows if r["variant"] == "full")
    for r in k2_rows:
        log(f"[analysis] K2 {r['variant']}: {r['ms']:.4f} ms, the section(s) it drops cost "
            f"{full['ms'] - r['ms']:.4f} ms of full's {full['ms']:.4f}")

    production = {
        "K1": next((k["ms"] for k in res.get("kernels", []) if k["name"] == "obs_render3"), None),
        "K4": res.get("k4_shapes", {}).get(f"combat E={E_MAIN}", {}).get("ms"),
        "K2": next((k["ms"] for k in res.get("kernels", []) if k["name"] == "sim_fused"), None),
    }
    for name, rows in (("K1", s5_rows), ("K4", s4_rows), ("K2", k2_rows)):
        none = next(r for r in rows if r["variant"] in ("none", "full"))
        prod = production[name]
        log(f"[analysis] {name} at combat E={E_MAIN}: production "
            + (f"{prod:.4f} ms ({100 * (prod / PRODUCTION_MS[name] - 1):+.1f}% from PERF.md's "
               f"{PRODUCTION_MS[name]} ms)" if prod is not None else "not timed in this run")
            + f", the ablation's {none['variant']} {none['ms']:.4f} ms"
            + (f" ({100 * (none['ms'] / prod - 1):+.1f}% from it)" if prod else "")
            + (f"; on the ablation's inputs production {none['production_ms']:.4f} ms, "
               f"{none['variant']} {100 * (none['ms'] / none['production_ms'] - 1):+.1f}% from it"
               if none.get("production_ms") else ""))

    s3_shapes = [s3_timed(n) for n in (256, 257)]

    for row in s1_rows:
        row["library_ms"] = None
        inputs = s1.make_inputs(row["case"], 1024, 4, 0, "cuda")   # the script's inputs
        if row["case"] in s1.GEMMS:
            a, b = inputs
            a3, b3 = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
            row["library_ms"] = cuda_time_ms(lambda: torch.bmm(a3, b3), 10)
            log(f"[analysis] S1 {row['case']}: kernel {row['ms']:.4f} ms, torch.bmm on the same "
                f"bf16 operands {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
            del a, b, a3, b3
        elif (acc := s1_library_call(row["case"], inputs[0], 16)) is not None:
            # the sums are exact on these inputs, so the call must equal the plain version
            ubench_mosaic.check(row["case"], s1_library_parts(row["case"], acc, inputs[0]),
                                s1.plain(row["case"], inputs, 16))
            del acc
            row["library_ms"] = cuda_time_ms(lambda: s1_library_call(row["case"], inputs[0], 16),
                                             10)
            log(f"[analysis] S1 {row['case']}: kernel {row['ms']:.4f} ms, one PyTorch call "
                f"{row['library_ms']:.4f} ms ({row['library_ms'] / row['ms']:.2f}x the kernel's "
                f"time), bound {row['bound_ms']:.4f} ms")
        del inputs
    for row in s1_rows:
        if row["case"] in ("M5", "M2", "M3", "M4"):
            s1_in_turns(row)
    s2_in_turns(s2_rows)
    tdiv_int32 = s2_tdiv_across_int32()
    sass = check_sass()
    s2_issue_floors(s2_rows, sass)
    for row in s2_rows:
        log(f"[analysis] S2 {row['case']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f}%), issue floor "
            f"{row['issue_floor_ms']:.5f} ms ({100 * row['issue_floor_ms'] / row['ms']:.1f}%)")

    def entry(name, source, replaces, key, rows, label, shape, main=None):
        top = main if main is not None else dict(
            ms=sum_entry(rows, "ms"), plain_ms=sum_entry(rows, "plain_ms"),
            bound_ms=sum_entry(rows, "bound_ms"),
            bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=sum_entry(rows, "library_ms"))
        return {
            "name": name, "route": "cuda", "source": f"metta_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(r.get("max_abs_err", 0) for r in rows),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top.get("library_ms"),
            "shape": shape,
            "shapes": [dict(shape=r[label], **{k: v for k, v in r.items() if k != label})
                       for r in rows],
        }

    gemm_rows = [r for r in s1_rows if r["case"] in s1.GEMMS]
    none5 = next(r for r in s5_rows if r["variant"] == "none")
    none4 = next(r for r in s4_rows if r["variant"] == "none")
    res.setdefault("kernels", []).extend([
        entry("obs_render3_ablate", "obs_render3.cu", "scripts/ablate_obs3.py:211", "S5",
              s5_rows, "variant", f"combat E={E_MAIN}, the none variant", main=none5),
        entry("obs_render2_ablate", "obs_render2.cu", "scripts/ablate_obs.py:226", "S4",
              s4_rows, "variant", f"combat E={E_MAIN}, the none variant", main=none4),
        entry("smoke_sim", "smoke_sim.cu", "scripts/smoke_sim_kernel.py:65", "S3",
              s3_shapes, "shape", "E=256", main=s3_shapes[0]),
        entry("ubench_pairmat", "ubench_pairmat.cu", "scripts/ubench_pairmat.py:156", "S2",
              s2_rows, "case", f"the sum of the 9 cases at E={E_MAIN}"),
        entry("ubench_mosaic", "ubench_mosaic.cu", "scripts/ubench_mosaic.py:42", "S1",
              [r for r in s1_rows if r["case"] not in s1.GEMMS], "case",
              "the sum of the 7 cases other than the GEMMs at G=1024, reps 16, eps 4 "
              "(each case's one PyTorch call, where there is one, as its library_ms)"),
        entry("ubench_gemm", "ubench_gemm.cu", "scripts/ubench_mosaic.py:170", "S1 GEMMs",
              gemm_rows, "case", "the sum of the 3 GEMM cases at G=1024, eps 4 (torch.bmm "
              "on the same bf16 operands as library_ms)"),
    ])
    shapes = redesign_shapes(res)
    registers = check_registers()
    res["analysis"] = dict(registers=registers, sass=sass, launches=launches, shapes=shapes,
                           k2_ablation=k2_rows, tdiv_across_int32=tdiv_int32)


# ---------------------------------------------------------------------------
# Cogs vs Clips: K2's chest phase, the clipped mission batched, the missions
# in the sequential step
# ---------------------------------------------------------------------------


def chest_env(n_envs, seed=5):
    """The chest config (``scripts/common.py:chest_mission``: the basic
    mission, its 32x32 map with the catalog's chest station twice) as a
    ``track_stats=False`` batched env on the card, reset, with the agents
    standing beside the chests, seeded inventories (agents 0-30 of each
    resource, chests 0-40) and every agent showing one of the chest's
    vibes -> (env, generator)."""
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.engine.state import KIND_CHEST, KIND_EMPTY
    from metta_tpu_torch.engine.step_batched import agent_grid_from_positions
    from metta_tpu_torch.scripts.common import chest_mission

    env = MettaGridEnv(chest_mission(seed=SEED), num_envs=n_envs, seed=0, track_stats=False,
                       step_mode="batched", device="cuda")
    env.reset()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t, s = env.tables, env.state.env
    kind = s.static_kind[0].cpu().numpy()
    free = [(r + dr, c + dc) for r, c in np.argwhere(kind == KIND_CHEST)
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1))
            if kind[r + dr, c + dc] == KIND_EMPTY]
    cells = torch.tensor([free[a % len(free)] for a in range(t.num_agents)], dtype=torch.int32,
                         device="cuda").expand(n_envs, -1, -1)
    vibes = torch.nonzero(t.chest_vibe_has.any(0)).flatten()

    def draw(hi, like):
        return torch.randint(0, hi, like.shape, generator=gen, device="cuda", dtype=torch.int32)
    r, c = cells[..., 0].contiguous(), cells[..., 1].contiguous()
    env._state = env.state.replace(env=s.replace(
        agent_r=r, agent_c=c, agent_prev_r=r, agent_prev_c=c,
        agent_grid=agent_grid_from_positions(t, r, c),
        agent_inv=draw(31, s.agent_inv), chest_inv=draw(41, s.chest_inv),
        agent_vibe=vibes[draw(len(vibes), s.agent_vibe).long()].to(torch.int32)))
    return env, gen


def phase_k2_chests(res):
    """K2's chest phase: the chest config at E=4096, 20 steps through K2
    held byte-equal to its plain version every step (chest transfers must
    happen: their count is printed); then the path through the user's entry
    point, ``MettaGridEnv.step``, 20 steps with the counts set to 0 just
    before (K2 once a step, K1 or K4 once a step); K2's time per launch on
    the chest config, its plain time and its bound."""
    from metta_tpu_torch.engine.step_batched import batched_step, rank_from_perm
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops import obs_render3 as k1
    from metta_tpu_torch.ops import sim_fused as k2
    from metta_tpu_torch.scripts.common import span_actions

    env, gen = chest_env(E_MAIN)
    t = env.tables

    def random_actions(n_envs, n_actions, gen):
        return span_actions(n_envs, t.num_agents, n_actions, gen)
    if not (t.has_chests and env._sim_step is k2.fused_step_full):
        raise AssertionError("the chest config does not take K2")
    err = [0]
    checked = checked_span(err)
    state, uses, clamped = env.state.env, 0, 0
    for _ in range(20):
        acts = random_actions(E_MAIN, t.n_actions, gen)
        prev = state
        state, _ = batched_step(state, acts, t, checked, generator=gen)
        uses += int((state.chest_inv != prev.chest_inv).any(-1).sum())
    log(f"[k2-chests] chest config E={E_MAIN} ({t.n_chest_slots} chests an env, "
        f"R={t.num_resources}, V={t.num_vibes}): K2 byte-equal to its plain version on 20 "
        f"steps; {uses} chest uses that moved resources, chests hold "
        f"{int(state.chest_inv.sum())} items")
    if uses == 0:
        raise AssertionError("no chest use moved a resource")

    env._state = env.state.replace(env=state)
    acc = torch.zeros((), dtype=torch.int64, device="cuda")
    k1.launches = k2.launches = k4.launches = 0          # the path's run starts
    for _ in range(20):
        obs, *_ = env.step(random_actions(E_MAIN, t.n_actions, gen))
        acc.add_(obs.sum(dtype=torch.int64))
    torch.cuda.synchronize()
    launches = {"k2": k2.launches, "render": k1.launches + k4.launches}   # ... and ends
    if launches != {"k2": 20, "render": 20}:
        raise AssertionError(f"chest config: launches in 20 steps {launches}")

    s = env.state.env
    acts = random_actions(E_MAIN, t.n_actions, gen)
    rank = rank_from_perm(None, E_MAIN, t.num_agents, gen, "cuda")
    before = k2.launches
    ms = cuda_time_ms(lambda: k2.launch_fused_span(s, acts, rank, t), 50)
    plain = cuda_time_ms(lambda: k2.fused_span_plain(s, acts, rank, t), 5)
    k2.launches = before                                 # timing launches do not count
    nbytes, ops, parts = k2.span_work(s, acts, t)
    bound, by, ops_ms = bound_of(nbytes, ops)
    log(f"[k2-chests] {ms:.4f} ms per launch on the device, plain {plain:.4f} ms, bound "
        f"{bound:.4f} ms: {nbytes / 1e6:.3f} MB at 3.35 TB/s "
        f"{ {k: round(v / 1e6, 3) for k, v in parts.items()} } MB, {ops / 1e6:.1f} M int32 "
        f"ops = {ops_ms:.4f} ms ({by}); {100 * bound / ms:.1f}% of the bound; launches in the "
        f"path's 20 steps: K2 {launches['k2']}, render {launches['render']}")
    chest = dict(shape=f"chest config E={E_MAIN}", launches=launches["k2"],
                 max_abs_err=err[0], ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                 chest_uses=uses)
    res["k2_chests"] = chest
    for entry in res.get("kernels", []):
        if entry["name"] == "sim_fused":
            entry["chest"] = chest


def cvc_draws(rng, t, E):
    """(perm, clipper draws, reset unclip protocols) for one step of E envs
    from numpy, so that the GPU and CPU runs draw alike."""
    from metta_tpu_torch.engine.clipper import ClipDraws

    A, NA = t.num_agents, t.n_assembler_slots
    nup = max(t.n_unclip_protocols, 1)
    perm = torch.as_tensor(np.stack([rng.permutation(A) for _ in range(E)]))
    clip = ClipDraws(torch.as_tensor(rng.random(E) < 1 / max(t.clip_period, 1)),
                     torch.as_tensor(rng.gumbel(size=(E, NA)).astype(np.float32)),
                     torch.as_tensor(rng.integers(0, nup, E)))
    return perm, clip, rng.integers(0, nup, (E, NA)).astype(np.int32)


def cvc_actions(rng, t, E):
    """[E, A] actions: seven in ten moves, the rest any action."""
    moves = np.flatnonzero(t._cfg.action_kind == 1)
    return np.where(rng.random((E, t.num_agents)) < 0.7, rng.choice(moves, (E, t.num_agents)),
                    rng.integers(0, t.n_actions, (E, t.num_agents)))


def place_beside(env, stations, inventory):
    """Each agent of every env of ``env`` just below one of ``stations``
    (map names, in turn) holding ``inventory`` ({resource: amount}), so that
    its first episode's moves bump the station."""
    from metta_tpu_torch.engine.step_batched import agent_grid_from_positions

    s, t = env.state.env, env.tables
    grid = env.game_map.grid
    cells = [np.argwhere(grid == name)[0] + (1, 0) for name in stations]
    rc = torch.tensor(np.array([cells[a % len(cells)] for a in range(t.num_agents)]),
                      dtype=torch.int32, device=env.device).expand(env.num_envs, -1, -1)
    r, c = rc[..., 0].contiguous(), rc[..., 1].contiguous()
    inv = s.agent_inv.clone()
    for name, amount in inventory.items():
        inv[..., env.compiled.resource_names.index(name)] = amount
    env._state = env.state.replace(env=s.replace(
        agent_r=r, agent_c=c, agent_prev_r=r, agent_prev_c=c, agent_inv=inv,
        agent_grid=agent_grid_from_positions(t, r, c)))


def cvc_gpu_vs_cpu(label, make_env, E, steps, seed=0, prepare=None):
    """Two envs from ``make_env(device)`` on the GPU and the CPU, stepped
    with the same actions and draws (agent orders, clipper, desync, reset
    and template unclip protocols), each prepared by ``prepare(env)`` after
    the reset; obs, rewards, ends and the whole state byte-identical every
    step. Returns the counts of what fired."""
    from metta_tpu_torch.convert import state_to_numpy

    rng = np.random.default_rng(seed)
    envs = [make_env(d) for d in ("cuda", "cpu")]
    t = envs[1].tables
    desync = rng.integers(1, 12, E)
    _, _, protos = cvc_draws(rng, t, E)
    obs = [env.reset(desync_step=desync, unclip_proto=protos) for env in envs]
    if not torch.equal(obs[0].cpu(), obs[1]):
        raise AssertionError(f"{label}: reset observations differ between GPU and CPU")
    for env in envs if prepare else ():
        prepare(env)
    seen = dict(ends=0, chest_uses=0, clips=0, unclips=0, regen=0)
    for i in range(steps):
        acts = cvc_actions(rng, t, E)
        perm, clip, protos = cvc_draws(rng, t, E)
        before = envs[1].state.env
        outs = [env.step(acts, perm=perm, clip_draws=clip, unclip_proto=protos) for env in envs]
        for field, g, c in zip(("obs", "reward", "done", "truncated"), *outs):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"{label} step {i}: {field} differs between GPU and CPU")
        sg, sc = state_to_numpy(envs[0].state), state_to_numpy(envs[1].state)
        for field in sc["env"]:
            if not np.array_equal(sg["env"][field], sc["env"][field]):
                raise AssertionError(f"{label} step {i}: state field {field} differs")
        after, ended = envs[1].state.env, outs[1][2] | outs[1][3]
        live = ~ended
        seen["ends"] += int(ended.sum())
        seen["chest_uses"] += int(((after.chest_inv != before.chest_inv).flatten(1).any(1)
                                   & live).sum())
        seen["clips"] += int(((after.asm_clipped & ~before.asm_clipped).any(1) & live).sum())
        seen["unclips"] += int(((before.asm_clipped & ~after.asm_clipped).any(1) & live).sum())
        seen["regen"] += int((((after.agent_inv[..., 0] > before.agent_inv[..., 0])
                               & ~after.action_success).any(1) & live).sum())
    log(f"[gpu-vs-cpu] {label}: state and obs byte-identical over {steps} steps at E={E}; "
        f"{seen}")
    return seen


def phase_cvc_sequential(res):
    """Cogs vs Clips in the sequential step (its missions' coupled limit
    groups take it), as ``cogames play`` (E=1) and eval (E=1024) run it,
    with K5 rendering every step: ``training_facility.harvest``,
    ``evals.diagnostic_chest_deposit_near`` and ``training_facility.repair``
    (start-clipped stations, the clipper), each GPU against CPU over 20
    steps at E=1 and E=1024 with episodes cut to 12 steps (auto-reset with
    fresh unclip protocols); a chest use must happen. Then harvest's
    env-steps/s at E=1 and E=1024 through ``MettaGridEnv.step`` (median of 3
    windows), K5 exactly once a step and no other kernel."""
    from metta_tpu_torch.cogames.catalog import get_mission
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.ops import obs_render as k5
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops import obs_render3 as k1
    from metta_tpu_torch.ops import sim_fused as k2

    def mission_env(name, E, device, max_steps=None):
        """The mission's sequential env, K5 rendering; the template's unclip
        protocols given, so that the GPU and CPU templates are alike."""
        from metta_tpu_torch.engine.compiler import compile_game

        cfg = get_mission(name).make_env()
        cfg.game.map_builder.seed = SEED
        if max_steps:
            cfg.game.max_steps = max_steps
        NA = compile_game(cfg.game, cfg.game.map_builder.create().build())[0].n_assembler_slots
        env = MettaGridEnv(cfg, num_envs=E, seed=0, device=device,
                           template_unclip_proto=np.arange(NA, dtype=np.int32) % 4)
        env.tables.obs_renderer = "pl"
        return env

    totals = {}
    # each mission's first episode starts beside the stations it probes:
    # the chest with items to deposit, the clipped extractors with the tools
    # that unclip them
    deposit = ({"chest"}, {"carbon": 5, "oxygen": 5, "germanium": 5, "silicon": 5, "heart": 1})
    probes = {"training_facility.harvest": deposit,
              "evals.diagnostic_chest_deposit_near": deposit,
              "training_facility.repair": (("carbon_extractor", "oxygen_extractor"),
                                           {"decoder": 1, "modulator": 1, "resonator": 1,
                                            "scrambler": 1})}
    for name, (stations, inventory) in probes.items():
        for E in (1, 1024):
            def make(device, name=name, E=E):
                env = mission_env(name, E, device, max_steps=12)
                if env.step_mode != "sequential":
                    raise AssertionError(f"{name} does not take the sequential step")
                return env
            k5_before = k5.launches
            seen = cvc_gpu_vs_cpu(f"sequential {name} E={E} (K5)", make, E, 20,
                                  prepare=lambda env, s=tuple(stations), i=inventory:
                                  place_beside(env, s, i))
            if k5.launches - k5_before != 20:
                raise AssertionError(f"{name} E={E}: K5 rendered {k5.launches - k5_before} "
                                     f"of 20 steps")
            for k, v in seen.items():
                totals[k] = totals.get(k, 0) + v
    if totals["chest_uses"] == 0 or totals["unclips"] == 0:
        raise AssertionError(f"the sequential missions moved no chest item or unclipped "
                             f"nothing: {totals}")
    # the start-clipped mission with every draw from the env's own generator
    cfg = get_mission("training_facility.repair").make_env()
    cfg.game.max_steps = 6
    env = MettaGridEnv(cfg, num_envs=1024, seed=0, device="cuda")
    env.tables.obs_renderer = "pl"
    env.reset()
    for _ in range(15):
        env.step(torch.as_tensor(cvc_actions(np.random.default_rng(1), env.tables, 1024)))
    s = env.state.env
    protos = s.asm_unclip_proto[s.asm_clipped]
    if not (protos.numel() and bool(((protos >= 0)
                                     & (protos < env.tables.n_unclip_protocols)).all())):
        raise AssertionError("the repair mission's own draws left a clipped slot without a "
                             "protocol in range")
    log(f"[cvc] training_facility.repair E=1024 with its own draws: 15 steps, "
        f"{int(s.asm_clipped.sum())} clipped slots, each with a protocol in range")

    gen = torch.Generator(device="cuda").manual_seed(16)
    runs = {}
    for E, steps in ((1, 20), (1024, 10)):
        env = mission_env("training_facility.harvest", E, "cuda")
        env.reset()
        t = env.tables

        def run(n, env=env, t=t):
            for _ in range(n):
                acts = torch.randint(0, t.n_actions, (env.num_envs, t.num_agents),
                                     generator=gen, device="cuda")
                obs, *_ = env.step(acts)
                acc.add_(obs.sum(dtype=torch.int64))
        acc = torch.zeros((), dtype=torch.int64, device="cuda")
        run(2)
        torch.cuda.synchronize()
        k1.launches = k2.launches = k4.launches = k5.launches = 0   # the path's run starts
        walls = timed_windows(run, 3, steps)
        launches = {"k1": k1.launches, "k2": k2.launches, "k4": k4.launches,
                    "k5": k5.launches}                              # ... and ends
        if launches != {"k1": 0, "k2": 0, "k4": 0, "k5": 3 * steps}:
            raise AssertionError(f"harvest E={E}: launches in {3 * steps} steps {launches}")
        wall = statistics.median(walls)
        runs[E] = dict(env_steps_per_s=E * steps / wall, step_ms=1e3 * wall / steps,
                       launches=launches)
        log(f"[cvc] sequential training_facility.harvest E={E} A={t.num_agents}: "
            f"{E * steps / wall:.1f} env-steps/s; step {1e3 * wall / steps:.3f} ms (median of 3 "
            f"windows of {steps}; windows s {[round(w, 4) for w in walls]}); launches "
            f"{launches}; obs checksum {int(acc)}")
        del env
    res["cvc_sequential"] = dict(runs=runs, fired=totals)


def phase_cvc_clipped(res):
    """The clipped mission (``MISSIONS["clipped"]``: ``make_mission`` with the
    clipper, clip period 100) batched at E=4096 with
    ``track_stats=False``: K2 steps the env, then the regen and clipper
    tail; K1 or K4 renders. GPU against CPU over 10 steps (the same draws),
    byte-identical, with clips happening; then env-steps/s (median of 3
    windows of 20 steps) with the launches of that run, K2 once a step and
    one render a step."""
    from metta_tpu_torch.cogames.missions import MISSIONS
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.ops import obs_render3 as k1
    from metta_tpu_torch.ops import sim_fused as k2

    def make(device):
        cfg = MISSIONS["clipped"]()
        cfg.game.map_builder.seed = SEED
        cfg.game.max_steps = 12
        env = MettaGridEnv(cfg, num_envs=E_MAIN, seed=0, track_stats=False,
                           step_mode="batched", device=device)
        t = env.tables
        if not (env._sim_step is k2.fused_step_full and t.has_regen and t.clip_period > 0):
            raise AssertionError("make_mission('clipped') does not take K2 with its tail")
        return env

    before = (k2.launches, k1.launches + k4.launches)
    seen = cvc_gpu_vs_cpu(f"batched make_mission('clipped') E={E_MAIN} (K2)", make, E_MAIN, 10)
    if (k2.launches - before[0], k1.launches + k4.launches - before[1]) != (10, 10):
        raise AssertionError("the clipped mission did not step through K2 and one render")
    if seen["clips"] == 0 or seen["regen"] == 0:
        raise AssertionError(f"no clip or no regen tick in the clipped mission: {seen}")

    cfg = MISSIONS["clipped"]()
    cfg.game.map_builder.seed = SEED
    env = MettaGridEnv(cfg, num_envs=E_MAIN, seed=0, track_stats=False, step_mode="batched",
                       device="cuda")
    env.reset()
    t = env.tables
    gen = torch.Generator(device="cuda").manual_seed(17)
    acc = torch.zeros((), dtype=torch.int64, device="cuda")

    def run(n):
        for _ in range(n):
            obs, *_ = env.step(torch.randint(0, t.n_actions, (E_MAIN, t.num_agents),
                                             generator=gen, device="cuda"))
            acc.add_(obs.sum(dtype=torch.int64))
    run(5)
    torch.cuda.synchronize()
    k1.launches = k2.launches = k4.launches = 0             # the path's run starts
    walls = timed_windows(run, 3, 20)
    launches = {"k2": k2.launches, "k1": k1.launches, "k4": k4.launches}   # ... and ends
    if launches["k2"] != 60 or launches["k1"] + launches["k4"] != 60:
        raise AssertionError(f"clipped mission: launches in 60 steps {launches}")
    wall = statistics.median(walls)
    res["cvc_clipped"] = dict(env_steps_per_s=E_MAIN * 20 / wall, launches=launches,
                              fired=seen)
    log(f"[cvc] batched make_mission('clipped') E={E_MAIN} A={t.num_agents}: "
        f"{E_MAIN * 20 / wall:.1f} env-steps/s; step {1e3 * wall / 20:.3f} ms (median of 3 "
        f"windows of 20; windows s {[round(w, 4) for w in walls]}); launches in 60 steps "
        f"{launches}; obs checksum {int(acc)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if PORT_MISSING is not None:
        print(f"chip_smoke: run from a checkout of the repository ({PORT_MISSING})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    res, failed = {}, []
    t_start = time.time()
    for phase in (phase_build, phase_k1_vs_plain, phase_k2_vs_plain, phase_k4_vs_plain,
                  phase_gpu_vs_cpu, phase_throughput, phase_k3_vs_plain, phase_policy,
                  phase_train, phase_curriculum, phase_k5_vs_plain, phase_sequential,
                  phase_analysis, phase_k2_chests, phase_cvc_clipped, phase_cvc_sequential):
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
