"""Chip smoke test of the PyTorch/CUDA port (``metta_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each one a hard failure):

1. build every CUDA kernel of the port from ``metta_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the card's name and
   power limit;
2. K1 (``csrc/obs_render3.cu``) against its plain torch version
   (``render_obs3_plain``) at the main path's shapes: the combat map, 24
   agents, 4096 envs, ``track_stats=True``, 20 random steps, byte-equal;
3. the port on the GPU against the port on the CPU: 8 envs, 30 steps, the
   same agent orders and desync draws; state and obs byte-identical;
4. throughput of the main path, ``MettaGridEnv.step`` at 4096 envs: 100 steps
   after 10 warm-up steps, obs consumed every step, median of 5 windows;
   kernel launch counts of that run; K1's time per launch, its plain
   version's time and its memory bound; a short profile of where the step's
   device time goes; ``hardware_sanity`` (ore and a converted resource
   present in the inventories, as ``bench.py`` checks).

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


def combat_cfg():
    from metta_tpu_torch.builder.envs import make_combat

    cfg = make_combat(AGENTS)
    cfg.game.map_builder.seed = SEED
    return cfg


def cuda_time_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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

    env = MettaGridEnv(combat_cfg(), num_envs=E_MAIN, seed=0, track_stats=True,
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


def phase_gpu_vs_cpu(res):
    """The port on the GPU against the port on the CPU, byte for byte."""
    from metta_tpu_torch.convert import state_to_numpy
    from metta_tpu_torch.engine.env import MettaGridEnv

    E, steps = 8, 30
    envs = [MettaGridEnv(combat_cfg(), num_envs=E, seed=0, track_stats=True, device=d)
            for d in ("cuda", "cpu")]
    rng = np.random.default_rng(2)
    desync = rng.integers(1, steps, E)
    obs = [env.reset(desync_step=desync) for env in envs]
    if not torch.equal(obs[0].cpu(), obs[1]):
        raise AssertionError("reset observations differ between GPU and CPU")
    n_actions = envs[0].tables.n_actions
    ended = 0
    for i in range(steps):
        acts = rng.integers(0, n_actions, (E, AGENTS))
        perm = torch.as_tensor(np.stack([rng.permutation(AGENTS) for _ in range(E)]))
        outs = [env.step(acts, perm=perm) for env in envs]
        for name, g, c in zip(("obs", "reward", "done", "truncated"), *outs):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"step {i}: {name} differs between GPU and CPU")
        ended += int((outs[1][2] | outs[1][3]).sum())
        sg, sc = state_to_numpy(envs[0].state), state_to_numpy(envs[1].state)
        for name in sc["env"]:
            if not np.array_equal(sg["env"][name], sc["env"][name]):
                raise AssertionError(f"step {i}: state field {name} differs")
    log(f"[gpu-vs-cpu] state and obs byte-identical over {steps} steps at E={E}; "
        f"{ended} episode ends (auto-reset)")


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
        f"({step_ms:.3f} ms); {sum(r[2] for r in rows)} kernel launches")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / dev_us:5.1f}% x{count:5d} {key[:90]}")
    log("[profile] torch ops by input shape, self device time:")
    for key, shapes, us, count in sorted(ops, key=lambda r: -r[2])[:12]:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / dev_us:5.1f}% x{count:5d} "
            f"{key} {str(shapes)[:80]}")


def phase_throughput(res):
    """The main path: MettaGridEnv.step at E=4096, obs consumed."""
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.ops import obs_render3 as k1

    env = MettaGridEnv(combat_cfg(), num_envs=E_MAIN, seed=0, track_stats=True,
                       device="cuda")
    env.reset()
    t = env.tables
    gen = torch.Generator(device="cuda").manual_seed(3)
    acc = torch.zeros((), dtype=torch.int64, device="cuda")

    def run(n):
        nonlocal acc
        for _ in range(n):
            acts = torch.randint(0, t.n_actions, (E_MAIN, AGENTS), generator=gen,
                                 device="cuda")
            obs, rew, done, trunc = env.step(acts)
            acc = acc + obs.sum(dtype=torch.int64)     # consume every byte of obs

    run(10)
    torch.cuda.synchronize()
    k1.launches = 0                                    # the main path's run starts
    steps, walls = 100, []
    for _ in range(5):
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = k1.launches                             # ... and ends
    n_steps = 5 * steps
    if launches < n_steps:
        raise AssertionError(f"K1 launched {launches} times in {n_steps} main-path steps")
    wall = statistics.median(walls)
    res["env_steps_per_s"] = E_MAIN * steps / wall
    log(f"[throughput] E={E_MAIN} A={AGENTS}: {res['env_steps_per_s']:.1f} env-steps/s, "
        f"{res['env_steps_per_s'] * AGENTS:.1f} agent-steps/s; "
        f"step {1e3 * wall / steps:.3f} ms (median of 5 windows of {steps} steps; "
        f"windows s {[round(w, 4) for w in walls]}); obs checksum {int(acc)}")
    log(f"[throughput] K1 launches {launches} in {n_steps} steps = "
        f"{launches / n_steps:.2f} per step")

    # K1 alone at the main path's shapes (inputs of the last state)
    s = env.state.env
    args = k1.prep_env3(s, t, s.executed_action, s.reward)
    out = k1.render_obs3(*args, *render_args(t))
    before = k1.launches
    ms = cuda_time_ms(lambda: k1.render_obs3(*args, *render_args(t)), 50)
    plain_ms = cuda_time_ms(lambda: k1.render_obs3_plain(*args, *render_args(t)), 5)
    k1.launches = before                                # timing launches do not count
    nbytes, ops, parts = k1_work(args, t.obs_scan, t.num_obs_tokens)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    whole = sum(x.numel() * x.element_size() for x in (*args, t.obs_scan, out))
    log(f"[k1] {ms:.4f} ms per launch, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms: "
        f"{nbytes / 1e6:.2f} MB needed at 3.35 TB/s "
        f"{ {k: round(v / 1e6, 2) for k, v in parts.items()} } MB, "
        f"{ops / 1e6:.1f} M int32 ops at 33.5 T/s = {ops_ms:.4f} ms; "
        f"{100 * bound_ms / ms:.1f}% of the bound "
        f"(every input read whole: {whole / 1e6:.1f} MB, {1e3 * whole / HBM_BYTES_PER_S:.4f} ms)")
    res["kernels"] = [{
        "name": "obs_render3",
        "route": "cuda",
        "source": "metta_tpu_torch/csrc/obs_render3.cu",
        "replaces": "metta_tpu/ops/obs_render3.py:110",
        "launches": launches,
        "max_abs_err": res.get("k1_max_abs_err"),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
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
    for phase in (phase_build, phase_k1_vs_plain, phase_gpu_vs_cpu, phase_throughput):
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
