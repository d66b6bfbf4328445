"""What the analysis scripts and ``chip_smoke.py`` share: the device flag,
the combat inputs of the render ablations, the seeded state of K2's
ablation, the chest config of K2's chest phase, and the render ablation
loop itself."""

from __future__ import annotations

import time

import torch

from metta_tpu_torch.ops.timing import bound_of, cuda_time_ms


def add_device_flags(ap, seed: int):
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the kernels on the card; cpu: their plain versions")
    ap.add_argument("--seed", type=int, default=seed)


def device_of(args) -> torch.device:
    """The device the flags ask for; a card that is missing is an error,
    never a fall back to the CPU."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain versions")
    return torch.device(args.device)


def time_ms(fn, reps: int, device) -> float:
    """Device milliseconds per call on the card (``cuda_time_ms``); on the
    CPU host milliseconds, which are no device metric."""
    if device.type == "cuda":
        return cuda_time_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def combat_prep(num_envs: int, agents: int, seed: int, device):
    """The combat map (map seed ``seed``) reset at ``num_envs`` envs with
    ``track_stats=False``, as ``scripts/ablate_obs*.py`` build it, and its
    render inputs from ``prep_env3`` -> (tables, the six inputs)."""
    from metta_tpu_torch.builder.envs import make_combat
    from metta_tpu_torch.engine.env import MettaGridEnv
    from metta_tpu_torch.ops.obs_render3 import prep_env3

    cfg = make_combat(agents)
    cfg.game.map_builder.seed = seed
    env = MettaGridEnv(cfg, num_envs=num_envs, seed=0, desync_episodes=True,
                       track_stats=False, step_mode="batched", device=device)
    env.reset()
    s, t = env.state.env, env.tables
    return t, prep_env3(s, t, s.executed_action, s.reward)


def chest_mission(size: int = 32, chests: int = 2, seed=None):
    """The config that runs K2's chest phase: ``make_mission("basic")`` of
    ``cogames/missions.py`` (4 cogs, a ``size`` x ``size`` map) with the
    catalog's chest station (``CvCChestConfig``, its vibe transfers as
    ``TrainingVariant`` sets them) placed ``chests`` times by the mission's
    Random scene. No catalog mission reaches the fused span: their coupled
    limit groups take the sequential step."""
    from metta_tpu_torch.cogames.missions import make_mission
    from metta_tpu_torch.cogames.stations import CvCChestConfig
    from metta_tpu_torch.cogames.variants import TrainingVariant

    cfg = make_mission("basic", width=size, height=size)
    cfg.game.objects["chest"] = CvCChestConfig().station_cfg()
    TrainingVariant().modify_env(None, cfg)
    cfg.game.map_builder.instance.objects["chest"] = chests
    cfg.game.map_builder.seed = seed
    return cfg


def seeded_span_env(name: str, num_envs: int, agents: int, map_seed: int, seed: int, device,
                    track_gained: bool = False):
    """A ``track_stats=False`` batched env of ``make_<name>(agents)`` (map
    seed ``map_seed``), reset on ``device``, with seeded inventories (0-3 of
    each resource) and vibes (the config's attack and transfer vibes on a
    third of the agents each), so that every section of the interaction
    span fires -> (env, the generator that seeded it, on ``device``)."""
    from metta_tpu_torch.builder import envs
    from metta_tpu_torch.engine.env import MettaGridEnv

    cfg = getattr(envs, f"make_{name}")(agents)
    cfg.game.map_builder.seed = map_seed
    env = MettaGridEnv(cfg, num_envs=num_envs, seed=0, track_stats=False,
                       step_mode="batched", device=device)
    if track_gained:
        env.tables.track_gained = True
    env.reset()
    t, s = env.tables, env.state.env
    gen = torch.Generator(device=device).manual_seed(seed)
    vibes = [0, 3] + [int(v) for m in (t.attack_vibe_mask, t.transfer_vibe_mask)
                      for v in torch.nonzero(m).flatten()] * 2
    vibes = torch.tensor(vibes, device=device)
    pick = torch.randint(0, len(vibes), s.agent_vibe.shape, generator=gen, device=device)
    env._state = env.state.replace(env=s.replace(
        agent_inv=torch.randint(0, 4, s.agent_inv.shape, generator=gen, device=device,
                                dtype=torch.int32),
        agent_vibe=vibes[pick].to(torch.int32),
    ))
    return env, gen


def span_actions(num_envs: int, agents: int, n_actions: int, gen):
    """[E, A] int32 actions on ``gen``'s device: half moves, half any id in
    [-1, n_actions] (invalid ids too)."""
    dev = gen.device
    moves = torch.randint(1, 5, (num_envs, agents), generator=gen, device=dev)
    anything = torch.randint(-1, n_actions + 1, (num_envs, agents), generator=gen, device=dev)
    half = torch.rand((num_envs, agents), generator=gen, device=dev) < 0.5
    return torch.where(half, moves, anything).to(torch.int32)


def ablate(name, sections, kernel, plain, production, variants, steps, device, work):
    """Time each variant of an ablated render and hold it to its plain version.

    ``kernel(skips, out=None)`` launches the variant, ``plain(skips)`` gives
    (out, defined), ``production()`` the unablated render; ``work`` is
    (bytes, ops) of the render. On the card each variant must equal its
    plain version in its defined bytes, and ``none`` the production render
    byte for byte; the production render is timed beside ``none`` on the
    same inputs. Returns one dict per variant."""
    from metta_tpu_torch.ops import ablate_obs as ab

    bound_ms, bound_by, _ = bound_of(*work)
    rows, base = [], None
    for v in variants:
        skips = ab.skips_of(v, sections)
        want, defined = plain(skips)
        row = dict(variant=v, defined=float(defined.float().mean()))
        if device.type == "cuda":
            counts = ab.launches_obs3, ab.launches_obs2
            got = kernel(skips)
            torch.cuda.synchronize()
            ab.launches_obs3, ab.launches_obs2 = counts    # checking launches do not count
            bad = int(((got != want) & defined).sum())
            row["max_abs_err"] = int(((got.int() - want.int()).abs() * defined).max())
            if bad:
                raise AssertionError(f"{name} {v}: {bad} defined bytes differ from the plain version")
            if not skips and not (defined.all() and torch.equal(got, production())):
                raise AssertionError(f"{name} none differs from the production kernel")
            buf = torch.zeros_like(got)
            row["ms"] = time_ms(lambda: kernel(skips, out=buf), steps, device)
            if not skips:
                row["production_ms"] = time_ms(production, steps, device)
        row["plain_ms"] = time_ms(lambda: plain(skips), 3 if device.type == "cuda" else 1, device)
        row.update(bound_ms=bound_ms, bound_by=bound_by)
        if "ms" in row:
            base = row["ms"] if base is None and v == "none" else base
            saves = f"(saves {base - row['ms']:7.4f})" if base is not None else ""
            if "production_ms" in row:
                saves += f" (production {row['production_ms']:.4f} ms)"
            print(f"skip {v:44s} {row['ms']:8.4f} ms/launch {saves}  bound {bound_ms:.4f} ms "
                f"({bound_by}), {100 * bound_ms / row['ms']:5.1f}% of it; plain "
                f"{row['plain_ms']:.3f} ms; {100 * row['defined']:.1f}% of bytes defined")
            row["saves_ms"] = None if base is None else base - row["ms"]
        else:
            print(f"skip {v:44s} plain {row['plain_ms']:.3f} ms on the host (cpu); "
                f"{100 * row['defined']:.1f}% of bytes defined")
        rows.append(row)
    return rows
