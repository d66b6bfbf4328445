"""The ``cogames`` command — the player-facing front door.

Parity: reference ``packages/cogames/src/cogames/main.py`` (typer app with
missions/describe/variants/evals/play/tutorial/make-mission/policies/
validate-policy/diagnose/version/docs). Rebuilt on argparse (stdlib-only) over
the existing catalog/variant/eval/scripted modules; rendering uses the
miniscope terminal renderer instead of the Nim mettascope GUI.

Run as ``python -m metta_tpu_torch.cogames <command>``.
"""

# The port's counterpart of metta_tpu/cogames/main.py: the same commands,
# options and output (``docs`` prints the docstring above), with play,
# tutorial, validate-policy and diagnose on the port's MettaGridEnv (the
# sequential step, as the JAX env takes it for the missions' coupled limit
# groups) on --device, the card by default. The env's randomness (agent
# orders, the clipper) comes from its own torch.Generator seeded with --seed.

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _resolve_mission(name: str, cogs: Optional[int], variants: List[str]):
    from metta_tpu_torch.cogames.catalog import get_mission
    from metta_tpu_torch.cogames.mission import NumCogsVariant
    from metta_tpu_torch.cogames.variants import VARIANTS

    mission = get_mission(name)
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(
                f"unknown variant: {v!r}; known: {sorted(VARIANTS)}")
        mission = VARIANTS[v]().apply(mission)
    if cogs is not None:
        mission = NumCogsVariant(num_cogs=cogs).apply(mission)
    return mission


def _make_policy(spec: str, env, seed: int = 0):
    from metta_tpu_torch.cogames.scripted import ScriptedBaselineAgent
    from metta_tpu_torch.policy.policy import NetworkPolicy, NoopPolicy, RandomPolicy

    if spec in ("scripted", "baseline"):
        return ScriptedBaselineAgent(env, seed=seed)
    if spec == "random":
        return RandomPolicy(env.compiled.n_actions, seed=seed)
    if spec == "noop":
        return NoopPolicy()
    return NetworkPolicy.from_bundle(spec, env.compiled, n_slots=env.num_agents,
                                     seed=seed, device=env.device)


def _env(cfg, args, **kw):
    """The port's env of ``cfg`` on ``args.device`` (the card by default),
    its generator seeded with ``args.seed``."""
    from metta_tpu_torch.engine.env import MettaGridEnv

    return MettaGridEnv(cfg, num_envs=1, seed=getattr(args, "seed", 0),
                        device=getattr(args, "device", "cuda"), **kw)


POLICY_SHORTHANDS = {
    "scripted": "map/BFS/phase-machine baseline (cogames/scripted.py)",
    "random": "uniform-random actions",
    "noop": "always noop",
    "<uri>": "a trained checkpoint bundle (file://..., wandb://..., s3://...)",
}


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------


def cmd_missions(args) -> int:
    from metta_tpu_torch.cogames.catalog import get_missions

    if args.mission:
        return cmd_describe(argparse.Namespace(
            mission=args.mission, cogs=args.cogs, variant=args.variant or []))
    rows = []
    for m in get_missions():
        if args.site and m.site.name != args.site:
            continue
        rows.append((m.full_name(), m.site.name,
                     (m.description or "").split("\n")[0][:60]))
    if not rows:
        print(f"no missions for site {args.site!r}")
        return 1
    w = max(len(r[0]) for r in rows)
    for name, site, desc in rows:
        print(f"{name:<{w}}  {desc}")
    print(f"\n{len(rows)} missions. `cogames describe <mission>` for details.")
    return 0


def cmd_describe(args) -> int:
    mission = _resolve_mission(args.mission, args.cogs, args.variant or [])
    env_cfg = mission.make_env()
    g = env_cfg.game
    print(f"mission:  {mission.full_name()}")
    print(f"site:     {mission.site.name} — {mission.site.description}")
    if mission.description:
        print(f"about:    {mission.description}")
    print(f"cogs:     {g.num_agents}")
    print(f"map:      {getattr(g.map_builder, 'width', '?')}x"
          f"{getattr(g.map_builder, 'height', '?')}  max_steps {g.max_steps}")
    print(f"stations: {', '.join(sorted(g.objects))}")
    print(f"actions:  {', '.join(n for n, a in vars(g.actions).items() if getattr(a, 'enabled', True))}")
    return 0


def cmd_evals(args) -> int:
    from metta_tpu_torch.cogames.evals import get_diagnostic_missions, get_spanning_missions

    print("diagnostic evals:")
    for m in get_diagnostic_missions():
        print(f"  {m.full_name():<42} {(m.description or '').split(chr(10))[0][:70]}")
    print("spanning evals:")
    for m in get_spanning_missions():
        print(f"  {m.full_name():<42} {(m.description or '').split(chr(10))[0][:70]}")
    return 0


def cmd_variants(args) -> int:
    from metta_tpu_torch.cogames.variants import VARIANTS

    for name, v in sorted(VARIANTS.items()):
        doc = (v.__doc__ or "").strip().split("\n")[0]
        print(f"{name:<28} {doc}")
    return 0


def cmd_play(args) -> int:
    mission = _resolve_mission(args.mission, args.cogs, args.variant or [])
    cfg = mission.make_env()
    if args.map_seed is not None:
        cfg.game.map_builder.seed = args.map_seed
    cfg.desync_episodes = False
    env = _env(cfg, args, track_stats=True)
    obs = env.reset()
    policy = _make_policy(args.policy, env, seed=args.seed)
    steps = args.steps or cfg.game.max_steps or 1000

    if args.interactive:
        from metta_tpu_torch.renderer.miniscope import MiniscopeRenderer

        MiniscopeRenderer(env).interactive_loop(policy, max_steps=steps)
        return 0

    renderer = None
    if args.render:
        from metta_tpu_torch.renderer.miniscope import MiniscopeRenderer

        renderer = MiniscopeRenderer(env)
    total = np.zeros((env.num_agents,), np.float64)
    for t in range(steps):
        acts = policy.step_batch(obs[0])
        obs, rew, done, trunc = env.step_no_reset(acts[None])
        total += rew.cpu().numpy().reshape(-1)
        if renderer is not None and t % max(args.render_interval, 1) == 0:
            renderer.render()
        if bool((done | trunc).any()):
            break
    print(f"\nepisode over after {t + 1} steps")
    print(f"reward/cog: {np.round(total, 3).tolist()}  total {total.sum():.3f}")
    st = env.state.env
    gained = st.agent_gained.cpu().numpy().sum(axis=(0, 1))
    names = list(cfg.game.resource_names)
    nz = {names[i]: int(gained[i]) for i in range(len(names)) if gained[i]}
    print(f"resources gained: {nz or 'none'}")
    return 0


def cmd_tutorial(args) -> int:
    print(__doc__.split("\n")[0])
    print("""
Welcome to Cogs vs Clips!  You command a crew of cogs on a derelict station.

  goal     assemble HEARTS at the assembler (3 red batteries -> 1 heart)
  chain    mine ore at extractors -> charge it into batteries -> assemble
  beware   the Clipper slowly clips stations; unclip them to keep producing

Watch the scripted baseline crew play the tutorial mission:
""")
    ns = argparse.Namespace(
        mission="training_facility.tutorial", policy="scripted",
        cogs=None, variant=[], steps=args.steps, seed=0, map_seed=7,
        render=args.render, render_interval=25, interactive=False,
        device=args.device,
    )
    rc = cmd_play(ns)
    print("""
next steps:
  cogames missions                     # every mission
  cogames play <mission> --interactive # drive cog 0 yourself (wasd + u)
  cogames play <mission> --policy <checkpoint-uri>
""")
    return rc


def cmd_make_mission(args) -> int:
    mission = _resolve_mission(args.mission, args.cogs, args.variant or [])
    env_cfg = mission.make_env()
    payload = env_cfg.model_dump() if args.mg_config else mission.model_dump()
    text = json.dumps(payload, indent=2, default=str)
    if args.save:
        with open(args.save, "w") as f:
            f.write(text)
        print(f"wrote {args.save}")
    else:
        print(text)
    return 0


def cmd_policies(args) -> int:
    for k, v in POLICY_SHORTHANDS.items():
        print(f"{k:<10} {v}")
    return 0


def cmd_validate_policy(args) -> int:
    mission = _resolve_mission(args.mission, None, [])
    cfg = mission.make_env()
    env = _env(cfg, args)
    obs = env.reset()
    policy = _make_policy(args.uri, env)
    acts = policy.step_batch(obs[0]).cpu().numpy()
    ok = acts.shape == (env.num_agents,) and (acts >= 0).all() \
        and (acts < env.compiled.n_actions).all()
    print(f"policy {args.uri}: {'OK' if ok else 'INVALID'} "
          f"(actions {acts.tolist()})")
    return 0 if ok else 1


def cmd_diagnose(args) -> int:
    from metta_tpu_torch.cogames.evals import get_diagnostic_missions

    failures = 0
    for m in get_diagnostic_missions():
        cfg = m.make_env()
        cfg.game.map_builder.seed = 7
        cfg.desync_episodes = False
        env = _env(cfg, args, track_stats=True)
        obs = env.reset()
        policy = _make_policy(args.policy, env, seed=args.seed)
        steps = cfg.game.max_steps or 200
        total = 0.0
        for _ in range(steps):
            acts = policy.step_batch(obs[0])
            obs, rew, done, trunc = env.step_no_reset(acts[None])
            total += float(rew.sum())
            if bool((done | trunc).any()):
                break
        st = env.state.env
        hearts = 0
        names = list(cfg.game.resource_names)
        if "heart" in names:
            hearts = int(st.agent_gained[..., names.index("heart")].sum())
        passed = total > 0 or hearts > 0
        failures += 0 if passed else 1
        print(f"{'PASS' if passed else 'FAIL'}  {m.full_name():<42} "
              f"reward {total:8.3f}  hearts {hearts}")
    return 1 if failures else 0


def cmd_version(args) -> int:
    import metta_tpu_torch

    print(f"cogames (metta_tpu_torch) {getattr(metta_tpu_torch, '__version__', '0.dev')}")
    return 0


def cmd_docs(args) -> int:
    print(__doc__)
    print("commands: missions, describe, evals, variants, play, tutorial,")
    print("          make-mission, policies, validate-policy, diagnose, version")
    return 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cogames",
        description="CoGames: cooperative multi-agent missions (Cogs vs Clips)",
    )
    sub = p.add_subparsers(dest="command")

    def add(name, fn, aliases=()):
        sp = sub.add_parser(name, aliases=list(aliases))
        sp.set_defaults(fn=fn)
        return sp

    sp = add("missions", cmd_missions, aliases=("games",))
    sp.add_argument("site", nargs="?", default=None)
    sp.add_argument("--mission", "-m", default=None)
    sp.add_argument("--cogs", "-c", type=int, default=None)
    sp.add_argument("--variant", "-v", action="append", default=[])

    sp = add("describe", cmd_describe)
    sp.add_argument("mission")
    sp.add_argument("--cogs", "-c", type=int, default=None)
    sp.add_argument("--variant", "-v", action="append", default=[])

    add("evals", cmd_evals)
    add("variants", cmd_variants)

    sp = add("play", cmd_play)
    sp.add_argument("mission", nargs="?", default="training_facility.tutorial")
    sp.add_argument("--policy", "-p", default="scripted")
    sp.add_argument("--cogs", "-c", type=int, default=None)
    sp.add_argument("--variant", "-v", action="append", default=[])
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--map-seed", type=int, default=None)
    sp.add_argument("--render", action=argparse.BooleanOptionalAction,
                    default=False)
    sp.add_argument("--render-interval", type=int, default=25)
    sp.add_argument("--interactive", "-i", action="store_true")
    sp.add_argument("--device", default="cuda")

    sp = add("tutorial", cmd_tutorial)
    sp.add_argument("subcommand", nargs="?", default="play")
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--render", action=argparse.BooleanOptionalAction,
                    default=False)
    sp.add_argument("--device", default="cuda")

    sp = add("make-mission", cmd_make_mission, aliases=("make-game",))
    sp.add_argument("mission")
    sp.add_argument("--cogs", "-c", type=int, default=None)
    sp.add_argument("--variant", "-v", action="append", default=[])
    sp.add_argument("--save", "-s", default=None)
    sp.add_argument("--mg-config", action="store_true",
                    help="dump the compiled MettaGridConfig instead")

    add("policies", cmd_policies)

    sp = add("validate-policy", cmd_validate_policy)
    sp.add_argument("uri")
    sp.add_argument("--mission", default="training_facility.tutorial")
    sp.add_argument("--device", default="cuda")

    sp = add("diagnose", cmd_diagnose)
    sp.add_argument("policy", nargs="?", default="scripted")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda")

    add("version", cmd_version)
    add("docs", cmd_docs)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not getattr(args, "fn", None):
        build_parser().print_help()
        return 0
    try:
        return args.fn(args)
    except KeyError as e:
        print(e.args[0] if e.args else e, file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
