"""Ablate sections of K2, the fused interaction span (``csrc/sim_fused.cu``), on the card.

Counterpart of ``scripts/ablate_fused.py``. It keeps that script's five
variants, each a copy of the combat ``Tables`` with section flags off:

    full        every section the config has
    noasm       has_assemblers=False
    noattack    has_attack=False
    noswap      has_swap=False
    bare        all three off

Each variant's copy gets its own table pack and statics from the kernel
wrapper's cache (``ops/sim_fused.py:launch_fused_span``), so the variants
launch the kernel instantiations that a config with those flags would
launch. Before it is timed, each variant's kernel output is held to its
plain version (``interaction_span`` on the same copied tables), byte for
byte. Prints one line per variant: device ms a launch, the wrapper's host
pace, what the variant saves against ``full``, the full span's bound and
the plain version's time.

Inputs. The JAX script times all-zero inputs, on which the TPU kernel does
the same work as on any other. This kernel branches on the data: on zeros
no agent moves, attacks or bumps a station, and the timing would be of a
kernel that does nothing. So the variants are timed on the seeded combat
state of ``chip_smoke.py`` phase 3 (map seed 1234, inventories 0-3 of each
resource, attack and transfer vibes on a third of the agents each), with
random actions (half moves) and a random agent order drawn from ``--seed``.

``--el`` is the number of envs a block of the CUDA launch holds at once,
one warp each (the TPU's env block width has this as its counterpart). The
default is the production launch; a value the kernel does not take raises.
``--only el<N>`` times ``full`` at that width, as the JAX script's
``el<N>`` entries sweep the block width.

Usage: python -m metta_tpu_torch.scripts.ablate_fused [--num-envs 4096]
    [--steps 20] [--el N] [--only full,noasm,el4] [--device cuda|cpu] [--seed 5]
"""

from __future__ import annotations

import argparse
import copy

VARIANTS = {
    "full": {},
    "noasm": dict(has_assemblers=False),
    "noattack": dict(has_attack=False),
    "noswap": dict(has_swap=False),
    "bare": dict(has_assemblers=False, has_attack=False, has_swap=False),
}
AGENTS = 24
MAP_SEED = 1234


def variant_tables(tables, name):
    """A copy of ``tables`` with variant ``name``'s flags set."""
    t = copy.copy(tables)
    for k, v in VARIANTS[name].items():
        setattr(t, k, v)
    return t


def run_variant(label, tables, state, acts, rank, el, steps, device, work):
    """Check one variant against its plain version (on the card) and time
    it: a dict of its numbers."""
    import torch

    from metta_tpu_torch.ops import sim_fused as k2
    from metta_tpu_torch.ops.timing import bound_of, cuda_time_ms
    from metta_tpu_torch.scripts.common import time_ms

    bound_ms, bound_by, _ = bound_of(*work)
    row = dict(variant=label, el=el, bound_ms=bound_ms, bound_by=bound_by)
    want = k2.fused_span_plain(state, acts, rank, tables)
    if device.type == "cuda":
        before = k2.launches
        got = k2.fused_span(state, acts, rank, tables, envs_per_block=el)
        torch.cuda.synchronize()
        k2.launches = before                       # the checking launch does not count
        bad = k2.span_mismatches(got, want)
        if bad:
            raise AssertionError(f"K2 {label}: differs from its plain version in {bad}")
        row["max_abs_err"] = 0
        row["ms"] = cuda_time_ms(
            lambda: k2.launch_fused_span(state, acts, rank, tables, envs_per_block=el), steps)
        row["host_ms"] = cuda_time_ms(
            lambda: k2.launch_fused_span(state, acts, rank, tables, envs_per_block=el), steps,
            queue_ahead=False)
    reps = 3 if device.type == "cuda" else 1
    row["plain_ms"] = time_ms(lambda: k2.fused_span_plain(state, acts, rank, tables), reps,
                              device)
    return row


def main(argv=None):
    from metta_tpu_torch.engine.step_batched import rank_from_perm
    from metta_tpu_torch.ops import sim_fused as k2
    from metta_tpu_torch.scripts.common import (add_device_flags, device_of, seeded_span_env,
                                                span_actions)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20, help="timed launches a variant")
    ap.add_argument("--el", type=int, default=None,
                    help="envs (warps) a block of the launch holds; default: production")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated variants, or el<N> for full at width N")
    add_device_flags(ap, seed=5)
    args = ap.parse_args(argv)
    device = device_of(args)
    E = args.num_envs

    env, gen = seeded_span_env("combat", E, AGENTS, MAP_SEED, args.seed, device)
    t, state = env.tables, env.state.env
    acts = span_actions(E, AGENTS, t.n_actions, gen)
    rank = rank_from_perm(None, E, AGENTS, gen, device)
    # the step is counted before the span, as batched_step does
    state = state.replace(step=state.step + 1)
    el = k2.check_envs_per_block(args.el)
    work = k2.span_work(state, acts, t)[:2]
    print(f"K2 ablation: combat E={E} A={AGENTS} on {device}; launch "
          f"{el if el is not None else 'production'} envs a block")

    names = args.only.split(",") if args.only else list(VARIANTS)
    rows, base = [], None
    for name in names:
        if name.startswith("el"):
            width = k2.check_envs_per_block(int(name[2:]))
            label, tv, w = f"full el={width}", variant_tables(t, "full"), width
        elif name in VARIANTS:
            label, tv, w = name, variant_tables(t, name), el
        else:
            raise ValueError(f"unknown variant {name!r}: {sorted(VARIANTS)} or el<N>")
        row = run_variant(label, tv, state, acts, rank, w, args.steps, device, work)
        if "ms" in row:
            base = row["ms"] if base is None and name == "full" else base
            row["saves_ms"] = None if base is None else base - row["ms"]
            saves = f"(saves {row['saves_ms']:7.4f})" if base is not None else ""
            print(f"variant {label:14s} {row['ms']:8.4f} ms/launch {saves}  host pace "
                  f"{row['host_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}), {100 * row['bound_ms'] / row['ms']:5.1f}% of it; "
                  f"plain {row['plain_ms']:.3f} ms")
        else:
            print(f"variant {label:14s} plain {row['plain_ms']:.3f} ms on the host (cpu)")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
