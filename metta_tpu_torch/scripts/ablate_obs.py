"""Ablate sections of K4, the v2 token render, on the card.

Counterpart of ``scripts/ablate_obs.py``: builds the combat map's render
inputs (map seed 1234, E=4096, 24 agents) and times each variant of K4's
first design (``csrc/obs_render2_ablate.cu``, a block per env) with sections
stubbed (``ops/ablate_obs.py``), each held to its plain version in the bytes
it defines, ``none`` to the production K4 (``csrc/obs_render2.cu``, the
persistent redesign) byte for byte. The TPU script runs ``none`` and all
sections; this one runs ``none``, each section alone, and all. Prints one
line per variant: ms a launch, what it saves against ``none``, the render's
bound and the variant's share of it.

K4's sections follow the CUDA kernel. The TPU script's sections map onto
them so:

    TPU script          this script
    winread, decode     read (fill: the prefill, split out of it)
    prefix              prefix
    scatter             scatter
    write, antidiag     globals + store

Usage: python -m metta_tpu_torch.scripts.ablate_obs [--num-envs 4096]
    [--steps 30] [--agents 24] [--only none,read] [--device cuda|cpu] [--seed 1234]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from metta_tpu_torch.ops import ablate_obs as ab
    from metta_tpu_torch.ops import obs_render2 as k4
    from metta_tpu_torch.scripts.common import (ablate, add_device_flags, combat_prep,
                                                device_of)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=30, help="timed launches a variant")
    ap.add_argument("--agents", type=int, default=24)
    ap.add_argument("--only", type=str, default=None, help="comma-separated variants")
    add_device_flags(ap, seed=1234)
    args = ap.parse_args(argv)
    device = device_of(args)

    t, inputs = combat_prep(args.num_envs, args.agents, args.seed, device)
    extra = (k4.rank_table(t.obs_scan, t.obs_width), t.num_obs_tokens, t.obs_height,
             t.obs_width)
    variants = args.only.split(",") if args.only else ab.variants(ab.SECTIONS2)
    print(f"K4 ablation: combat E={args.num_envs} A={args.agents} T={t.num_obs_tokens} "
          f"on {device}")
    work = ab.render_work(inputs, t.obs_scan, t.num_obs_tokens)[:2]
    return ablate(
        "K4", ab.SECTIONS2,
        lambda skips, out=None: ab.render_obs2_ablated(skips, *inputs, *extra, out=out),
        lambda skips: ab.render_obs2_ablated_plain(skips, *inputs, *extra),
        lambda: k4.render_obs2(*inputs, *extra),
        variants, args.steps, device, work)


if __name__ == "__main__":
    main()
