"""Ablate sections of K4, the v2 token render (``csrc/obs_render2.cu``), on the card.

Counterpart of ``scripts/ablate_obs.py``: builds the combat map's render
inputs (map seed 1234, E=4096, 24 agents) and times each variant of the
production kernel with sections stubbed (``ops/ablate_obs.py``; the kernel
is a template on its section mask, launched on the render's own grid at
one pass of 128 window cells), each held to its plain version in the bytes
it defines, ``none`` to the production K4 byte for byte and timed beside it
on the same inputs. The TPU script runs ``none`` and all sections; this
one runs ``none``, each section alone, and all. Prints one line per
variant: ms a launch, what it saves against ``none``, the render's bound
and the variant's share of it.

K4's sections follow the persistent CUDA kernel's steps, under K1's names,
not the TPU kernel's one-hot GEMMs. The TPU script's sections map onto
them so:

    TPU script          this script
    winread             winread (level 2's grid loads)
    decode              count (level 3's count loads), and copy's token loads
    prefix              scan (the warp scan in rank order)
    scatter             copy (the lane search, the shuffles, the staging writes)
    write               store (the token words)
    antidiag            globals + fill + store (the merge with the global
                        tokens, the 255s, the row's stores)

Usage: python -m metta_tpu_torch.scripts.ablate_obs [--num-envs 4096]
    [--steps 30] [--agents 24] [--only none,copy] [--device cuda|cpu] [--seed 1234]
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
