"""Ablate sections of K1, the v3 token render (``csrc/obs_render3.cu``), on the card.

Counterpart of ``scripts/ablate_obs3.py``: builds the combat map's render
inputs (map seed 1234, E=4096, 24 agents) and times each variant of the
production kernel with sections stubbed (``ops/ablate_obs.py``; the kernel
is a template on its section mask, launched on the render's own grid), each
held to its plain version in the bytes it defines, ``none`` to the
production K1 byte for byte. Prints one line per variant: ms a launch, what
it saves against ``none``, the render's bound and the variant's share of it.

K1's sections follow the persistent CUDA kernel's steps, not the TPU
kernel's one-hot formulation. The TPU script's sections map onto them so:

    TPU script          this script
    winread             winread (step 1's grid loads)
    repack              none: step 1 reads the window in scan order
    decode              count (the counts), and copy's token loads
    search, fetch       copy (the lane search, the token loads)
    (its prefix GEMM,   scan (the warp scan)
     never stubbed)
    out                 globals + fill + store

Usage: python -m metta_tpu_torch.scripts.ablate_obs3 [--num-envs 4096]
    [--steps 30] [--agents 24] [--only none,copy] [--device cuda|cpu] [--seed 1234]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from metta_tpu_torch.ops import ablate_obs as ab
    from metta_tpu_torch.ops import obs_render3 as k1
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
    extra = (t.obs_scan, t.num_obs_tokens, t.obs_height // 2, t.obs_width // 2)
    variants = args.only.split(",") if args.only else ab.variants(ab.SECTIONS3)
    print(f"K1 ablation: combat E={args.num_envs} A={args.agents} T={t.num_obs_tokens} "
          f"on {device}")
    work = ab.render_work(inputs, t.obs_scan, t.num_obs_tokens)[:2]
    return ablate(
        "K1", ab.SECTIONS3,
        lambda skips, out=None: ab.render_obs3_ablated(skips, *inputs, *extra, out=out),
        lambda skips: ab.render_obs3_ablated_plain(skips, *inputs, *extra),
        lambda: k1.render_obs3(*inputs, *extra),
        variants, args.steps, device, work)


if __name__ == "__main__":
    main()
