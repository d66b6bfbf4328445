"""Micro-benchmark the fused sim kernel's layout primitives (``csrc/ubench_pairmat.cu``).

Counterpart of ``scripts/ubench_pairmat.py``: each case repeats one
primitive REP=32 times over x [24, E] int32 (random in [0, 24) from
``--seed``): a thread per element where the case uses only its own agent's
value, K2's formulation (a warp per env, lane = agent, warp shuffles and
reduce) where it needs the env's other agents (bT, pair_full, red_a). On
the card each case is held byte for byte to its plain version and timed;
prints ms in total, ns per env per rep, the bound and its share, and the
plain version's time.

Usage: python -m metta_tpu_torch.scripts.ubench_pairmat [--num-envs 4096]
    [--only elemwise,tdiv] [--device cuda|cpu] [--seed 0]
"""

from __future__ import annotations

import argparse


TIMED_LAUNCHES = 20                 # a case's launches between the CUDA events


def main(argv=None):
    import numpy as np
    import torch

    from metta_tpu_torch.ops import ubench_pairmat as s2
    from metta_tpu_torch.ops.timing import bound_of
    from metta_tpu_torch.scripts.common import add_device_flags, device_of, time_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--only", type=str, default=None, help="comma-separated cases")
    add_device_flags(ap, seed=0)
    args = ap.parse_args(argv)
    device = device_of(args)
    E = args.num_envs

    x = torch.from_numpy(np.random.default_rng(args.seed).integers(0, 24, (s2.A, E),
                                                                   dtype=np.int32)).to(device)
    rows = []
    for name in (args.only.split(",") if args.only else s2.CASES):
        want = s2.plain(name, x)
        row = dict(case=name)
        if device.type == "cuda":
            before = s2.launches
            got = s2.run(name, x)
            torch.cuda.synchronize()
            s2.launches = before                      # checking launches do not count
            row["max_abs_err"] = int((got.long() - want.long()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: {int((got != want).sum())} elements differ "
                                     f"from the plain version")
            row["ms"] = time_ms(lambda: s2.run(name, x), TIMED_LAUNCHES, device)
        row["plain_ms"] = time_ms(lambda: s2.plain(name, x), 3 if device.type == "cuda" else 1,
                                  device)
        row["bound_ms"], row["bound_by"], _ = bound_of(2 * 4 * s2.A * E,
                                                       s2.OPS_PER_ELEMENT[name] * s2.A * E)
        if "ms" in row:
            print(f"{name:12s} {row['ms']:8.4f} ms total {1e6 * row['ms'] / E / s2.REP:8.3f} "
                  f"ns/env/rep  bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{100 * row['bound_ms'] / row['ms']:5.1f}%)  plain {row['plain_ms']:.3f} ms")
        else:
            print(f"{name:12s} plain {row['plain_ms']:.3f} ms on the host (cpu)")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
