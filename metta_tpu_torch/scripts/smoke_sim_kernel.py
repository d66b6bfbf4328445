"""Smoke check of the fused sim kernel's warp primitives (``csrc/smoke_sim.cu``).

Counterpart of ``scripts/smoke_sim_kernel.py``: random r [24, E] in [0, 5)
and inv [10, 24, E] in [0, 3) from ``--seed``; out1 (pair counts, both
ways) and out2 (inventory sum, capped at 7) against a numpy reference.
Prints ``smoke OK cuda`` (the kernel) or ``smoke OK cpu`` (the plain
version) and raises on a mismatch.

Usage: python -m metta_tpu_torch.scripts.smoke_sim_kernel [--num-envs 256]
    [--device cuda|cpu] [--seed 0]
"""

from __future__ import annotations

import argparse


def reference(rn, invn):
    """The numpy reference of ``scripts/smoke_sim_kernel.py``."""
    import numpy as np

    eq = rn[:, None, :] == rn[None, :, :]                 # [a, t, e]
    return eq.sum(axis=1) + eq.sum(axis=0), np.minimum(invn.sum(axis=0), 7)


def main(argv=None):
    import numpy as np
    import torch

    from metta_tpu_torch.ops import smoke_sim as s3
    from metta_tpu_torch.scripts.common import add_device_flags, device_of

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=256)
    add_device_flags(ap, seed=0)
    args = ap.parse_args(argv)
    device = device_of(args)

    rng = np.random.default_rng(args.seed)
    rn = rng.integers(0, 5, (s3.A, args.num_envs), dtype=np.int32)
    invn = rng.integers(0, 3, (s3.R, s3.A, args.num_envs), dtype=np.int32)
    out1, out2 = s3.smoke_sim(torch.from_numpy(rn).to(device), torch.from_numpy(invn).to(device))
    ref1, ref2 = reference(rn, invn)
    if not np.array_equal(out1.cpu().numpy(), ref1):
        raise AssertionError("out1 mismatch")
    if not np.array_equal(out2.cpu().numpy(), ref2):
        raise AssertionError("out2 mismatch")
    print("smoke OK", device.type)
    return out1, out2


if __name__ == "__main__":
    main()
