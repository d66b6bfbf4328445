"""Micro-benchmarks of the primitives a redesigned render would be built from
(``csrc/ubench_mosaic.cu``).

Counterpart of ``scripts/ubench_mosaic.py``: ten cases (M5, M1, M1b, M2, M3,
M4, M6a-c, M7) at grid ``--grid``, ``--reps`` repeats and ``--eps`` envs a
step, inputs from ``--seed``. On the card each case is held to its plain
version (float32 repeats within rtol 1e-6, taken in the same order; int32
checksums exactly; the bf16 GEMMs within 1e-3 of the largest magnitude, the
accumulation order differing) and timed; prints ms in total and ns per op
(per grid step and rep; per env GEMM for M6), the bound and the plain
version's time.

Usage: python -m metta_tpu_torch.scripts.ubench_mosaic [--grid 1024] [--reps 16]
    [--eps 4] [--only M1,M6a] [--device cuda|cpu] [--seed 0]
"""

from __future__ import annotations

import argparse


def check(case, got, want):
    """Max abs error of (slots, checksum) against the plain version's; raises
    past the case's tolerance."""
    import torch

    from metta_tpu_torch.ops.ubench_mosaic import GEMMS

    err = 0.0
    for part, g, w in (("slots", got[0], want[0]), ("checksum", got[1], want[1])):
        if w is None:
            continue
        diff = (g.double() - w.double()).abs()
        err = max(err, float(diff.max()))
        if case in GEMMS:
            ok = float(diff.max()) <= 1e-3 * float(w.double().abs().max())
        elif w.dtype == torch.int32:
            ok = torch.equal(g, w)
        else:
            ok = torch.allclose(g, w, rtol=1e-6, atol=0.0)
        if not ok:
            raise AssertionError(f"{case} {part}: max abs error {float(diff.max())} past the "
                                 f"tolerance")
    return err


TIMED_LAUNCHES = 10                 # a case's launches between the CUDA events


def main(argv=None):
    import torch

    from metta_tpu_torch.ops import ubench_mosaic as s1
    from metta_tpu_torch.ops.timing import bound_of
    from metta_tpu_torch.scripts.common import add_device_flags, device_of, time_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--eps", type=int, default=4)
    ap.add_argument("--only", type=str, default=None, help="comma-separated cases")
    add_device_flags(ap, seed=0)
    args = ap.parse_args(argv)
    device = device_of(args)
    G, R, EPS = args.grid, args.reps, args.eps
    if G % EPS:
        raise ValueError(f"--grid {G} must be a multiple of --eps {EPS}")
    torch.backends.cuda.matmul.allow_tf32 = False          # the plain GEMMs in full float32

    rows = []
    for case in (args.only.split(",") if args.only else s1.CASES):
        inputs = s1.make_inputs(case, G, EPS, args.seed, device)
        want = s1.plain(case, inputs, R)
        row = dict(case=case)
        if device.type == "cuda":
            before = s1.launches, s1.launches_gemm
            got = s1.run(case, inputs, R)
            torch.cuda.synchronize()
            s1.launches, s1.launches_gemm = before    # checking launches do not count
            row["max_abs_err"] = check(case, got, want)
            row["ms"] = time_ms(lambda: s1.run(case, inputs, R), TIMED_LAUNCHES, device)
        row["plain_ms"] = time_ms(lambda: s1.plain(case, inputs, R), 1, device)
        nbytes, ops, kind = s1.work(case, G, EPS, R)
        row["bound_ms"], row["bound_by"], _ = bound_of(nbytes, ops, kind)
        per = G if case in s1.GEMMS else G * R        # env GEMMs, or grid steps x reps
        if "ms" in row:
            print(f"{case:4s} {row['ms']:9.4f} ms total {1e6 * row['ms'] / per:9.2f} ns/"
                  f"{'env-gemm' if case in s1.GEMMS else 'op'}  bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}, {kind}, {100 * row['bound_ms'] / row['ms']:5.1f}%)  "
                  f"plain {row['plain_ms']:.3f} ms")
        else:
            print(f"{case:4s} plain {row['plain_ms']:.3f} ms on the host (cpu)")
        rows.append(row)
        del inputs, want
    return rows


if __name__ == "__main__":
    main()
