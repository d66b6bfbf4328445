"""The port's micro-benchmark plain versions against the JAX scripts' kernels.

Each plain version must equal the JAX script's own Pallas kernel in
interpret mode on the same inputs from a numpy seed: the sim-kernel smoke
check (``scripts/smoke_sim_kernel.py:kernel``) at E=256, all nine pair-mat
cases (``scripts/ubench_pairmat.py:KERNELS``) at E=128, byte for byte, and
all ten primitive cases of ``scripts/ubench_mosaic.py`` at G=2, eps 1, two
reps (M3 also at 30, past the wrap of its 24 shifts), the last block
compared: float32 repeats within rtol 1e-6 (the sum taken in the same
order), the bf16 GEMMs within 1e-3 of the largest magnitude (the
accumulation order differs). S2's tdiv: the TPU body's correction turns any
quotient estimate within 1 into the truncated quotient, and a float32
mirror of the kernel's reciprocal route is within 1 across its stated
domain (every |a| < 2^16 and a seeded sample up to 2^23), the argument that
lets the kernel skip the IEEE divide there; a numpy mirror of the kernel's
two routes and its choice between them equals the plain version across
int32 (the n = 1 band where the card's and x86's float -> int32
conversions differ left out). S3's wrapper on CPU tensors equals the
script's numpy reference on adversarial inputs and refuses more than 32
agents by name. The scripts are loaded by file
path; ``ubench_mosaic.py`` defines its kernels inside ``main``, so their
bodies and ``pallas_call`` wiring are copied here. The fold's chunk
schedule (``ops/ubench_mosaic.py:fold_schedule``) must cover every element
once, no chunk crossing a g; M5, M4 (each of its 11 copies) and M2 on CPU
tensors must be one float32 chain of adds an element, in rep order, and M3
one chain of rolled adds. Every
CLI runs once with ``--device cpu``.
The CUDA kernels themselves are held to these plain versions on a GPU by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools
import importlib.util
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from metta_tpu_torch.ops import smoke_sim as s3
from metta_tpu_torch.ops import ubench_mosaic as s1
from metta_tpu_torch.ops import ubench_pairmat as s2
from metta_tpu_torch.scripts import smoke_sim_kernel
from test_torch_cuda import SMOKE_SIM_PATTERNS, smoke_sim_inputs, tdiv_edges
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
VMEM = pltpu.VMEM


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_sim_matches_jax_script_kernel():
    """S3 at E=256 (two 128-env grid steps of the TPU kernel)."""
    mod = _script("smoke_sim_kernel")
    E = 256
    rng = np.random.default_rng(0)
    r = rng.integers(0, 5, (s3.A, E), dtype=np.int32)
    inv = rng.integers(0, 3, (s3.R, s3.A, E), dtype=np.int32)
    out1, out2 = pl.pallas_call(
        mod.kernel,
        out_shape=(jax.ShapeDtypeStruct((s3.A, E), jnp.int32),) * 2,
        grid=(E // mod.EL,),
        in_specs=[pl.BlockSpec((s3.A, mod.EL), lambda i: (0, i), memory_space=VMEM),
                  pl.BlockSpec((s3.R, s3.A, mod.EL), lambda i: (0, 0, i), memory_space=VMEM)],
        out_specs=(pl.BlockSpec((s3.A, mod.EL), lambda i: (0, i), memory_space=VMEM),) * 2,
        interpret=True,
    )(jnp.asarray(r), jnp.asarray(inv))
    got1, got2 = s3.smoke_sim(torch.from_numpy(r), torch.from_numpy(inv))
    np.testing.assert_array_equal(np.asarray(out1), got1.numpy())
    np.testing.assert_array_equal(np.asarray(out2), got2.numpy())
    ref1, ref2 = smoke_sim_kernel.reference(r, inv)
    np.testing.assert_array_equal(ref1, got1.numpy())
    np.testing.assert_array_equal(ref2, got2.numpy())


@pytest.mark.parametrize("agents", [1, 24, 32])
def test_smoke_sim_plain_matches_script_reference(agents):
    """S3's wrapper on CPU tensors (its plain version) equals the script's
    numpy reference on the script's inputs and adversarial ones (every agent
    equal, every agent distinct, the int32 extremes and negatives; inventory
    sums above 7 and below 0), with 0 and 10 inventory rows, at E=1 and 257."""
    for pattern in SMOKE_SIM_PATTERNS:
        for rows in (0, 10):
            for n_envs in (1, 257):
                r, inv = smoke_sim_inputs(pattern, agents, rows, n_envs, seed=agents)
                got1, got2 = s3.smoke_sim(torch.from_numpy(r), torch.from_numpy(inv))
                ref1, ref2 = smoke_sim_kernel.reference(r, inv)
                case = (pattern, rows, n_envs)
                np.testing.assert_array_equal(got1.numpy(), ref1, err_msg=str(case))
                np.testing.assert_array_equal(got2.numpy(), ref2, err_msg=str(case))
                if pattern != "script" and rows and n_envs > 1:
                    sums = inv.sum(0)
                    assert (sums > 7).any() and (sums < 0).any(), case


def test_smoke_sim_refuses_more_agents_than_a_warp():
    """S3's wrapper refuses, by name, more agents than the kernel's one warp
    per env has lanes, on either device; it takes any number of inventory
    rows (nothing in the kernel is sized by them), and its constants are the
    kernel's."""
    src = (REPO / "metta_tpu_torch" / "csrc" / "smoke_sim.cu").read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kEnvs"], const["kMaxAgents"]) == (s3.ENVS, s3.MAX_AGENTS)
    a = s3.MAX_AGENTS + 1
    with pytest.raises(ValueError, match="at most 32 agents, got 33 agents"):
        s3.smoke_sim(torch.zeros((a, 4), dtype=torch.int32),
                     torch.zeros((10, a, 4), dtype=torch.int32))
    r, inv = smoke_sim_inputs("script", s3.MAX_AGENTS, 37, 5)
    got = s3.smoke_sim(torch.from_numpy(r), torch.from_numpy(inv))
    np.testing.assert_array_equal(got[1].numpy(), smoke_sim_kernel.reference(r, inv)[1])


@pytest.fixture(scope="module")
def pairmat():
    return _script("ubench_pairmat")


@pytest.mark.parametrize("case", s2.CASES)
def test_pairmat_case_matches_jax_script_kernel(pairmat, case):
    """S2 at E=128 (one grid step), byte for byte."""
    E = 128
    x = np.random.default_rng(0).integers(0, 24, (s2.A, E), dtype=np.int32)
    want = pl.pallas_call(
        pairmat.KERNELS[case],
        out_shape=jax.ShapeDtypeStruct((s2.A, E), jnp.int32),
        grid=(E // s2.EL,),
        in_specs=[pl.BlockSpec((s2.A, s2.EL), lambda i: (0, i), memory_space=VMEM)],
        out_specs=pl.BlockSpec((s2.A, s2.EL), lambda i: (0, i), memory_space=VMEM),
        interpret=True,
    )(jnp.asarray(x))
    got = s2.run(case, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_pairmat_extras_are_cases():
    """The two launches beside the cases: pair_full_match computes pair_full,
    load_store copies x; an unknown name is refused."""
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 24, (s2.A, 40), dtype=np.int32))
    assert torch.equal(s2.run("pair_full_match", x), s2.run("pair_full", x))
    assert torch.equal(s2.run("load_store", x), x)
    with pytest.raises(ValueError, match="unknown case"):
        s2.run("pair", x)


def test_pairmat_cases_are_the_kernels_enum():
    """The wrapper's case order (CASES, then EXTRAS) is the kernel's Case
    enum, whose index the wrapper passes, WARP_PER_ENV names the cases the
    kernel launches a warp per env, and THREADS and ENVS are its blocks'
    envs (the kernel cannot run here to catch a drift)."""
    src = (REPO / "metta_tpu_torch" / "csrc" / "ubench_pairmat.cu").read_text()
    enum = re.search(r"enum Case \{([^}]*)\}", src).group(1)
    names = [n.strip()[1:].lower() for n in enum.split(",")]
    assert names == [c.replace("_", "").lower() for c in s2.CASES + s2.EXTRAS]
    body = re.search(r"bool warp_per_env\(int c\) \{([^}]*)\}", src).group(1)
    warp = [n[1:].lower() for n in re.findall(r"c == (k\w+)", body)]
    assert warp == [c.replace("_", "").lower() for c in s2.WARP_PER_ENV]
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kThreads"], const["kEnvs"]) == (s2.THREADS, s2.ENVS)


def _tdiv_values(seed):
    """Every a with |a| < 2^16, and a seeded sample of |a| up to the edge of
    the domain where the kernel's reciprocal route is exact."""
    a = np.arange(-2 ** 16 + 1, 2 ** 16, dtype=np.int64)
    rng = np.random.default_rng(seed)
    edge = s2.TDIV_LIMIT - 1
    sample = rng.integers(-edge, edge + 1, 200_000)
    return np.concatenate([a, sample, [edge, -edge, edge - 1, -(edge - 1)]])


@pytest.mark.parametrize("n", range(1, 9))
def test_tdiv_correction_gives_the_truncated_quotient(n):
    """The TPU body's correction (``corrected_quotient``, the arithmetic of
    the kernel's loop) maps q0 = trunc(|a| / n) + d, d in {-1, 0, 1}, to
    trunc(|a| / n) exactly: any quotient estimate within 1 stands."""
    aa = np.abs(_tdiv_values(n))
    want = aa // n
    for d in (-1, 0, 1):
        got = s2.corrected_quotient(torch.from_numpy(aa.astype(np.int32)),
                                    torch.from_numpy((want + d).astype(np.int32)), n)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", range(1, 9))
def test_tdiv_reciprocal_route_is_within_one(n):
    """A float32 mirror of the kernel's route: q0 = trunc(float(|a|) *
    rn(1 / n)) (each step rounded to nearest in float32, as FMUL and the
    IEEE reciprocal round) is within 1 of trunc(|a| / n) across the domain,
    as the TPU body's IEEE quotient is, so after the correction both give
    the truncated quotient, bit for bit."""
    aa = np.abs(_tdiv_values(100 + n))
    want = aa // n
    rcp = np.float32(1.0) / np.float32(n)
    for q0 in ((aa.astype(np.float32) * rcp).astype(np.int64),
               (aa.astype(np.float32) / np.float32(n)).astype(np.int64)):
        assert np.abs(q0 - want).max() <= 1
        got = s2.corrected_quotient(torch.from_numpy(aa.astype(np.int32)),
                                    torch.from_numpy(q0.astype(np.int32)), n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_tdiv_plain_is_the_sum_of_truncated_quotients():
    """tdiv's plain version over x drawn across the domain (|x + i| <
    TDIV_LIMIT at every rep): each element the sum over its reps of
    trunc((x + i) / n), n = (x & 7) + 1, in exact integers."""
    rng = np.random.default_rng(9)
    x = rng.integers(-s2.TDIV_LIMIT + 1, s2.TDIV_LIMIT - s2.TDIV_REPS, (s2.A, 16))
    x[0, :4] = [-s2.TDIV_LIMIT + 1, s2.TDIV_LIMIT - s2.TDIV_REPS, -s2.TDIV_REPS // 2, 0]
    got = s2.plain("tdiv", torch.from_numpy(x.astype(np.int32)))
    a = x[..., None] + np.arange(s2.TDIV_REPS)
    n = (x[..., None] & 7) + 1
    want = (np.sign(a) * (np.abs(a) // n)).sum(-1)
    np.testing.assert_array_equal(got.numpy(), want)


def _wrap32(v):
    """int64 values wrapped to int32's range, as int32 ops wrap."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _tdiv_mirror(x, routes="kernel"):
    """A numpy mirror of the kernel's tdiv on x (int32 values) -> [..] int64.
    Each element's route by the kernel's rule (``routes="kernel"``: the
    reciprocal route where -2^23 < x and x + 255 < 2^23, else the IEEE
    divide), or the reciprocal route everywhere (``"reciprocal"``); float32
    steps rounded to nearest, as FMUL, the IEEE divide and the conversions
    round; the quotient's conversion to int32 saturating, as on the card; the
    int32 ops (x + i, |a|, the correction, -q, the sum) wrapping."""
    x = x.astype(np.int64)[..., None]
    a = _wrap32(x + np.arange(s2.TDIV_REPS))
    n = (x & 7) + 1
    aa = _wrap32(np.abs(a))
    fa, fn = aa.astype(np.float32), n.astype(np.float32)
    fast = (x > -s2.TDIV_LIMIT) & (x < s2.TDIV_LIMIT - (s2.TDIV_REPS - 1))
    if routes == "reciprocal":
        fast = np.ones_like(fast)
    q0 = np.trunc(np.where(fast, fa * (np.float32(1) / fn), fa / fn).astype(np.float64))
    q0 = np.clip(q0, -2 ** 31, 2 ** 31 - 1).astype(np.int64)
    r0 = _wrap32(aa - q0 * n)
    q = _wrap32(q0 + (r0 >= n).astype(np.int64) - (r0 < 0).astype(np.int64))
    return _wrap32(np.where(a >= 0, q, -q).sum(-1))


def test_tdiv_routes_match_plain_across_int32():
    """The kernel's two tdiv routes and its choice between them, mirrored in
    numpy, equal the plain version on the CPU for x seeded across all of
    int32, both edges of the reciprocal route's domain and x whose reps wrap
    past INT_MAX, each with every n. The mirror's constants are the
    kernel's. Left out: elements with n = 1 whose reps reach |a| >= 2^31 -
    64, where float(|a|) rounds to 2^31 and the quotient converts to INT_MAX
    on the card (the kernel's and the plain version's) and INT_MIN on x86
    (INT_MIN and INT_MAX - 255 themselves are such). Outside the domain the
    reciprocal route alone differs from the plain version, so the choice is
    what keeps the kernel exact."""
    src = (REPO / "metta_tpu_torch" / "csrc" / "ubench_pairmat.cu").read_text()
    m = re.search(r"constexpr int kTdivReps = kRep \* (\d+), kTdivLimit = 1 << (\d+);", src)
    assert (s2.REP * int(m.group(1)), 2 ** int(m.group(2))) == (s2.TDIV_REPS, s2.TDIV_LIMIT)
    edges = tdiv_edges()
    x = np.random.default_rng(16).integers(-2 ** 31, 2 ** 31, (s2.A, 64))
    x.reshape(-1)[:len(edges)] = edges
    x = x.astype(np.int32)
    got = s2.plain("tdiv", torch.from_numpy(x)).numpy()
    mirror = _tdiv_mirror(x)
    a = _wrap32(x.astype(np.int64)[..., None] + np.arange(s2.TDIV_REPS))
    band = ((x[..., None] & 7) == 0) & (np.abs(a) >= 2 ** 31 - 64)
    band = band.any(-1)
    assert band.sum() < 40 and band[x == -2 ** 31].all()
    np.testing.assert_array_equal(mirror[~band], got[~band])
    wrapped = np.isin(x, edges[-16:]) & ~band                  # INT_MIN + k, INT_MAX - 255 + k
    assert wrapped.sum() == 14
    fast = (x > -s2.TDIV_LIMIT) & (x < s2.TDIV_LIMIT - (s2.TDIV_REPS - 1))
    assert 17 <= fast.sum() and (~fast & ~band).sum() > 1000
    assert (_tdiv_mirror(x, routes="reciprocal") != got)[~band & ~fast].any()


# ---- S1: the kernel bodies of scripts/ubench_mosaic.py:main, copied ----
G, EPS, REPS = 2, 1, 2
EA = EPS * 24
F, HP, WP, FR = s1.F, s1.HP, s1.WP, s1.FR


def k_tiny(x_ref, o_ref, *, inner):
    acc = x_ref[0]
    for _ in range(inner):
        acc = acc + 1.0
    o_ref[...] = acc


def k_fold(x_ref, o_ref, *, inner):
    acc = jnp.zeros((264, 2048), jnp.float32)
    for _ in range(inner):
        v = x_ref[0]
        acc = acc + jnp.reshape(v, (264, 2048))
    o_ref[...] = acc[:, :128]


def k_fold2(x_ref, o_ref, *, inner):
    acc = jnp.zeros((EA, 128 * 11), jnp.float32)
    for _ in range(inner):
        v = x_ref[0]
        acc = acc + jnp.reshape(v, (EA, 11 * 128))
    o_ref[...] = acc[:, :128]


def k_tr(x_ref, o_ref, *, inner):
    acc = jnp.zeros((128, EA), jnp.float32)
    for _ in range(inner):
        acc = acc + x_ref[0].T
    o_ref[...] = acc


def k_droll(x_ref, s_ref, o_ref, *, inner):
    acc = jnp.zeros((16, 128), jnp.float32)
    for i in range(inner):
        acc = acc + pltpu.roll(x_ref[0], s_ref[0, i % 24], 1)
    o_ref[...] = acc


def k_rep(x_ref, o_ref, *, inner):
    acc = jnp.zeros((264 * 11, 128), jnp.float32)
    for _ in range(inner):
        acc = acc + pltpu.repeat(x_ref[0], 11, 0)
    o_ref[...] = acc[:264]


def k_loop_gemm(a_ref, b_ref, o_ref, *, inner):
    acc = jnp.zeros((128, WP), jnp.float32)
    for _ in range(inner):
        for e in range(EPS):
            r = jax.lax.dot_general(a_ref[0, e], b_ref[0, e], (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.float32)
            acc = acc + r[:128]
    o_ref[...] = acc


def k_bd_gemm(a_ref, b_ref, o_ref, *, inner):
    r = jax.lax.dot_general(a_ref[0], b_ref[0], (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    o_ref[...] = r[:128]


def k_compact(x_ref, o_ref, *, inner):
    v = x_ref[0]
    d = x_ref[0] * 0.5
    for _ in range(inner):
        for b in range(10):
            sv = pltpu.roll(v, -(1 << b) % 640, 1)
            sd = pltpu.roll(d, -(1 << b) % 640, 1)
            m = sd > 0.5
            v = jnp.where(m, sv, v)
            d = jnp.where(m, sd - float(1 << b), d)
    o_ref[...] = v[:, :128]


def _gemm_call(a, b, loop):
    if loop:
        in_specs = [pl.BlockSpec((1, EPS, F, HP), lambda i: (i, 0, 0, 0), memory_space=VMEM),
                    pl.BlockSpec((1, EPS, HP, WP), lambda i: (i, 0, 0, 0), memory_space=VMEM)]
    else:
        in_specs = [pl.BlockSpec((1,) + a.shape[1:], lambda i: (i, 0, 0), memory_space=VMEM),
                    pl.BlockSpec((1,) + b.shape[1:], lambda i: (i, 0, 0), memory_space=VMEM)]
    return pl.pallas_call(
        functools.partial(k_loop_gemm if loop else k_bd_gemm, inner=1),
        out_shape=jax.ShapeDtypeStruct((128, WP), jnp.float32),
        grid=(G // EPS,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((128, WP), lambda i: (0, 0), memory_space=VMEM),
        interpret=True,
    )(a, b)


def _jax_case(case, inputs, reps=REPS):
    """The TPU case's output (the last grid step's block), in interpret mode."""
    mod = _script("ubench_mosaic")
    arr = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
           else jnp.asarray(t.numpy()) for t in inputs]
    if case in ("M6a", "M6b", "M6c"):
        return _gemm_call(*arr, loop=case == "M6a")
    if case == "M3":
        return pl.pallas_call(
            functools.partial(k_droll, inner=reps),
            out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
            grid=(G,),
            in_specs=[pl.BlockSpec((1, 16, 128), lambda i: (i, 0, 0), memory_space=VMEM),
                      pl.BlockSpec((1, 24), lambda i: (0, 0), memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec((16, 128), lambda i: (0, 0), memory_space=VMEM),
            interpret=True,
        )(*arr)
    kern, out = {
        "M5": (k_tiny, None),
        "M1": (k_fold, (264, 128)),
        "M1b": (k_fold2, (EA, 128)),
        "M2": (k_tr, (128, EA)),
        "M4": (k_rep, (264, 128)),
        "M7": (k_compact, (EA, 128)),
    }[case]
    out_shape = None if out is None else jax.ShapeDtypeStruct(out, jnp.float32)
    return mod.run_kernel(kern, arr[0], G, REPS, out_shape=out_shape, interpret=True)(arr[0])


@pytest.mark.parametrize("case", s1.CASES)
def test_mosaic_case_matches_jax_script_kernel(case):
    """S1 at G=2, eps 1, two reps: the plain version's last slot against the
    TPU case's output; the checksum covers what that output drops."""
    inputs = s1.make_inputs(case, G, EPS, seed=0, device="cpu")
    slots, cks = s1.run(case, inputs, REPS)
    want = np.asarray(_jax_case(case, inputs))
    got = slots[-1].numpy()
    assert got.shape == want.shape
    if case in s1.GEMMS:
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
        r = torch.matmul(inputs[0].double(), inputs[1].double())
        r = r.sum(1) if case == "M6a" else r
        np.testing.assert_allclose(cks.double().numpy(), r.reshape(G // EPS, -1, 128 * WP)
                                   .sum(-1).numpy(), rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        if cks is not None:
            assert cks.shape == (G,) and cks.dtype == torch.int32


def test_m3_matches_jax_script_kernel_past_the_shift_wrap():
    """M3 at G=2 with 30 reps: the shift index wraps past its 24 shifts
    (``i % 24``), and the plain version's last slot still equals the TPU
    case's output."""
    inputs = s1.make_inputs("M3", G, EPS, seed=2, device="cpu")
    slots, cks = s1.run("M3", inputs, 30)
    want = np.asarray(_jax_case("M3", inputs, reps=30))
    assert cks is None and slots.shape == (G, 16, 128)
    np.testing.assert_allclose(slots[-1].numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("reps", [1, 16, 30])
def test_m3_on_cpu_is_one_chain_of_rolled_adds(reps):
    """M3 on CPU tensors (the plain version, no launch): out[g, r, j] one
    float32 chain of ``reps`` adds of x[g, r, (j - s_i) % 128] in rep order,
    s_i the shift i % 24, so that the card's bit-equality checks hold the
    kernel's chains to that order (the values past 2^24, where it shows)."""
    G3 = 3
    x_np = _wide(np.random.default_rng(reps), (G3, 16, 128))
    shifts = np.random.default_rng(reps + 1).integers(-130, 260, (1, s1.NSHIFT), dtype=np.int32)
    before = s1.launches
    slots, cks = s1.run("M3", (torch.from_numpy(x_np.copy()), torch.from_numpy(shifts)), reps)
    assert s1.launches == before and cks is None
    chain = np.zeros_like(x_np)
    j = np.arange(128)
    for i in range(reps):
        chain = chain + x_np[..., (j - shifts[0, i % s1.NSHIFT]) % 128]
    np.testing.assert_array_equal(slots.view(torch.int32).numpy(), chain.view(np.int32))


def test_mosaic_checksum_covers_dropped_columns():
    """The int32 checksum is the wrapping sum of the bits of what the TPU
    output drops: changing a dropped element changes it."""
    inputs = s1.make_inputs("M1", G, EPS, seed=0, device="cpu")
    _, cks = s1.run("M1", inputs, REPS)
    x = inputs[0].clone()
    x[-1, 1, 72] += 1.0                     # flat 200: row 0, column 200 of the fold
    slots2, cks2 = s1.run("M1", (x,), REPS)
    assert torch.equal(slots2[-1], s1.run("M1", inputs, REPS)[0][-1])
    assert cks2[-1] != cks[-1] and cks2[0] == cks[0]


@pytest.mark.parametrize("n,G", [
    (264 * 16 * 128, 1024),          # M1 at phase 13's G: 132 whole chunks a g
    (24 * 4 * 11 * 128, 1024),       # M1b at eps 4: 33 whole chunks a g
    (12_345, 3),                     # an odd n: a short last chunk in every g
], ids=["M1", "M1b", "odd"])
def test_fold_schedule_covers_each_element_once(n, G):
    """The fold's chunks on the kernel's grid (min(chunks, 132 SMs x 2
    blocks)): every element of every g in exactly one chunk, each chunk
    inside one g and no longer than a stage, only a g's last chunk short,
    and each block's chunks consecutive in g-major order."""
    src = (REPO / "metta_tpu_torch" / "csrc" / "ubench_mosaic.cu").read_text()
    assert re.search(rf"constexpr int kFoldChunk = {s1.FOLD_CHUNK};", src)
    per_g = -(-n // s1.FOLD_CHUNK)
    blocks = min(G * per_g, 132 * 2)
    plan = s1.fold_schedule(G, n, blocks)
    assert len(plan) == blocks and all(plan)
    flat = [c for chunks in plan for c in chunks]
    assert flat == sorted(flat) and len(flat) == G * per_g
    cover = np.zeros((G, n), dtype=np.int32)
    for g, start, length in flat:
        assert 0 <= g < G and 0 < length <= s1.FOLD_CHUNK and start + length <= n
        assert length == s1.FOLD_CHUNK or start + length == n
        cover[g, start:start + length] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("G,n,reps,scale", [
    (64, 264 * 128, 16, 1.0),        # M5's rows at phase 13's reps
    (3, 12_345, 16, 1.0),            # G n % 4 = 3: the kernel's partial last vector
    (5, 1_003, 16, 2.0 ** 24),       # past 2^24, where x + 1 rounds: the order shows
    (2, 4 * 512 * 3, 1, 2.0 ** 24),  # one rep
], ids=["rows", "tail", "rounding", "one_rep"])
def test_m5_on_cpu_is_one_chain_of_adds(G, n, reps, scale):
    """M5 on CPU tensors (the wrapper's plain version, no launch): each
    element one float32 chain of ``reps`` adds of 1 in rep order, as the
    kernel takes it, so that the card's bit-equality checks hold the kernel
    to that order; where x + 1 rounds, a sum of reps taken at once would
    differ."""
    rng = np.random.default_rng(G * n + reps)
    want = (rng.integers(0, 256, (G, n)).astype(np.float32) + 0.5) / 128 * np.float32(scale)
    x = torch.from_numpy(want.copy())
    before = s1.launches
    got, cks = s1.run("M5", (x,), reps)
    assert s1.launches == before and cks is None
    for _ in range(reps):
        want = want + np.float32(1.0)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), want.view(np.int32))
    if scale > 1 and reps > 1:
        assert not np.array_equal(want, x.numpy() + np.float32(reps))


def _wide(rng, shape):
    """float32 in [2^24, 2^25) with all 23 mantissa bits drawn: a sum of such
    values rounds, so the order of the adds shows in the result."""
    m = rng.integers(0, 2 ** 23, size=shape, dtype=np.uint32)
    return (m | np.uint32(151 << 23)).view(np.float32)


@pytest.mark.parametrize("G,rows,reps", [
    (2, 264, 16),                    # M4's rows at phase 13's reps
    (3, 8, 16),                      # a smaller tile
    (2, 264, 1),                     # one rep
], ids=["rows", "small", "one_rep"])
def test_m4_on_cpu_is_eleven_chains_of_adds(G, rows, reps):
    """M4 on CPU tensors (the wrapper's plain version, no launch): every copy
    of the tile one float32 chain of ``reps`` adds of x in rep order, copy 0
    in the slots and the checksum the wrapping int32 sum of the bits of
    copies 1-10, so that the card's bit-equality checks hold the kernel's 11
    chains to that order; past 2^24 a sum taken at once would differ."""
    x_np = _wide(np.random.default_rng(G * rows + reps), (G, rows, 128))
    x = torch.from_numpy(x_np.copy())
    before = s1.launches
    slots, cks = s1.run("M4", (x,), reps)
    assert s1.launches == before
    chain = np.zeros_like(x_np)
    for _ in range(reps):
        chain = chain + x_np
    np.testing.assert_array_equal(slots.view(torch.int32).numpy(), chain.view(np.int32))
    others = np.tile(chain, (1, s1.COPIES - 1, 1))                   # copies 1-10
    bits = others.view(np.uint32).reshape(G, -1).astype(np.int64).sum(1)
    assert cks.dtype == torch.int32 and cks.shape == (G,)
    np.testing.assert_array_equal(cks.numpy(), (bits % 2 ** 32).astype(np.uint32)
                                  .view(np.int32))
    if reps > 1:
        assert not np.array_equal(chain, x_np * np.float32(reps))


@pytest.mark.parametrize("eps", [1, 2, 4])
def test_m2_on_cpu_is_the_transposed_chain(eps):
    """M2 on CPU tensors at rows 24, 48 and 96 (eps 1, 2, 4; the plain
    version, no launch): out[g, c, r] one float32 chain of 16 adds of
    x[g, r, c] in rep order."""
    G, rows, reps = 3, 24 * eps, 16
    x_np = _wide(np.random.default_rng(eps), (G, rows, 128))
    before = s1.launches
    slots, cks = s1.run("M2", (torch.from_numpy(x_np.copy()),), reps)
    assert s1.launches == before and cks is None
    chain = np.zeros((G, 128, rows), np.float32)
    for _ in range(reps):
        chain = chain + x_np.transpose(0, 2, 1)
    np.testing.assert_array_equal(slots.view(torch.int32).numpy(), chain.view(np.int32))
    assert not np.array_equal(chain, x_np.transpose(0, 2, 1) * np.float32(reps))


@pytest.mark.parametrize("argv", [
    ["smoke_sim_kernel"],
    ["ubench_pairmat", "--num-envs", "128", "--only", "flat,pair_full,tdiv"],
    ["ubench_mosaic", "--grid", "2", "--eps", "1", "--reps", "2", "--only", "M1,M3,M6c,M7"],
], ids=["smoke_sim_kernel", "ubench_pairmat", "ubench_mosaic"])
def test_cli_runs_on_cpu(argv):
    out = subprocess.run(
        [sys.executable, "-m", f"metta_tpu_torch.scripts.{argv[0]}", *argv[1:],
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    if argv[0] == "smoke_sim_kernel":
        assert out.stdout.strip().endswith("smoke OK cpu")
    else:
        assert len(out.stdout.strip().splitlines()) == len(argv[argv.index("--only") + 1]
                                                             .split(","))


def test_scripts_refuse_without_card():
    """Without ``--device cpu`` the scripts ask for the card and never fall
    back to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "metta_tpu_torch.scripts.smoke_sim_kernel"],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
