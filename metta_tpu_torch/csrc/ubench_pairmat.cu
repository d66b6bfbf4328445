// Pair-mat micro-benchmarks for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of scripts/ubench_pairmat.py (the nine
// cases :29-:117, pallas_call :156): each repeats one layout primitive of
// the fused sim kernel (K2) REP times over x [A=24, E] int32 and writes
// [24, E] int32. Their plain torch versions are
// metta_tpu_torch/ops/ubench_pairmat.py:plain.
//
// On the TPU the primitives are relayouts of an [A, A*EL] pair matrix (env
// in lanes, EL=128 envs a block). On Hopper that matrix is not a layout.
// Six cases use only their own agent's value, and take a thread per element:
// a 2-D grid of one agent row (blockIdx.y) by 256 consecutive envs, so every
// lane is live and a warp's load and store are one 128-byte line. The three
// that need the env's other agents keep K2's formulation, a warp per env,
// lane = agent (lanes 24-31 dead), and reach the other agents through warp
// primitives. Their block stages x[:, 32 envs] in shared memory (rows padded
// to 33 words, so a warp's 24 agents of one env hit 24 banks), so that their
// global loads and stores are whole 128-byte rows too:
//
//   elemwise   acc += (x > i), i < 768                 thread per element
//   flat, bA   acc += x + i                            thread per element (the relayout is free)
//   bT         acc += x[agent 0] + i                   warp per env: one shuffle from lane 0
//   pair_full  acc += #{t : x[t] == x[a]}              warp per env: 24 shuffles and compares
//   red_a      acc += sum over agents of (x + i)       warp per env: __reduce_add_sync
//   repeat_na  acc += 88 * (x + i), REP / 8 times      thread per element: 88 adds
//   iota_div   acc += (x + i == iota / EL)             thread per element: its env index, divided
//   tdiv       acc += trunc((x + i) / n), i < 256      thread per element: the f32 route, by
//                                                      n's reciprocal where that is exact
//
// Two launches that are not TPU cases sit beside them, for phase 13 of
// chip_smoke.py to time in turns with the cases: pair_full_match, pair_full
// by K2's warp match (__popc(__match_any_sync(all, xi) & live), live the
// lanes 0-23), and load_store, the thread-per-element grid whose body only
// loads x and stores it (the floor a one-round launch of this size cannot
// beat). On an H100 the match form took 1.29x the 24 shuffles' time at
// E=4096 (about 38 clocks of an SM for each warp's MATCH over 24 mostly
// distinct keys), so pair_full keeps the shuffles. red_a's dead lanes add 0
// to the reduce.
//
// elemwise's compare and add are one asm statement, a compare and a
// predicated add: the compiler's own select took two more instructions a
// rep. Being volatile asm on acc, it also keeps each rep's add, as `opaque`
// does. pair_full's compare and count and tdiv's correction and sign take
// the same form (each faster on the card than the compiler's own selects),
// tdiv with -n hoisted so that r0 is one multiply-add.
//
// tdiv takes the TPU body's f32 route (q0 = trunc(float(|a|) / n), then
// r0 = |a| - q0 n corrects q0 by one either way), but with n's reciprocal
// computed once before the loop: q0 = trunc(float(|a|) * rn(1 / n)), one
// FMUL a rep where an IEEE divide is a reciprocal, Newton steps and a
// slow-path branch. Exactness: the correction maps any q0 within 1 of
// Q = trunc(|a| / n) to Q (r0 = R + n, R or R - n for q0 = Q - 1, Q, Q + 1,
// with R in [0, n)). For |a| < 2^23, float(|a|) is exact and rn(1 / n) and
// the product each err by at most half an ulp, so q0 is within 1 of Q; the
// IEEE route's q0 is too, so both give Q bit for bit. The route is exact
// for |x + i| < 2^23 at every rep, so each element tests once, before its
// loop, that -2^23 < x and x + 255 < 2^23 (the scripts' x lie in [0, 24)):
// if so it runs the reciprocal loop, else a second loop with the IEEE
// divide (tdiv_ieee), each loop whole in its own branch, so the fast loop
// keeps its own opcodes and no divide (chip_smoke.py checks both loops in
// the SASS). tdiv thus equals the plain version on the card for every
// int32 x. A refusal in the wrapper would need a host read of max |x|
// before every launch. The CPU tests hold a numpy mirror of both routes and
// the choice to the plain version across int32; the card tests sweep x
// across int32 against the plain version.
//
// Every repeat loop carries its sum through `opaque` (an empty asm the
// compiler cannot see through), so that no loop folds into a closed form
// (elemwise into a clamp, repeat_na into a multiply, pair_full into one
// count); chip_smoke.py counts the loops' instructions in the SASS. Every
// warp primitive runs on all 32 lanes.
//
// What bounds them: the int32 operations (33.5 T/s); their 0.8 MB of bytes
// at E=4096 take 0.2 us. Below that stays each loop's issue rate: its
// instructions a rep at the lanes a clock an SM of their pipes
// (chip_smoke.py:s2_issue_floors).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kA = 24, kEL = 128, kNA = 88, kRep = 32;
constexpr int kTdivReps = kRep * 8, kTdivLimit = 1 << 23;  // tdiv's reps; its domain's edge
constexpr int kThreads = 256;              // thread per element: 256 envs of one agent row
constexpr int kEnvs = 32;                  // warp per env: 32 envs a block, a warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kLive = (1u << kA) - 1;  // the lanes of an env's agents

enum Case {
  kElemwise, kFlat, kBT, kBA, kPairFull, kRedA, kRepeatNA, kIotaDiv, kTdiv,
  kPairFullMatch, kLoadStore
};

__host__ __device__ constexpr bool warp_per_env(int c) {
  return c == kBT || c == kPairFull || c == kRedA || c == kPairFullMatch;
}

__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// tdiv where some rep leaves the reciprocal route's domain: the TPU body's
// arithmetic as the plain version runs it on the card, the IEEE divide and
// int32 ops that wrap (x + i past INT_MAX, |INT_MIN|, -q, the sums), here in
// unsigned arithmetic reinterpreted, which wraps with no signed overflow.
// The quotient's conversion saturates, as torch's float -> int32 does on the
// card (x86 gives INT_MIN): the two differ only for n = 1 and |a| >= 2^31 -
// 64, where float(|a|) rounds to 2^31.
__device__ __forceinline__ int tdiv_ieee(int x, int n) {
  const float fn = __int2float_rn(n);
  unsigned acc = 0;
#pragma unroll 4
  for (int i = 0; i < kTdivReps; ++i) {
    const unsigned ua = (unsigned)x + (unsigned)i;
    const unsigned aa = (int)ua < 0 ? 0u - ua : ua;                 // |a|, INT_MIN to itself
    const int q0 = __float2int_rz(__fdiv_rn(__int2float_rn((int)aa), fn));
    const int r0 = (int)(aa - (unsigned)q0 * (unsigned)n);
    const unsigned q = (unsigned)q0 + (r0 >= n ? 1u : 0u) - (r0 < 0 ? 1u : 0u);
    acc += (int)ua < 0 ? 0u - q : q;
  }
  return (int)acc;
}

// Case kCase's repeats on this thread's x (0 on a dead lane) in env e.
template <int kCase>
__device__ __forceinline__ int repeat(int x, int e, bool live) {
  int acc = 0;
  if constexpr (kCase == kElemwise) {
#pragma unroll 4
    for (int i = 0; i < kRep * 24; ++i)
      asm volatile("{ .reg .pred p; setp.gt.s32 p, %1, %2; @p add.s32 %0, %0, 1; }"
                   : "+r"(acc) : "r"(x), "r"(i));
  } else if constexpr (kCase == kFlat || kCase == kBA) {
#pragma unroll 4
    for (int i = 0; i < kRep; ++i) acc = opaque(acc + x + i);
  } else if constexpr (kCase == kBT) {
#pragma unroll 4
    for (int i = 0; i < kRep; ++i) {
      const int xi = opaque(x + i);
      acc = opaque(acc + __shfl_sync(kFull, xi, 0));
    }
  } else if constexpr (kCase == kPairFull) {
#pragma unroll 2
    for (int i = 0; i < kRep; ++i) {
      const int xi = opaque(x + i);
      int s = 0;
#pragma unroll
      for (int t = 0; t < kA; ++t)
        asm("{ .reg .pred p; setp.eq.s32 p, %1, %2; @p add.s32 %0, %0, 1; }"
            : "+r"(s) : "r"(__shfl_sync(kFull, xi, t)), "r"(xi));
      acc = opaque(acc + s);
    }
  } else if constexpr (kCase == kPairFullMatch) {
#pragma unroll 4
    for (int i = 0; i < kRep; ++i) {
      const int xi = opaque(x + i);
      acc = opaque(acc + __popc(__match_any_sync(kFull, xi) & kLive));
    }
  } else if constexpr (kCase == kRedA) {
#pragma unroll 4
    for (int i = 0; i < kRep; ++i) {
      const int v = opaque(live ? x + i : 0);
      acc = opaque(acc + __reduce_add_sync(kFull, v));
    }
  } else if constexpr (kCase == kRepeatNA) {
    for (int i = 0; i < kRep / 8; ++i) {
      const int xi = opaque(x + i);
      int s = 0;
#pragma unroll 8
      for (int t = 0; t < kNA; ++t) s = opaque(s + xi);
      acc = opaque(acc + s);
    }
  } else if constexpr (kCase == kIotaDiv) {
#pragma unroll 4
    for (int i = 0; i < kRep; ++i) {
      const int blk = opaque(e & (kEL - 1)) / kEL;     // the first lane block: 0
      acc = opaque(acc + (x + i == blk ? 1 : 0));
    }
  } else if constexpr (kCase == kTdiv) {
    const int n = (x & 7) + 1, minus_n = -n;
    if (x > -kTdivLimit && x < kTdivLimit - (kTdivReps - 1)) {  // every rep in the domain
      const float rcp = 1.0f / __int2float_rn(n);     // IEEE, once: rn(1 / n)
#pragma unroll 4
      for (int i = 0; i < kTdivReps; ++i) {
        const int a = opaque(x + i);
        const int aa = a < 0 ? -a : a;
        const int q0 = __float2int_rz(__fmul_rn(__int2float_rn(aa), rcp));
        const int r0 = aa + q0 * minus_n;
        int q = q0 + (r0 >> 31);                        // q0 - (r0 < 0)
        asm("{ .reg .pred p; setp.ge.s32 p, %1, %2; @p add.s32 %0, %0, 1; }"
            : "+r"(q) : "r"(r0), "r"(n));               // + (r0 >= n)
        asm volatile("{ .reg .pred p; setp.lt.s32 p, %1, 0; @p sub.s32 %0, %0, %2; "
                     "@!p add.s32 %0, %0, %2; }" : "+r"(acc) : "r"(a), "r"(q));  // acc += sign(a) q
      }
    } else {
      acc = tdiv_ieee(x, n);
    }
  } else if constexpr (kCase == kLoadStore) {
    acc = x;
  }
  return acc;
}

template <int kCase>
__global__ void __launch_bounds__(warp_per_env(kCase) ? 32 * kEnvs : kThreads) pairmat_kernel(
    const int32_t* __restrict__ x_in, int32_t* __restrict__ out, int E) {
  if constexpr (warp_per_env(kCase)) {
    __shared__ int tile[kA][kEnvs + 1];
    const int t = threadIdx.x, e0 = blockIdx.x * kEnvs;
    const int row = t / kEnvs, col = t % kEnvs;      // the element thread t stages
    const bool staged = t < kA * kEnvs && e0 + col < E;
    if (staged) tile[row][col] = __ldg(x_in + (size_t)row * E + e0 + col);
    __syncthreads();
    const int lane = t & 31, w = t >> 5;
    const bool live = e0 + w < E && lane < kA;
    const int acc = repeat<kCase>(live ? tile[lane][w] : 0, e0 + w, live);
    __syncthreads();
    if (live) tile[lane][w] = acc;
    __syncthreads();
    if (staged) out[(size_t)row * E + e0 + col] = tile[row][col];
  } else {
    const int e = blockIdx.x * kThreads + threadIdx.x;
    if (e >= E) return;
    const size_t at = (size_t)blockIdx.y * E + e;
    out[at] = repeat<kCase>(__ldg(x_in + at), e, true);
  }
}

template <int kCase>
int launch(const void* x, void* out, int E, void* stream) {
  if constexpr (warp_per_env(kCase)) {
    pairmat_kernel<kCase><<<(E + kEnvs - 1) / kEnvs, 32 * kEnvs, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)out, E);
  } else {
    pairmat_kernel<kCase><<<dim3((E + kThreads - 1) / kThreads, kA), kThreads, 0,
                            (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)out, E);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches case `which` (the order of the Case enum: ops/ubench_pairmat.py's
// CASES, then its EXTRAS) over x [24, E] on `stream`; returns
// cudaGetLastError() (0 = launched), cudaErrorInvalidValue for an unknown case.
extern "C" int pairmat_launch(const void* x, void* out, int E, int which, void* stream) {
  switch (which) {
    case kElemwise: return launch<kElemwise>(x, out, E, stream);
    case kFlat: return launch<kFlat>(x, out, E, stream);
    case kBT: return launch<kBT>(x, out, E, stream);
    case kBA: return launch<kBA>(x, out, E, stream);
    case kPairFull: return launch<kPairFull>(x, out, E, stream);
    case kRedA: return launch<kRedA>(x, out, E, stream);
    case kRepeatNA: return launch<kRepeatNA>(x, out, E, stream);
    case kIotaDiv: return launch<kIotaDiv>(x, out, E, stream);
    case kTdiv: return launch<kTdiv>(x, out, E, stream);
    case kPairFullMatch: return launch<kPairFullMatch>(x, out, E, stream);
    case kLoadStore: return launch<kLoadStore>(x, out, E, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
