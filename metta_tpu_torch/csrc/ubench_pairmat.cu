// Pair-mat micro-benchmarks for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of scripts/ubench_pairmat.py (the nine
// cases :29-:117, pallas_call :156): each repeats one layout primitive of
// the fused sim kernel (K2) REP times over x [A=24, E] int32 and writes
// [24, E] int32. Their plain torch versions are
// metta_tpu_torch/ops/ubench_pairmat.py:plain.
//
// On the TPU the primitives are relayouts of an [A, A*EL] pair matrix (env
// in lanes, EL=128 envs a block). On Hopper that matrix is not a layout: it
// is K2's formulation (csrc/sim_fused.cu), one warp per env, lane = agent,
// and "the other agent's value" is a __shfl_sync over the env's lanes:
//
//   elemwise   acc += (x > i), i < 768                 lane-local compare
//   flat, bA   acc += x + i                            lane-local (the relayout is free)
//   bT         acc += x[agent 0] + i                   one shuffle from lane 0
//   pair_full  acc += #{t : x[t] == x[a]}              24 shuffles and compares
//   red_a      acc += sum over agents of (x + i)       butterfly of 5 shuffles
//   repeat_na  acc += 88 * (x + i), REP / 8 times      88 lane-local adds
//   iota_div   acc += (x + i == iota / EL)             the env's lane index, divided
//   tdiv       acc += trunc((x + i) / n), i < 256      the f32 route with its correction
//
// Every repeat loop carries its sum through `opaque` (an empty asm the
// compiler cannot see through), so that no loop folds into a closed form
// (elemwise into a clamp, repeat_na into a multiply); chip_smoke.py counts
// the loops' instructions in the SASS. Every shuffle runs on all 32 lanes.
//
// What bounds them: the int32 operations (33.5 T/s); their 0.8 MB of bytes
// at E=4096 take 0.2 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kA = 24, kEL = 128, kNA = 88, kRep = 32;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Case { kElemwise, kFlat, kBT, kBA, kPairFull, kRedA, kRepeatNA, kIotaDiv, kTdiv };

__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

template <int kCase>
__global__ void __launch_bounds__(32 * kWarps) pairmat_kernel(
    const int32_t* __restrict__ x_in, int32_t* __restrict__ out, int E) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = e < E && lane < kA;
  const int x = live ? __ldg(x_in + (size_t)lane * E + e) : 0;
  int acc = 0;
  if constexpr (kCase == kElemwise) {
#pragma unroll 4
    for (int i = 0; i < kRep * 24; ++i) acc = opaque(acc + (x > i ? 1 : 0));
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
    for (int i = 0; i < kRep; ++i) {
      const int xi = opaque(x + i);
      int s = 0;
#pragma unroll
      for (int t = 0; t < kA; ++t) s += __shfl_sync(kFull, xi, t) == xi ? 1 : 0;
      acc = opaque(acc + s);
    }
  } else if constexpr (kCase == kRedA) {
#pragma unroll 4
    for (int i = 0; i < kRep; ++i) {
      int v = opaque(live ? x + i : 0);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      acc = opaque(acc + v);
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
    const int n = (x & 7) + 1;
    const float nf = __int2float_rn(n);
#pragma unroll 4
    for (int i = 0; i < kRep * 8; ++i) {
      const int a = opaque(x + i);
      const int aa = a < 0 ? -a : a;
      const int q0 = (int)(__int2float_rn(aa) / nf);
      const int r0 = aa - q0 * n;
      const int q = q0 + (r0 >= n ? 1 : 0) - (r0 < 0 ? 1 : 0);
      acc = opaque(acc + (a >= 0 ? q : -q));
    }
  }
  if (live) out[(size_t)lane * E + e] = acc;
}

template <int kCase>
int launch(const void* x, void* out, int E, void* stream) {
  pairmat_kernel<kCase><<<(E + kWarps - 1) / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, E);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches case `which` (the order of the Case enum, that of
// ops/ubench_pairmat.py:CASES) on `stream`; returns cudaGetLastError()
// (0 = launched), cudaErrorInvalidValue for an unknown case.
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
    default: return (int)cudaErrorInvalidValue;
  }
}
