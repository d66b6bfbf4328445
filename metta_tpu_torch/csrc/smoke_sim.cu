// Sim-kernel smoke check for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces scripts/smoke_sim_kernel.py:31 kernel (pallas_call :65), the TPU
// check that Mosaic accepts the fused sim kernel's layout primitives. Same
// function, in the JAX layout: r [A, E] and inv [R, A, E] int32 in,
//   out1[a, e] = #{t : r[t, e] == r[a, e]} + #{a' : r[a', e] == r[a, e]}
//   out2[a, e] = min(sum over r of inv[r, a, e], 7)
// both [A, E] int32, for any E. Its plain torch version is
// metta_tpu_torch/ops/smoke_sim.py:smoke_sim_plain.
//
// On Hopper the check is of K2's warp primitives (csrc/sim_fused.cu): one
// warp per env, lane = agent; the pair count by a loop of __shfl_sync over
// the env's lanes; the per-target count by shared-memory atomicAdd; a
// __ballot_sync mask of the lanes that hold an agent. Every primitive runs
// on all 32 lanes, lanes >= A too, and no shuffle sits behind a
// short-circuit && (K2 once diverged so). Bound: bytes, about 4 (2 + R) A E.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps) smoke_sim_kernel(
    const int32_t* __restrict__ r, const int32_t* __restrict__ inv,
    int32_t* __restrict__ out1, int32_t* __restrict__ out2, int E, int A, int R) {
  __shared__ int back[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * kWarps + w;
  const bool live = e < E && lane < A;
  const int x = live ? __ldg(r + (size_t)lane * E + e) : 0;
  const unsigned agents = __ballot_sync(kFull, live);
  back[w][lane] = 0;
  __syncwarp();
  int acc = 0;
  for (int t = 0; t < 32; ++t) {
    const int v = __shfl_sync(kFull, x, t);
    const bool hit = live && ((agents >> t) & 1u) != 0 && v == x;
    acc += hit ? 1 : 0;
    if (hit) atomicAdd(&back[w][t], 1);
  }
  __syncwarp();
  int tot = 0;
  for (int k = 0; k < R; ++k) tot += live ? __ldg(inv + ((size_t)k * A + lane) * E + e) : 0;
  if (live) {
    const size_t o = (size_t)lane * E + e;
    out1[o] = acc + back[w][lane];
    out2[o] = min(tot, 7);
  }
}

}  // namespace

// Launches the check on `stream` (A <= 32); returns cudaGetLastError()
// (0 = launched).
extern "C" int smoke_sim_launch(const void* r, const void* inv, void* out1, void* out2, int E,
                                int A, int R, void* stream) {
  smoke_sim_kernel<<<(E + kWarps - 1) / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (const int32_t*)inv, (int32_t*)out1, (int32_t*)out2, E, A, R);
  return (int)cudaGetLastError();
}
