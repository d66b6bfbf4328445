// Sim-kernel smoke check for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces scripts/smoke_sim_kernel.py:31 kernel (pallas_call :65), the TPU
// check that Mosaic accepts the fused sim kernel's layout primitives. Same
// function, in the JAX layout: r [A, E] and inv [R, A, E] int32 in,
//   out1[a, e] = #{t : r[t, e] == r[a, e]} + #{a' : r[a', e] == r[a, e]}
//   out2[a, e] = min(sum over k of inv[k, a, e], 7)
// both [A, E] int32, for any A <= 32, E and R (the sums wrap, as torch's
// int32 sums do). Its plain torch version is
// metta_tpu_torch/ops/smoke_sim.py:smoke_sim_plain.
//
// On Hopper the check is of K2's warp primitives (csrc/sim_fused.cu): one
// warp per env, lane = agent; the pair count by __shfl_sync over the env's
// lanes; the per-target count by shared-memory atomicAdd; a __ballot_sync
// mask of the lanes that hold an agent. Every primitive runs on all 32
// lanes, lanes >= A too, and no shuffle sits behind a short-circuit && (K2
// once diverged so).
//
// Bound: bytes, 4 (2 + R) A E, 0.29 MB at E=256, which the card moves in
// about 0.09 us; the work is a launch, a memory round trip and A steps of
// the warp's loop. So the kernel keeps to one round trip and a short loop:
// - A block takes kEnvs envs, a warp each. Thread t loads the element
//   (agent t / kEnvs, env t % kEnvs) of r and its R inventory rows, every
//   load issued before any compute: each row of the block's envs is
//   kEnvs consecutive words, half a 32-byte sector at 4.
// - out2 is lane-local: the loading thread sums its R rows and stores.
// - r goes through a shared tile [32][kEnvs + 1] (the pad puts a warp's
//   agents of one env on distinct banks) to the warp of its env, and out1
//   comes back through the same tile to the loading threads' stores.
// - In step k of A, lane a compares with lane t = (a + k) mod A, taking x_t
//   by a shuffle from that lane, and adds the hit (0 or 1) to back[t], a
//   dead lane to its own word: in each step the 32 lanes add to 32
//   distinct words, so no shared atomic waits on another, and no branch
//   guards the atomic (each step of a branch around it had to reconverge).
// - kEnvs = 4 gives 64 blocks of 128 threads at E=256, on 64 SMs, a warp
//   for each of an SM's four schedulers: the loop's steps, not the loads,
//   are what a block waits on after its round trip, and on the card 8, 16
//   and 32 envs a block, whose loads are whole sectors and lines, were
//   slower, as were 1 and 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEnvs = 4;                  // envs a block, a warp each
constexpr int kMaxAgents = 32;            // a warp's lanes
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kEnvs) smoke_sim_kernel(
    const int32_t* __restrict__ r, const int32_t* __restrict__ inv,
    int32_t* __restrict__ out1, int32_t* __restrict__ out2, int E, int A, int R) {
  __shared__ int tile[kMaxAgents][kEnvs + 1];
  __shared__ int back[kEnvs][32];
  const int t = threadIdx.x, e0 = blockIdx.x * kEnvs;
  const int row = t / kEnvs, col = t % kEnvs;      // the element thread t loads and stores
  const bool staged = row < A && e0 + col < E;
  const size_t at = (size_t)row * E + e0 + col, plane = (size_t)A * E;
  int x = 0;
  unsigned tot = 0;
  if (staged) {
    x = __ldg(r + at);
#pragma unroll 10
    for (int k = 0; k < R; ++k) tot += (unsigned)__ldg(inv + k * plane + at);
  }
  const int lane = t & 31, w = t >> 5;
  back[w][lane] = 0;
  if (staged) tile[row][col] = x;
  __syncthreads();
  if (staged) out2[at] = min((int)tot, 7);

  const bool live = e0 + w < E && lane < A;
  const int xa = live ? tile[lane][w] : 0;
  const unsigned agents = __ballot_sync(kFull, live);
  int acc = 0;
#pragma unroll 4
  for (int k = 0; k < A; ++k) {
    int src = lane + k;                            // < 32 on every lane
    if (src >= A) src -= A;
    const int v = __shfl_sync(kFull, xa, src);
    const bool hit = live && ((agents >> src) & 1u) != 0 && v == xa;
    acc += hit ? 1 : 0;
    atomicAdd(&back[w][live ? src : lane], hit ? 1 : 0);
  }
  __syncwarp();
  if (live) tile[lane][w] = acc + back[w][lane];   // this thread's own word of the tile
  __syncthreads();
  if (staged) out1[at] = tile[row][col];
}

}  // namespace

// Launches the check on `stream` (1 <= A <= 32, E >= 1, R >= 0); returns
// cudaGetLastError() (0 = launched).
extern "C" int smoke_sim_launch(const void* r, const void* inv, void* out1, void* out2, int E,
                                int A, int R, void* stream) {
  smoke_sim_kernel<<<(E + kEnvs - 1) / kEnvs, 32 * kEnvs, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (const int32_t*)inv, (int32_t*)out1, (int32_t*)out2, E, A, R);
  return (int)cudaGetLastError();
}
