// Token-observation render v1 (kernel K5) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces metta_tpu/ops/obs_render.py:_obs_kernel (the Pallas TPU kernel
// behind render_obs_pallas, which the JAX package's sequential step and
// reset run when tables.obs_renderer == "pl"). For every agent of every env:
// global tokens first, then the tokens of the window cells in center-out
// order, each (loc=(row<<4)|col, feat, val), the cell's first slot being the
// exclusive prefix sum of the counts of the cells before it; truncated at T
// tokens, 255 after. A cell's block id comes from two planes, merged here as
// in the TPU kernel: the agent plane (agent id + 1) where an agent stands,
// else the static plane; outside the map, block 0 (no tokens). Its plain
// torch version is metta_tpu_torch/ops/obs_render.py:render_obs1_plain.
//
// What bounds it: bytes. Each agent reads its window's cells from both
// planes, their blocks' counts and tokens, and writes T*3 bytes; a few adds
// per cell and a select per slot are far below the card's integer rate.
// The output dominates (59 MB at combat's E=4096, 24 agents, T=200).
//
// Design: the sequential path runs from one env (play, eval) to thousands,
// so the work is spread over (env, agent) pairs, not envs: one block of 128
// threads per pair, so that even E=1 fills 24 blocks and E=4096 98,304.
//   1. the threads stride over the S window cells (any S whose 8 bytes a
//      cell fit in shared memory), read the two planes and the block's count;
//   2. a block-wide exclusive scan of the counts in scan order (warp
//      shuffles, then the four warp totals), 128 cells at a time with a
//      carry that starts at the agent's global-token count;
//   3. each cell scatters its tokens into the agent's [T, 3] tile in shared
//      memory, prefilled with 255; the global tokens go to the first slots;
//   4. the tile leaves in 16-byte stores where T*3 and the address allow,
//      else 4-byte or single-byte ones.
// The TPU kernel's one-hot GEMMs, its triangular cumsum GEMM and its lane
// rolls are how the MXU gathers, sums and scatters; none of them is needed
// here. Integer math only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) obs_render_kernel(
    const int32_t* __restrict__ agent_grid,  // [E, H, W] agent id + 1, 0 none
    const int32_t* __restrict__ sblock,      // [E, H, W] static block id, 0 none
    const uint8_t* __restrict__ tok,         // [E, NB, K, 2] (feat, val) per block
    const int32_t* __restrict__ counts,      // [E, NB] tokens per block
    const int32_t* __restrict__ rc,          // [E, A, 2] agent (row, col)
    const int32_t* __restrict__ gcnt,        // [E, A] global token count
    const uint8_t* __restrict__ gtok,        // [E, A, G, 3] global tokens
    const int32_t* __restrict__ scan,        // [S, 2] center-out (dr, dc)
    uint8_t* __restrict__ out,               // [E, A, T, 3]
    int A, int H, int W, int NB, int K, int S, int G, int T, int ohr, int owr) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t warp_total[kWarps];
  int32_t* blk = reinterpret_cast<int32_t*>(smem);       // [S] block id of each cell
  int32_t* slot = blk + S;                                // [S] count, then first slot
  uint8_t* tile = smem + ((size_t)8 * S + 15) / 16 * 16;  // [T, 3], 16-byte aligned
  const size_t ea = blockIdx.x;                           // env * A + agent
  const int e = (int)(ea / A);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = T * 3;
  const int ar = __ldg(rc + 2 * ea), ac = __ldg(rc + 2 * ea + 1);
  const int32_t* grid_e = agent_grid + (size_t)e * H * W;
  const int32_t* sb_e = sblock + (size_t)e * H * W;
  const int32_t* cnt_e = counts + (size_t)e * NB;

  // 1. block id and token count of every window cell; tile prefill
  for (int s = tid; s < S; s += kThreads) {
    const int r = ar + __ldg(scan + 2 * s), c = ac + __ldg(scan + 2 * s + 1);
    int b = 0;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      const int a1 = __ldg(grid_e + r * W + c);
      b = a1 > 0 ? a1 : __ldg(sb_e + r * W + c);
    }
    blk[s] = b;
    slot[s] = __ldg(cnt_e + b);
  }
  uint32_t* tile32 = reinterpret_cast<uint32_t*>(tile);
  for (int i = tid; i < (row + 3) / 4; i += kThreads) tile32[i] = 0xffffffffu;
  __syncthreads();

  // 2. exclusive prefix sum of the counts in scan order, after the globals
  int carry = __ldg(gcnt + ea);
  for (int base = 0; base < S; base += kThreads) {
    const int s = base + tid;
    const int n = s < S ? slot[s] : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int before = carry, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_total[w];
      before += w < warp ? t : 0;
      chunk += t;
    }
    if (s < S) slot[s] = before + incl - n;
    carry += chunk;
    __syncthreads();                                      // warp_total is reused
  }

  // global tokens to the first slots (disjoint from the cells' slots)
  const int ng = min(__ldg(gcnt + ea), T);
  for (int gi = tid; gi < min(ng, G); gi += kThreads) {
    const uint8_t* src = gtok + (ea * G + gi) * 3;
    uint8_t* dst = tile + gi * 3;
    dst[0] = __ldg(src);
    dst[1] = __ldg(src + 1);
    dst[2] = __ldg(src + 2);
  }

  // 3. every cell's tokens to its slots, cut at T
  for (int s = tid; s < S; s += kThreads) {
    const int b = blk[s];
    const int start = slot[s];
    const int stop = min(min(__ldg(cnt_e + b), K), T - start);
    if (stop > 0) {
      const uint8_t loc = (uint8_t)((((__ldg(scan + 2 * s) + ohr) << 4) |
                                     (__ldg(scan + 2 * s + 1) + owr)) & 255);
      const uint8_t* bt = tok + ((size_t)e * NB + b) * K * 2;
      uint8_t* dst = tile + start * 3;
      for (int k = 0; k < stop; ++k) {
        dst[3 * k] = loc;
        dst[3 * k + 1] = __ldg(bt + 2 * k);
        dst[3 * k + 2] = __ldg(bt + 2 * k + 1);
      }
    }
  }
  __syncthreads();

  // 4. the agent's tile to global memory
  uint8_t* dst = out + ea * row;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dst);
  if ((row & 15) == 0 && (addr & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(tile);
    for (int i = tid; i < row / 16; i += kThreads) reinterpret_cast<uint4*>(dst)[i] = src[i];
  } else if ((row & 3) == 0 && (addr & 3) == 0) {
    for (int i = tid; i < row / 4; i += kThreads)
      reinterpret_cast<uint32_t*>(dst)[i] = tile32[i];
  } else {
    for (int i = tid; i < row; i += kThreads) dst[i] = tile[i];
  }
}

}  // namespace

// Launches the render on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int obs_render_launch(
    const void* agent_grid, const void* sblock, const void* tok, const void* counts,
    const void* rc, const void* gcnt, const void* gtok, const void* scan, void* out,
    int E, int A, int H, int W, int NB, int K, int S, int G, int T, int ohr, int owr,
    void* stream) {
  const size_t smem = ((size_t)8 * S + 15) / 16 * 16 + ((size_t)T * 3 + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        obs_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((size_t)E * A);
  obs_render_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)agent_grid, (const int32_t*)sblock, (const uint8_t*)tok,
      (const int32_t*)counts, (const int32_t*)rc, (const int32_t*)gcnt, (const uint8_t*)gtok,
      (const int32_t*)scan, (uint8_t*)out, A, H, W, NB, K, S, G, T, ohr, owr);
  return (int)cudaGetLastError();
}
