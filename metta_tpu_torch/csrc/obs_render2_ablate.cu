// The first design of the token-observation render v2 (K4), for Hopper
// (sm_90a), plain C interface for ctypes: the subject of K4's section
// ablation. The production render is csrc/obs_render2.cu, a persistent
// kernel with a warp per agent; this design is kept unchanged so that the
// ablation's numbers stay comparable from one design to the next.
//
// It computes the function of metta_tpu/ops/obs_render2.py:_obs2_kernel (the
// Pallas TPU kernel behind render_obs_pallas2): for every agent of every env,
// global tokens first, then the tokens of the window cells in center-out
// order, each (loc=(row<<4)|col, feat, val), truncated at T tokens; the
// remaining slots are 255. Its plain torch version is
// metta_tpu_torch/ops/obs_render2.py:render_obs2_plain.
//
// Design, in the TPU kernel's own formulation: the window is a flat,
// row-major set of (agent, cell) pairs, and the center-out emission order
// lives in a rank table (rank[s] = position of row-major cell s in the
// center-out walk), where the TPU kernel baked it into a rank matrix.
// One thread block per env, its threads striding over the A*S pairs:
//   1. each pair reads its cell's block id from `sb` (outside the map:
//      block 0, no tokens) and the block's token count, and stores the count
//      at its agent's rank slot in shared memory;
//   2. one warp per agent turns its S counts into exclusive prefix sums over
//      rank order (__shfl_up_sync, 32 cells at a time with a carry), offset
//      by the agent's global-token count: each cell's first output slot;
//   3. each pair scatters its cell's tokens to their slots, truncated at T,
//      into the env's [A, T, 3] tile in shared memory, prefilled with 255,
//      and the global tokens go to the first slots;
//   4. the tile leaves in coalesced 16-byte stores.
//
// Ablation: the kernel is a template on a mask of its sections (the k*
// constants below). obs_render2_ablate_launch runs a mask with some sections
// replaced by stubs, the counterpart of the TPU kernel's variants in
// scripts/ablate_obs.py:36 make_kernel (run by
// metta_tpu_torch/scripts/ablate_obs.py; the plain version of every mask is
// metta_tpu_torch/ops/ablate_obs.py:render_obs2_ablated_plain); mask 0 is
// the render itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

// Sections of the kernel, as bits of the ablation mask kSkip. A set bit
// replaces the section by a stub that reads no device memory but the [S]
// rank table; kSkip = 0 is the render itself.
constexpr int kRead = 1;      // block id and count of every (agent, cell) into rank slots
constexpr int kFill = 2;      // the 255 prefill of the tile
constexpr int kPrefix = 4;    // exclusive prefix sums in rank order
constexpr int kGlobals = 8;   // global tokens to the first slots
constexpr int kScatter = 16;  // every cell's tokens to its slots
constexpr int kStore = 32;    // the tile out in 16-byte stores
constexpr int kAll = 63;

template <int kSkip>
__global__ void __launch_bounds__(kThreads) obs_render2_kernel(
    const int32_t* __restrict__ sb,      // [E, H, W] combined block grid
    const uint8_t* __restrict__ tok,     // [E, NB, K, 2] (feat, val) per block
    const int32_t* __restrict__ counts,  // [E, NB] tokens per block
    const int32_t* __restrict__ rc,      // [E, A, 2] agent (row, col)
    const int32_t* __restrict__ gcnt,    // [E, A] global token count
    const uint8_t* __restrict__ gtok,    // [E, A, G, 3] global tokens
    const int32_t* __restrict__ rank,    // [S] center-out rank of row-major cell s
    uint8_t* __restrict__ out,           // [E, A, T, 3]
    int H, int W, int A, int NB, int K, int WH, int WW, int G, int T) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int S = WH * WW;
  const int P = A * S;                                  // (agent, cell) pairs
  int32_t* slot = reinterpret_cast<int32_t*>(smem);    // [A, S] by rank: count, then start
  int32_t* blk = slot + P;                              // [A, S] row-major: block id
  uint8_t* tile = smem + ((size_t)8 * P + 15) / 16 * 16;  // [A, T, 3], 16-byte aligned
  const size_t row = (size_t)T * 3;
  const size_t nbytes = (size_t)A * row;
  const int e = blockIdx.x;
  const int32_t* sb_e = sb + (size_t)e * H * W;
  const uint8_t* tok_e = tok + (size_t)e * NB * K * 2;
  const int32_t* cnt_e = counts + (size_t)e * NB;
  const int32_t* rc_e = rc + (size_t)e * A * 2;
  const int32_t* g_e = gcnt + (size_t)e * A;
  const int ohr = WH / 2, owr = WW / 2;

  // 1. block id and token count of every (agent, cell); tile prefill
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int a = p / S, s = p - a * S;
    int b = 0, n = 0;
    if constexpr ((kSkip & kRead) != 0) {
      // about one cell in twelve holds a block of 1-3 tokens
      const int h = e + a + s;
      b = (h % 12 == 0 && NB > 1) ? 1 + h % (NB - 1) : 0;
      n = b ? min(K, 1 + (b + s) % 3) : 0;
    } else {
      const int r = __ldg(rc_e + 2 * a) + s / WW - ohr;
      const int c = __ldg(rc_e + 2 * a + 1) + s % WW - owr;
      if (r >= 0 && r < H && c >= 0 && c < W) {
        b = __ldg(sb_e + r * W + c);
        n = __ldg(cnt_e + b);
      }
    }
    blk[p] = b;
    slot[a * S + __ldg(rank + s)] = n;
  }
  if constexpr ((kSkip & kFill) != 0) {
    // each agent's last slot only
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      uint8_t* last = tile + a * row + (size_t)(T - 1) * 3;
      last[0] = last[1] = last[2] = (uint8_t)a;
    }
  } else {
    uint32_t* tile32 = reinterpret_cast<uint32_t*>(tile);
    for (size_t i = threadIdx.x; i < (nbytes + 3) / 4; i += blockDim.x) tile32[i] = 0xffffffffu;
  }
  __syncthreads();

  // 2. exclusive prefix sum of each agent's counts in rank order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int a = warp; a < A; a += blockDim.x >> 5) {
    int32_t* sa = slot + a * S;
    if constexpr ((kSkip & kPrefix) != 0) {
      // a quarter slot a cell after the global tokens
      const int g0 = min(G, T);
      for (int q = lane; q < S; q += 32) sa[q] = g0 + (q >> 2);
    } else {
      int carry = __ldg(g_e + a);
      for (int base = 0; base < S; base += 32) {
        const int q = base + lane;
        const int n = q < S ? sa[q] : 0;
        int incl = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += v;
        }
        if (q < S) sa[q] = carry + incl - n;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
  }
  // global tokens to the first slots (disjoint from the cells' slots)
  for (int q = threadIdx.x; q < A * G; q += blockDim.x) {
    const int a = q / G, gi = q - a * G;
    if constexpr ((kSkip & kGlobals) != 0) {
      if (gi < T) {
        uint8_t* dst = tile + a * row + (size_t)gi * 3;
        dst[0] = (uint8_t)(3 * gi + a);
        dst[1] = (uint8_t)(3 * gi + 1 + a);
        dst[2] = (uint8_t)(3 * gi + 2 + a);
      }
    } else {
      if (gi < __ldg(g_e + a) && gi < T) {
        const uint8_t* src = gtok + (((size_t)e * A + a) * G + gi) * 3;
        uint8_t* dst = tile + a * row + (size_t)gi * 3;
        dst[0] = __ldg(src);
        dst[1] = __ldg(src + 1);
        dst[2] = __ldg(src + 2);
      }
    }
  }
  __syncthreads();

  // 3. scatter every cell's tokens to its slots
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int a = p / S, s = p - a * S;
    const int b = blk[p];
    const int start = slot[a * S + __ldg(rank + s)];
    if constexpr ((kSkip & kScatter) != 0) {
      // the cell's first slot only, from what shared memory holds
      if (b != 0 && start < T) {
        uint8_t* dst = tile + a * row + (size_t)start * 3;
        dst[0] = (uint8_t)((((s / WW) << 4) | (s % WW)) & 255);
        dst[1] = (uint8_t)b;
        dst[2] = (uint8_t)s;
      }
    } else {
      const int stop = min(__ldg(cnt_e + b), T - start);
      if (stop > 0) {
        const uint8_t loc = (uint8_t)((((s / WW) << 4) | (s % WW)) & 255);
        const uint8_t* bt = tok_e + (size_t)b * K * 2;
        uint8_t* dst = tile + a * row + (size_t)start * 3;
        for (int k = 0; k < stop; ++k) {
          dst[3 * k] = loc;
          dst[3 * k + 1] = __ldg(bt + 2 * k);
          dst[3 * k + 2] = __ldg(bt + 2 * k + 1);
        }
      }
    }
  }
  __syncthreads();

  // 4. the env's tile to global memory
  uint8_t* out_e = out + (size_t)e * nbytes;
  if ((nbytes & 15) == 0 && (reinterpret_cast<uintptr_t>(out_e) & 15) == 0) {
    uint4* dst = reinterpret_cast<uint4*>(out_e);
    if constexpr ((kSkip & kStore) != 0) {
      // every output word, from one byte of the tile
      const uint32_t x = tile[0];
      for (size_t i = threadIdx.x; i < nbytes / 16; i += blockDim.x) {
        const uint32_t v = ((uint32_t)i + (uint32_t)e) ^ x;
        dst[i] = make_uint4(v, v, v, v);
      }
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(tile);
      for (size_t i = threadIdx.x; i < nbytes / 16; i += blockDim.x) dst[i] = src[i];
    }
  } else {
    if constexpr ((kSkip & kStore) != 0) {
      const uint8_t x = tile[0];
      for (size_t i = threadIdx.x; i < nbytes; i += blockDim.x)
        out_e[i] = (uint8_t)((uint8_t)(i + e) ^ x);
    } else {
      for (size_t i = threadIdx.x; i < nbytes; i += blockDim.x) out_e[i] = tile[i];
    }
  }
}

template <int kSkip>
int launch(const void* sb, const void* tok, const void* counts, const void* rc,
           const void* gcnt, const void* gtok, const void* rank, void* out,
           int E, int H, int W, int A, int NB, int K, int WH, int WW, int G, int T,
           void* stream) {
  const size_t pairs = (size_t)A * WH * WW;
  const size_t smem = (8 * pairs + 15) / 16 * 16 + ((size_t)A * T * 3 + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        obs_render2_kernel<kSkip>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  obs_render2_kernel<kSkip><<<E, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sb, (const uint8_t*)tok, (const int32_t*)counts,
      (const int32_t*)rc, (const int32_t*)gcnt, (const uint8_t*)gtok,
      (const int32_t*)rank, (uint8_t*)out, H, W, A, NB, K, WH, WW, G, T);
  return (int)cudaGetLastError();
}

}  // namespace

// The render with the sections of `skip` stubbed (ablation; the mask's bits
// are the k* constants above): none, one section, or all of them. Returns
// cudaErrorInvalidValue for any other mask.
extern "C" int obs_render2_ablate_launch(
    const void* sb, const void* tok, const void* counts, const void* rc,
    const void* gcnt, const void* gtok, const void* rank, void* out,
    int E, int H, int W, int A, int NB, int K, int WH, int WW, int G, int T, int skip,
    void* stream) {
#define OBS2_CASE(m)                                                                  \
  case m:                                                                             \
    return launch<m>(sb, tok, counts, rc, gcnt, gtok, rank, out, E, H, W, A, NB, K, WH, \
                     WW, G, T, stream);
  switch (skip) {
    OBS2_CASE(0)
    OBS2_CASE(kRead)
    OBS2_CASE(kFill)
    OBS2_CASE(kPrefix)
    OBS2_CASE(kGlobals)
    OBS2_CASE(kScatter)
    OBS2_CASE(kStore)
    OBS2_CASE(kAll)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OBS2_CASE
}
