// Section ablation of the first design of K1, the token-observation render
// (sm_90a), plain C interface for ctypes.
//
// This is K1 as it was ported first (csrc/obs_render3.cu until the render
// was redesigned as a persistent, barrier-free kernel), kept unchanged as
// the subject of S5, the counterpart of the TPU kernel's variants in
// scripts/ablate_obs3.py:40 make_kernel (run by
// metta_tpu_torch/scripts/ablate_obs3.py; the plain version of every mask
// is metta_tpu_torch/ops/ablate_obs.py:render_obs3_ablated_plain). Mask 0
// computes the same function as the production render
// (metta_tpu_torch/ops/obs_render3.py:render_obs3_plain): for every agent of
// every env, global tokens first, then the tokens of the window cells in
// center-out order (the rows of `scan`), each (loc=(wr<<4)|wc, feat, val),
// truncated at T tokens; the remaining slots are 255.
//
// Design: one thread block per env, one warp per agent (agents beyond 32 are
// taken in turn). The warp walks the S window cells 32 at a time: each lane
// reads its cell's block id from `sb` (cells outside the map are block 0,
// which has no tokens), then the block's token count; a warp prefix sum
// (__shfl_up_sync) gives each cell its first output slot, carried from chunk
// to chunk, and the lane copies the cell's tokens there. The walk stops as
// soon as T slots are taken. The env's [A, T, 3] tile is assembled in shared
// memory and leaves in coalesced 16-byte stores after a block barrier.
//
// Ablation: the kernel is a template on a mask of its sections (the k*
// constants below); obs_render3_ablate_launch runs a mask with some sections
// replaced by stubs that read no device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Sections of the kernel, as bits of the ablation mask kSkip (see
// metta_tpu_torch/ops/ablate_obs.py). A set bit replaces the section by a
// stub that reads no device memory; kSkip = 0 is the render itself.
constexpr int kGlobals = 1;   // global tokens to the first slots
constexpr int kWinread = 2;   // window offsets from `scan`, block id from `sb`
constexpr int kCount = 4;     // the block's token count
constexpr int kScan = 8;      // warp prefix sum and carry
constexpr int kCopy = 16;     // tokens into the shared tile
constexpr int kFill = 32;     // 255 in the free slots
constexpr int kStore = 64;    // the tile out in 16-byte stores
constexpr int kAll = 127;

template <int kSkip>
__global__ void obs_render3_kernel(
    const int32_t* __restrict__ sb,      // [E, H, W] combined block grid
    const uint8_t* __restrict__ tok,     // [E, NB, K, 2] (feat, val) per block
    const int32_t* __restrict__ counts,  // [E, NB] tokens per block
    const int32_t* __restrict__ rc,      // [E, A, 2] agent (row, col)
    const int32_t* __restrict__ gcnt,    // [E, A] global token count
    const uint8_t* __restrict__ gtok,    // [E, A, G, 3] global tokens
    const int32_t* __restrict__ scan,    // [S, 2] window offsets (dr, dc)
    uint8_t* __restrict__ out,           // [E, A, T, 3]
    int H, int W, int A, int NB, int K, int S, int G, int T, int ohr, int owr) {
  extern __shared__ __align__(16) uint8_t tile[];  // [A, T, 3] of this env
  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int32_t* sb_e = sb + (size_t)e * H * W;
  const uint8_t* tok_e = tok + (size_t)e * NB * K * 2;
  const int32_t* cnt_e = counts + (size_t)e * NB;
  const size_t row = (size_t)T * 3;

  for (int a = warp; a < A; a += nwarps) {
    const size_t ea = (size_t)e * A + a;
    uint8_t* o = tile + (size_t)a * row;
    int ar = 0, ac = 0;
    if constexpr (!(kSkip & kWinread)) {
      ar = __ldg(rc + 2 * ea);
      ac = __ldg(rc + 2 * ea + 1);
    }
    int g;
    if constexpr ((kSkip & kGlobals) != 0) {
      g = min(G, T);
      for (int i = lane; i < 3 * g; i += 32) o[i] = (uint8_t)(i + a);
    } else {
      g = min(__ldg(gcnt + ea), T);
      const uint8_t* gt = gtok + ea * G * 3;
      for (int i = lane; i < 3 * g; i += 32) o[i] = __ldg(gt + i);
    }

    int carry = g;  // next free output slot (warp-uniform)
    for (int base = 0; base < S && carry < T; base += 32) {
      const int s = base + lane;
      int b = 0, n = 0, dr = 0, dc = 0;
      if (s < S) {
        if constexpr ((kSkip & kWinread) != 0) {
          // row-major window; about one cell in twelve holds a block
          dr = s / (2 * owr + 1) - ohr;
          dc = s % (2 * owr + 1) - owr;
          const int h = e + a + s;
          b = (h % 12 == 0 && NB > 1) ? 1 + h % (NB - 1) : 0;
          if constexpr (!(kSkip & kCount)) n = __ldg(cnt_e + b);
        } else {
          dr = __ldg(scan + 2 * s);
          dc = __ldg(scan + 2 * s + 1);
          const int r = ar + dr, c = ac + dc;
          if (r >= 0 && r < H && c >= 0 && c < W) {
            b = __ldg(sb_e + r * W + c);
            if constexpr (!(kSkip & kCount)) n = __ldg(cnt_e + b);
          }
        }
        if constexpr ((kSkip & kCount) != 0) n = b ? min(K, 1 + (b + s) % 3) : 0;
      }
      int incl, start;
      if constexpr ((kSkip & kScan) != 0) {
        // a quarter slot a cell (the render's mean is about 0.2 tokens a cell)
        incl = 8;
        start = carry + (lane >> 2);
      } else {
        incl = n;  // inclusive prefix sum of the counts over the warp
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += v;
        }
        start = carry + incl - n;
      }
      const int stop = min(n, T - start);
      if (stop > 0) {
        const uint8_t loc = (uint8_t)((((dr + ohr) << 4) | (dc + owr)) & 255);
        uint8_t* p = o + (size_t)start * 3;
        if constexpr ((kSkip & kCopy) != 0) {
          p[0] = loc;
          p[1] = (uint8_t)b;
          p[2] = (uint8_t)n;
        } else {
          const uint8_t* bt = tok_e + (size_t)b * K * 2;
          for (int k = 0; k < stop; ++k) {
            p[3 * k] = loc;
            p[3 * k + 1] = __ldg(bt + 2 * k);
            p[3 * k + 2] = __ldg(bt + 2 * k + 1);
          }
        }
      }
      if constexpr ((kSkip & kScan) != 0) {
        carry += incl;
      } else {
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    const int total = min(carry, T);
    if constexpr ((kSkip & kFill) != 0) {
      // the first free slot only
      if (lane < 3 && total < T) o[3 * total + lane] = (uint8_t)(total + lane);
    } else {
      for (int i = 3 * total + lane; i < 3 * T; i += 32) o[i] = 255;
    }
  }
  __syncthreads();

  uint8_t* out_e = out + (size_t)e * A * row;
  const size_t nbytes = (size_t)A * row;
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
           const void* gcnt, const void* gtok, const void* scan, void* out,
           int E, int H, int W, int A, int NB, int K, int S, int G, int T, int ohr,
           int owr, void* stream) {
  const int warps = A < 32 ? A : 32;
  const size_t smem = (((size_t)A * T * 3) + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        obs_render3_kernel<kSkip>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  obs_render3_kernel<kSkip><<<E, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sb, (const uint8_t*)tok, (const int32_t*)counts,
      (const int32_t*)rc, (const int32_t*)gcnt, (const uint8_t*)gtok,
      (const int32_t*)scan, (uint8_t*)out, H, W, A, NB, K, S, G, T, ohr, owr);
  return (int)cudaGetLastError();
}

}  // namespace

// The render with the sections of `skip` stubbed (ablation; the mask's bits
// are the k* constants above): none, one section, or all of them. Returns
// cudaErrorInvalidValue for any other mask.
extern "C" int obs_render3_ablate_launch(
    const void* sb, const void* tok, const void* counts, const void* rc,
    const void* gcnt, const void* gtok, const void* scan, void* out,
    int E, int H, int W, int A, int NB, int K, int S, int G, int T, int ohr,
    int owr, int skip, void* stream) {
#define OBS3_CASE(m)                                                                  \
  case m:                                                                             \
    return launch<m>(sb, tok, counts, rc, gcnt, gtok, scan, out, E, H, W, A, NB, K, S, \
                     G, T, ohr, owr, stream);
  switch (skip) {
    OBS3_CASE(0)
    OBS3_CASE(kGlobals)
    OBS3_CASE(kWinread)
    OBS3_CASE(kCount)
    OBS3_CASE(kScan)
    OBS3_CASE(kCopy)
    OBS3_CASE(kFill)
    OBS3_CASE(kStore)
    OBS3_CASE(kAll)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OBS3_CASE
}
