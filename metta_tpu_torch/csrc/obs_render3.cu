// Token-observation render for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces metta_tpu/ops/obs_render3.py:_obs3_kernel (the Pallas TPU kernel
// behind render_obs_pallas3). Same function: for every agent of every env,
// global tokens first, then the tokens of the window cells in center-out
// order (the rows of `scan`), each (loc=(wr<<4)|wc, feat, val), truncated at
// T tokens; the remaining slots are 255. Its plain torch version is
// metta_tpu_torch/ops/obs_render3.py:render_obs3_plain.
//
// What bounds it: memory. At E=4096 on the combat map it writes 59 MB of
// observations and reads the window cells of the block grid, the token
// tables and the counts (96.7 MB in all as ops/ablate_obs.py:render_work
// counts them); it does a few integer operations per byte. The first design
// spent half its time on its launch shape (4096 blocks of 768 threads, each
// storing its tile in one burst after a barrier); this one stores as it goes
// and spends its time issuing each agent's few hundred instructions: on the
// card, neither stubbing the cell loads nor the token loads changes it much.
//
// Design: a persistent grid of 256-thread blocks, as many as the SMs hold,
// one warp per agent at a time. Warp w of the grid takes the flat agent
// indices w, w + nw, w + 2 nw, ... (nw warps in the grid), so consecutive
// warps write consecutive rows and no warp waits on another: the only block
// barrier is at the start, where the block caches the window's offsets.
// For each agent:
//   1. every load of every window cell at once: lane l takes cells l, l + 32,
//      l + 64, l + 96 of each pass of 128, issues their four grid loads
//      together, then their four count loads, and puts each cell's block id
//      and count in the warp's own [S] arrays in shared memory;
//   2. in scan order, lane l takes cells 4l .. 4l+3 of each pass of 128
//      (one pass at S <= 128) in registers: one warp scan over the lanes'
//      local sums gives every cell its first object slot;
//   3. slot-parallel tokens: lane j takes object slot j of the pass (and
//      j + 32, ...), finds the lane that holds its cell by a binary search
//      over the lanes' first slots (shuffles), takes that lane's four cells
//      (shuffles) and writes the token's three bytes into the warp's own
//      staging row in shared memory, laid out with the output row's offset
//      past a word boundary; the global tokens (loaded when the agent
//      starts) go before them;
//   4. the row leaves in word stores: the lanes take its 32-bit words in
//      turn (each warp store covers 128 contiguous bytes), the words of
//      tokens from the staging row, the rest 255 in 16-byte stores; the at
//      most two words a row shares with its neighbours store only their own
//      bytes.
// The next agent's position is loaded under this agent's work; nothing
// waits on a block barrier between agents.
//
// Section ablation (S5, the counterpart of scripts/ablate_obs3.py:40
// make_kernel, run by metta_tpu_torch/scripts/ablate_obs3.py): the kernel is
// a template on a mask of its sections, the k* constants below. A set bit
// replaces the section by a stub that reads no device memory;
// obs_render3_launch runs mask 0, the render, and obs_render3_ablate_launch
// any of the nine masks the ablation takes, on mask 0's grid, so that a
// variant's saving is its section's and not a launch shape's. The plain
// version of every mask is metta_tpu_torch/ops/ablate_obs.py:
// render_obs3_ablated_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 4;              // window cells a lane takes per pass
constexpr int kPass = 32 * kCells;

// Sections, as bits of the ablation mask kSkip, and what each stub does instead.
constexpr int kGlobals = 1;   // the global-token loads and their staging writes;
                              // stub: byte i of agent a's global tokens is i + a
constexpr int kWinread = 2;   // step 1's grid loads; stub: about one cell in twelve
                              // holds block 1 + h % (NB - 1), h = e + a + s, none outside
constexpr int kCount = 4;     // step 1's count loads; stub: min(K, 1 + (b + s) % 3) for b > 0
constexpr int kScan = 8;      // step 2's warp scan and carry; stub: one slot for each
                              // lane that holds a token (a ballot and a popcount)
constexpr int kCopy = 16;     // step 3: the lane search, the shuffles, the token loads and
                              // the staging writes; stub: each cell's first slot only,
                              // (loc, block id, count), from the lane's own registers
constexpr int kFill = 32;     // the 255 stores; stub: the fill's first three bytes only
constexpr int kStore = 64;    // step 4's token words; stub: word k of row p holds
                              // (k + p) & 255 in each byte, no staging read
constexpr int kAll = 127;

// A warp's staging row: 3T bytes after up to 3 bytes of word offset.
__host__ __device__ size_t stage_bytes(int T) { return ((size_t)3 * T + 3 + 15) / 16 * 16; }

// Shared memory, each array 16-byte aligned: the block's window offsets
// [Sp] (int2); each warp's block ids [Sp], counts [Sp] (int) and staging
// row; the cells' location bytes [S]. Sp is S rounded up to 4.
__host__ __device__ int padded(int S) { return (S + 3) & ~3; }
size_t smem_bytes(int S, int T) {
  return (size_t)padded(S) * 8 + (size_t)kWarps * (8 * (size_t)padded(S) + stage_bytes(T)) +
         (S + 15) / 16 * 16;
}

// The stubbed instantiations are built for the render's occupancy, 5 blocks
// an SM (at most 51 registers): without the hint ptxas built the fill's stub
// at 40 registers with a spill. The render itself (mask 0) takes no hint (0),
// so that it keeps its own build: a hint of 5 built it at 47 registers, and
// one of 1 at 62, each with other instructions.
template <int kSkip>
__global__ void __launch_bounds__(kThreads, kSkip ? 5 : 0) obs_render3_kernel(
    const int32_t* __restrict__ sb,      // [E, H, W] combined block grid
    const uint8_t* __restrict__ tok,     // [E, NB, K, 2] (feat, val) per block
    const int32_t* __restrict__ counts,  // [E, NB] tokens per block
    const int32_t* __restrict__ rc,      // [E, A, 2] agent (row, col)
    const int32_t* __restrict__ gcnt,    // [E, A] global token count
    const uint8_t* __restrict__ gtok,    // [E, A, G, 3] global tokens
    const int32_t* __restrict__ scan,    // [S, 2] window offsets (dr, dc)
    uint8_t* __restrict__ out,           // [E, A, T, 3]
    int E, int H, int W, int A, int NB, int K, int S, int G, int T, int ohr, int owr) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int Sp = padded(S);
  int2* off = reinterpret_cast<int2*>(smem);                          // [Sp]
  int* blk_all = reinterpret_cast<int*>(off + Sp);                    // [kWarps, Sp]
  int* cnt_all = blk_all + (size_t)kWarps * Sp;                       // [kWarps, Sp]
  uint8_t* stage_all = reinterpret_cast<uint8_t*>(cnt_all + (size_t)kWarps * Sp);
  uint8_t* loc = stage_all + (size_t)kWarps * stage_bytes(T);         // [S]
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const int dr = __ldg(scan + 2 * s), dc = __ldg(scan + 2 * s + 1);
    off[s] = make_int2(dr, dc);
    loc[s] = (uint8_t)((((dr + ohr) << 4) | (dc + owr)) & 255);
  }
  __syncthreads();  // the only block barrier

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* blk = blk_all + (size_t)warp * Sp;
  int* cnt = cnt_all + (size_t)warp * Sp;
  uint8_t* stage = stage_all + (size_t)warp * stage_bytes(T);
  const int n_agents = E * A;  // < 2^31 (the launcher checks)
  const int stride = gridDim.x * kWarps;
  const int row = 3 * T;
  if (lane < Sp - S) {  // the pads count no tokens
    blk[S + lane] = 0;
    cnt[S + lane] = 0;
  }

  int p = blockIdx.x * kWarps + warp;
  int e = p / A, a = p % A;  // this agent's env and index, advanced by the stride below
  const int step_e = stride / A, step_a = stride % A;
  int ar = 0, ac = 0, g_raw = 0;
  if (p < n_agents) {
    ar = __ldg(rc + 2 * p);
    ac = __ldg(rc + 2 * p + 1);
    g_raw = __ldg(gcnt + p);
  }
  for (; p < n_agents; p += stride) {
    const int pn = p + stride;
    int ar_n = 0, ac_n = 0, g_n = 0;
    if (pn < n_agents) {  // the next agent's position, loaded under this agent's work
      ar_n = __ldg(rc + 2 * pn);
      ac_n = __ldg(rc + 2 * pn + 1);
      g_n = __ldg(gcnt + pn);
    }
    const int gc = min(g_raw, T);
    const uint8_t* gt = gtok + (size_t)p * G * 3;
    uint32_t gbyte = 0u;  // global token bytes 0-31
    if constexpr (!(kSkip & kGlobals)) gbyte = lane < 3 * gc ? __ldg(gt + lane) : 0u;
    const int32_t* sb_e = sb + (size_t)e * H * W;
    const int32_t* cnt_e = counts + (size_t)e * NB;

    // 1. the window's loads; each cell's block id and count to the warp's arrays
    for (int base = 0; base < S; base += kPass) {
      int b[kCells];
#pragma unroll
      for (int k = 0; k < kCells; ++k) {  // the grid loads, all issued
        const int s = base + 32 * k + lane;
        b[k] = -1;
        if (s < S) {
          if constexpr ((kSkip & kWinread) != 0) {
            const int h = e + a + s;
            b[k] = (h % 12 == 0 && NB > 1) ? 1 + h % (NB - 1) : 0;
          } else {
            const int2 d = off[s];
            const int r = ar + d.x, c = ac + d.y;
            if ((unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W)
              b[k] = __ldg(sb_e + r * W + c);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kCells; ++k) {  // then the count loads (outside the map: none)
        const int s = base + 32 * k + lane;
        int n;
        if constexpr ((kSkip & kCount) != 0) {
          n = b[k] > 0 ? min(K, 1 + (b[k] + s) % 3) : 0;
        } else {
          n = b[k] >= 0 ? __ldg(cnt_e + b[k]) : 0;
        }
        if (s < S) {
          blk[s] = b[k] < 0 ? 0 : b[k];
          cnt[s] = n;
        }
      }
    }
    __syncwarp();

    // the global tokens into the staging row: row byte i at srow[i]
    uint8_t* orow = out + (size_t)p * row;
    const int mis = (int)(reinterpret_cast<uintptr_t>(orow) & 3);
    uint8_t* srow = stage + mis;
    if constexpr ((kSkip & kGlobals) != 0) {
      for (int i = lane; i < 3 * gc; i += 32) srow[i] = (uint8_t)(i + a);
    } else {
      if (lane < 3 * gc) srow[lane] = (uint8_t)gbyte;
      for (int i = 32 + lane; i < 3 * gc; i += 32) srow[i] = __ldg(gt + i);
    }

    // 2-3. each pass in scan order: the cells' first slots, then its object tokens
    const uint8_t* tok_e = tok + (size_t)e * NB * K * 2;
    const int room = T - gc;  // object slots that fit
    int carry = 0;            // object tokens of the passes before (warp-uniform)
    for (int base = 0; base < S; base += kPass) {
      const int s0 = base + lane * kCells;
      int4 n = make_int4(0, 0, 0, 0), b = make_int4(0, 0, 0, 0);
      if (s0 < S) {
        n = *reinterpret_cast<const int4*>(cnt + s0);
        b = *reinterpret_cast<const int4*>(blk + s0);
      }
      const int local = n.x + n.y + n.z + n.w;
      int first, total;  // this lane's first object slot; the pass's object tokens
      if constexpr ((kSkip & kScan) != 0) {
        const unsigned held = __ballot_sync(0xffffffffu, local > 0);
        first = carry + __popc(held & ((1u << lane) - 1u));
        total = __popc(held);
      } else {
        int incl = local;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += v;
        }
        first = carry + incl - local;
        total = __shfl_sync(0xffffffffu, incl, 31);
      }
      const int stop = min(carry + total, room);
      if constexpr ((kSkip & kCopy) != 0) {
        const int nk[kCells] = {n.x, n.y, n.z, n.w}, bk[kCells] = {b.x, b.y, b.z, b.w};
        int ck = first;
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
          if (nk[k] > 0 && ck < stop) {
            uint8_t* d = srow + 3 * (gc + ck);
            d[0] = loc[s0 + k];
            d[1] = (uint8_t)bk[k];
            d[2] = (uint8_t)nk[k];
          }
          ck += nk[k];
        }
      } else {
        for (int jb = carry; jb < stop; jb += 32) {  // uniform: every lane shuffles
          const int j = jb + lane;
          int L = 0;  // the last lane whose first slot is <= j: it holds j's cell
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            const int v = __shfl_sync(0xffffffffu, first, L + step);
            if (v <= j) L += step;
          }
          const int c0 = __shfl_sync(0xffffffffu, first, L);
          const int n0 = __shfl_sync(0xffffffffu, n.x, L), n1 = __shfl_sync(0xffffffffu, n.y, L);
          const int n2 = __shfl_sync(0xffffffffu, n.z, L);
          const int bx = __shfl_sync(0xffffffffu, b.x, L), by = __shfl_sync(0xffffffffu, b.y, L);
          const int bz = __shfl_sync(0xffffffffu, b.z, L), bw = __shfl_sync(0xffffffffu, b.w, L);
          if (j < stop) {
            const int c1 = c0 + n0, c2 = c1 + n1, c3 = c2 + n2;
            const int k = (j >= c1) + (j >= c2) + (j >= c3);  // j's cell among L's four
            const int bk = k == 0 ? bx : (k == 1 ? by : (k == 2 ? bz : bw));
            const int ck = k == 0 ? c0 : (k == 1 ? c1 : (k == 2 ? c2 : c3));
            const uint16_t fv = __ldg(reinterpret_cast<const uint16_t*>(
                tok_e + ((size_t)bk * K + (j - ck)) * 2));  // (feat, val)
            uint8_t* d = srow + 3 * (gc + j);
            d[0] = loc[base + L * kCells + k];
            d[1] = (uint8_t)fv;
            d[2] = (uint8_t)(fv >> 8);
          }
        }
      }
      carry += total;
    }
    __syncwarp();

    // 4. the token words: word k covers row bytes [4k - mis, 4k - mis + 4)
    const int filled = min(T, gc + carry);
    uint32_t* wrow = reinterpret_cast<uint32_t*>(orow - mis);
    const uint32_t* swords = reinterpret_cast<const uint32_t*>(stage);
    const int n_words = (3 * filled + mis + 3) >> 2;
    for (int k = lane; k < n_words; k += 32) {
      const int i0 = 4 * k - mis;  // row byte of the word's byte 0 (>= -3)
      uint32_t word;
      if constexpr ((kSkip & kStore) != 0) {
        word = 0x01010101u * (uint32_t)((k + p) & 255);
      } else {
        word = swords[k];
        const int valid = 3 * filled - i0;  // its bytes that hold tokens (>= 1)
        if (valid < 4) word |= 0xFFFFFFFFu << (8 * valid);
      }
      if (i0 >= 0 && i0 + 4 <= row) {
        wrow[k] = word;
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (i0 + x >= 0 && i0 + x < row) orow[i0 + x] = (uint8_t)(word >> (8 * x));
      }
    }
    // the rest of the row is 255: 16-byte stores, words and bytes at its ends
    // (offsets from the 16-byte boundary at or before the row's start)
    uint8_t* b16 = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(orow) & ~(uintptr_t)15);
    const int o16 = (int)(orow - b16);
    const int fa = o16 + max(4 * n_words - mis, 0), fb = o16 + row;  // fa is a word boundary
    if constexpr ((kSkip & kFill) != 0) {
      if (lane < 3 && fa + lane < fb) b16[fa + lane] = (uint8_t)(filled + lane);
    } else {
      for (int c = (fa >> 4) + lane; c < ((fb + 15) >> 4); c += 32) {
        const int lo = c << 4, hi = lo + 16;
        if (lo >= fa && hi <= fb) {
          *reinterpret_cast<uint4*>(b16 + lo) = make_uint4(~0u, ~0u, ~0u, ~0u);
        } else {
          int x = max(lo, fa);
          const int end = min(hi, fb);
          for (; x + 4 <= end; x += 4) *reinterpret_cast<uint32_t*>(b16 + x) = ~0u;
          for (; x < end; ++x) b16[x] = 255;
        }
      }
    }
    __syncwarp();  // the warp's starts and staging row are rewritten by its next agent
    ar = ar_n;
    ac = ac_n;
    g_raw = g_n;
    e += step_e;
    a += step_a;
    if (a >= A) {
      a -= A;
      ++e;
    }
  }
}

// The launch shape of instantiation kSkip for S window cells and T tokens.
template <int kSkip>
int shape_of(int S, int T, int* smem, int* per_sm, int* sms) {
  *smem = (int)smem_bytes(S, T);
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (*smem > 48 * 1024)
    cudaFuncSetAttribute(obs_render3_kernel<kSkip>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         *smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, obs_render3_kernel<kSkip>, kThreads, *smem);
  return (int)cudaGetLastError();
}

// Launches instantiation kSkip on mask 0's grid: min(ceil(E A / 8), SMs x
// blocks an SM holds of mask 0) blocks.
template <int kSkip>
int launch(const void* sb, const void* tok, const void* counts, const void* rc,
           const void* gcnt, const void* gtok, const void* scan, void* out,
           int E, int H, int W, int A, int NB, int K, int S, int G, int T, int ohr,
           int owr, void* stream) {
  if ((long long)E * A > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int smem, per_sm, sms;
  int err = shape_of<0>(S, T, &smem, &per_sm, &sms);
  if (err == 0 && kSkip != 0) {
    int per_sm_v;
    err = shape_of<kSkip>(S, T, &smem, &per_sm_v, &sms);
  }
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long need = ((long long)E * A + kWarps - 1) / kWarps;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(need < most ? need : most);
  if (grid == 0) return 0;
  obs_render3_kernel<kSkip><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sb, (const uint8_t*)tok, (const int32_t*)counts,
      (const int32_t*)rc, (const int32_t*)gcnt, (const uint8_t*)gtok,
      (const int32_t*)scan, (uint8_t*)out, E, H, W, A, NB, K, S, G, T, ohr, owr);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape for S window cells and T tokens: dynamic shared memory
// bytes, blocks an SM holds and the SMs of the current device; returns 0 or a
// CUDA error.
extern "C" int obs_render3_shape(int S, int T, int* smem, int* per_sm, int* sms) {
  return shape_of<0>(S, T, smem, per_sm, sms);
}

// Launches the render on `stream`: min(ceil(E A / 8), SMs x blocks an SM
// holds) blocks; returns cudaGetLastError() (0 = launched).
extern "C" int obs_render3_launch(
    const void* sb, const void* tok, const void* counts, const void* rc,
    const void* gcnt, const void* gtok, const void* scan, void* out,
    int E, int H, int W, int A, int NB, int K, int S, int G, int T, int ohr,
    int owr, void* stream) {
  return launch<0>(sb, tok, counts, rc, gcnt, gtok, scan, out, E, H, W, A, NB, K, S, G, T,
                   ohr, owr, stream);
}

// The render with the sections of `skip` stubbed (S5; the mask's bits are the
// k* constants above): none, one section, or all of them. Returns
// cudaErrorInvalidValue for any other mask.
extern "C" int obs_render3_ablate_launch(
    const void* sb, const void* tok, const void* counts, const void* rc,
    const void* gcnt, const void* gtok, const void* scan, void* out,
    int E, int H, int W, int A, int NB, int K, int S, int G, int T, int ohr,
    int owr, int skip, void* stream) {
#define OBS3_CASE(m)                                                                       \
  case m:                                                                                  \
    return launch<m>(sb, tok, counts, rc, gcnt, gtok, scan, out, E, H, W, A, NB, K, S, G, \
                     T, ohr, owr, stream);
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
