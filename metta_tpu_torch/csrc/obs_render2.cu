// Token-observation render v2 for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces metta_tpu/ops/obs_render2.py:_obs2_kernel (the Pallas TPU kernel
// behind render_obs_pallas2). Same function as the v3 render: for every
// agent of every env, global tokens first, then the tokens of the window
// cells in center-out order, each (loc=(row<<4)|col, feat, val), truncated at
// T tokens; the remaining slots are 255. Its plain torch version is
// metta_tpu_torch/ops/obs_render2.py:render_obs2_plain.
//
// K4's own formulation: the window is walked in row-major order, and the
// center-out emission order lives in a rank table (rank[s] = position of
// row-major cell s in the center-out walk), where the TPU kernel baked it
// into a rank matrix. Each cell's count goes to its rank slot, and the slots
// are summed exclusively in rank order.
//
// What bounds it: memory, on paper. At E=4096 on the combat map it writes
// 59 MB of observations and reads the window cells of the block grid, the
// token tables and the counts (99 MB in all as ops/ablate_obs.py:render_work
// counts them); on the card each agent's few hundred instructions, issued
// by the resident warps, set the time, as they do K1's. At the curriculum
// learner's E=170 (4 MB) the depth of each agent's chain of dependent loads
// sets it: the first design walked an env's 2,904 (agent, cell) pairs with
// one block in about six rounds of dependent loads, 170 blocks for 132 SMs.
//
// Design: a persistent grid of 256-thread blocks, as many as the SMs hold,
// one warp per agent at a time. Warp w of the grid takes the flat agent
// indices w, w + nw, w + 2 nw, ... (nw warps in the grid). The only block
// barrier is at the start, where the block tables each rank slot's location
// byte; each lane keeps its cells' rank and window offsets in registers, and
// each warp its own rank slots and staging row in shared memory. Lane l takes
// cells l, l + 32, l + 64, l + 96 of each pass of 128 (NP passes, a template
// parameter: one at S <= 128, two at S <= 256), so neighbouring lanes on one
// window row read neighbouring `sb` words. For each agent, the dependent
// loads come in four levels:
//   1. its position, loaded under the previous agent's work;
//   2. every grid load of its window, all issued at once, beside its
//      global-token count and the first 32 bytes of its global tokens;
//   3. every count load, all issued at once;
//   4. its object tokens, one a lane (below).
// In the warp, between levels 3 and 4:
//   - each cell's count and block id go to its rank slot, slot[rank[s]];
//     after a __syncwarp, lane l takes slots 4 NP l .. 4 NP l + 4 NP - 1 of
//     the rank order, and one shuffle scan over the lanes' sums gives each
//     lane the first object token of its slots;
//   - slot-parallel tokens: lane j takes object token j (and j + 32, ...),
//     finds the lane whose slots hold it by a binary search over the lanes'
//     first tokens (shuffles), reads that lane's counts from the warp's
//     slots to find the rank slot, and loads the token's (feat, val) from
//     that slot's block; it writes (loc, feat, val) into the warp's staging
//     row in shared memory, laid out with the output row's offset past a word
//     boundary, after the global tokens, truncated at T;
//   - the row leaves in word stores: the lanes take its 32-bit words in turn
//     (each warp store covers 128 contiguous bytes), the words of tokens from
//     the staging row, the rest 255 in 16-byte stores; the at most two words
//     a row shares with its neighbours store only their own bytes.
// Slot-parallel tokens keep the warp's lanes busy where a cell-parallel walk
// (each lane its own cells' tokens, with the first four preloaded at level
// 3) leaves most of them idle; on the card the cell-parallel walk was the
// slower of the two at every shape of chip_smoke.py phase 4.
// Limits (checked by the launcher and by the wrapper, ops/obs_render2.py):
// at most kMaxCells window cells and kMaxTokens tokens a row (the staging
// row), E * A < 2^31. Agents, block ids and E are otherwise free.
//
// Section ablation (S4, the counterpart of scripts/ablate_obs.py:36
// make_kernel, run by metta_tpu_torch/scripts/ablate_obs.py): the kernel is
// a template on a mask of its sections, the k* constants below, named as K1's
// (csrc/obs_render3.cu). A set bit replaces the section by a stub that reads
// no device memory; obs_render2_launch runs mask 0, the render, and
// obs_render2_ablate_launch any of the nine masks the ablation takes, on
// mask 0's grid, at one pass (S <= kPass). There rank slot r holds what K1's
// scan cell r holds and lane l the same four slots, and the stubs are K1's
// with r for K1's s, so the two ablations are one function of the inputs:
// its plain version is metta_tpu_torch/ops/ablate_obs.py:
// render_obs3_ablated_plain, through render_obs2_ablated_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 4;              // window cells a lane takes per pass
constexpr int kPass = 128;            // window cells of a pass (32 lanes x kCells)
constexpr int kMaxCells = 256;         // window cells the kernel takes (two passes)
constexpr int kMaxTokens = 2048;       // tokens a warp's staging row holds

// Sections, as bits of the ablation mask kSkip, and what each stub does instead.
constexpr int kGlobals = 1;   // the global-token loads and their staging writes;
                              // stub: byte i of agent a's global tokens is i + a
constexpr int kWinread = 2;   // level 2's grid loads; stub: about one cell in twelve
                              // holds block 1 + h % (NB - 1), h = e + a + rank, none outside
constexpr int kCount = 4;     // level 3's count loads (the rank-slot writes stay);
                              // stub: min(K, 1 + (b + rank) % 3) for b > 0
constexpr int kScan = 8;      // the warp scan in rank order; stub: one slot for each
                              // lane that holds a token (a ballot and a popcount)
constexpr int kCopy = 16;     // the lane search, the shuffles, the token loads and the
                              // staging writes; stub: each rank slot's first token slot
                              // only, (loc, block id, count), from the warp's slots
constexpr int kFill = 32;     // the 255 stores; stub: the fill's first three bytes only
constexpr int kStore = 64;    // the token words; stub: word k of row p holds
                              // (k + p) & 255 in each byte, no staging read
constexpr int kAll = 127;

// A warp's staging row: 3T bytes after up to 3 bytes of word offset.
__host__ __device__ size_t stage_bytes(int T) { return ((size_t)3 * T + 3 + 15) / 16 * 16; }

// A warp's shared memory: its rank slots' counts and block ids [kPass NP]
// (int each) and its staging row.
__host__ __device__ size_t warp_bytes(int passes, int T) {
  return (size_t)8 * kPass * passes + stage_bytes(T);
}

// A block's: each rank slot's location byte [kPass NP], then its warps'.
__host__ __device__ size_t block_bytes(int passes, int T) {
  return (size_t)kPass * passes + kWarps * warp_bytes(passes, T);
}

__device__ __forceinline__ uint32_t ldg_u16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint16_t*>(p));
}

// The stubbed instantiations (one pass only) are built for the render's
// occupancy, 5 blocks an SM; the render itself (mask 0) takes no hint (0),
// so that it keeps its own build, as K1's does.
template <int NP, int kSkip>
__global__ void __launch_bounds__(kThreads, kSkip ? 5 : 0) obs_render2_kernel(
    const int32_t* __restrict__ sb,      // [E, H, W] combined block grid
    const uint8_t* __restrict__ tok,     // [E, NB, K, 2] (feat, val) per block
    const int32_t* __restrict__ counts,  // [E, NB] tokens per block
    const int32_t* __restrict__ rc,      // [E, A, 2] agent (row, col)
    const int32_t* __restrict__ gcnt,    // [E, A] global token count
    const uint8_t* __restrict__ gtok,    // [E, A, G, 3] global tokens
    const int32_t* __restrict__ rank,    // [S] center-out rank of row-major cell s
    uint8_t* __restrict__ out,           // [E, A, T, 3]
    int E, int H, int W, int A, int NB, int K, int WH, int WW, int G, int T) {
  static_assert(kSkip == 0 || NP == 1, "the stubs take one pass");
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kC = kCells * NP;    // cells a lane holds
  constexpr int kSlots = kPass * NP;
  constexpr int kPer = 4 * NP;       // rank slots a lane takes in the scan
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* loc_r = smem;             // [kSlots] location byte of each rank slot
  int* cnt_r = reinterpret_cast<int*>(smem + kSlots + (size_t)warp * warp_bytes(NP, T));
  int* blk_r = cnt_r + kSlots;       // [kSlots] the warp's counts and block ids by rank
  uint8_t* stage = reinterpret_cast<uint8_t*>(blk_r + kSlots);
  const int S = WH * WW;
  const int ohr = WH / 2, owr = WW / 2;
  for (int s = threadIdx.x; s < S; s += kThreads)
    loc_r[__ldg(rank + s)] = (uint8_t)((((s / WW) << 4) | (s % WW)) & 255);
  // the lane's cells s = 32 k + lane: rank | window row << 8 | window col << 16, -1 past S
  int cell[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int s = 32 * k + lane;
    cell[k] = s < S ? (__ldg(rank + s) | (s / WW) << 8 | (s % WW) << 16) : -1;
  }
  for (int i = lane; i < kSlots; i += 32) cnt_r[i] = blk_r[i] = 0;  // past S: stay 0
  __syncthreads();  // the only block barrier: loc_r

  const int n_agents = E * A;  // < 2^31 (the launcher checks)
  const int stride = gridDim.x * kWarps;
  const int row = 3 * T;
  const int g3 = min(3 * G, 32);  // global-token bytes loaded with the grid

  int p = blockIdx.x * kWarps + warp;
  int ar = 0, ac = 0;
  if (p < n_agents) {  // level 1 of the first agent
    ar = __ldg(rc + 2 * p);
    ac = __ldg(rc + 2 * p + 1);
  }
  for (; p < n_agents; p += stride) {
    const int pn = p + stride;
    int ar_n = 0, ac_n = 0;
    if (pn < n_agents) {  // level 1 of the next agent, loaded under this agent's work
      ar_n = __ldg(rc + 2 * pn);
      ac_n = __ldg(rc + 2 * pn + 1);
    }
    // level 2: the global-token count and bytes (past the G global tokens:
    // 255), and the grid loads, all issued (outside the map: -1, no tokens)
    const int gc = min(__ldg(gcnt + p), T);
    uint32_t gbyte = 255u;
    if constexpr (!(kSkip & kGlobals))
      gbyte = lane < g3 ? __ldg(gtok + (size_t)p * G * 3 + lane) : 255u;
    const int e = p / A;
    const int32_t* sb_e = sb + (size_t)e * H * W;
    const int32_t* cnt_e = counts + (size_t)e * NB;
    const uint8_t* tok_e = tok + (size_t)e * NB * K * 2;
    int b[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      b[k] = -1;
      if (cell[k] >= 0) {
        if constexpr ((kSkip & kWinread) != 0) {
          const int h = e + (p - e * A) + (cell[k] & 255);
          b[k] = (h % 12 == 0 && NB > 1) ? 1 + h % (NB - 1) : 0;
        } else {
          const int r = ar + ((cell[k] >> 8) & 255) - ohr;
          const int c = ac + (cell[k] >> 16) - owr;
          if ((unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W)
            b[k] = __ldg(sb_e + r * W + c);
        }
      }
    }
    // level 3: the count loads, all issued; counts and block ids to their rank slots
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      int n;
      if constexpr ((kSkip & kCount) != 0) {
        n = b[k] > 0 ? min(K, 1 + (b[k] + (cell[k] & 255)) % 3) : 0;
      } else {
        n = b[k] >= 0 ? __ldg(cnt_e + b[k]) : 0;
      }
      if (cell[k] >= 0) {
        cnt_r[cell[k] & 255] = n;
        blk_r[cell[k] & 255] = max(b[k], 0);
      }
    }
    __syncwarp();

    // the scan in rank order: each lane's first object token
    int4 v[NP];
    int local = 0;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      v[q] = reinterpret_cast<const int4*>(cnt_r)[NP * lane + q];
      local += v[q].x + v[q].y + v[q].z + v[q].w;
    }
    int total, first;  // the agent's object tokens; this lane's first
    if constexpr ((kSkip & kScan) != 0) {
      const unsigned held = __ballot_sync(0xffffffffu, local > 0);
      total = __popc(held);
      first = __popc(held & ((1u << lane) - 1u));
    } else {
      int incl = local;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      total = __shfl_sync(0xffffffffu, incl, 31);
      first = incl - local;
    }

    // the global tokens, then the object tokens, into the staging row: row
    // byte i at srow[i]
    uint8_t* orow = out + (size_t)p * row;
    const int mis = (int)(reinterpret_cast<uintptr_t>(orow) & 3);
    uint8_t* srow = stage + mis;
    const uint8_t* gt = gtok + (size_t)p * G * 3;
    if constexpr ((kSkip & kGlobals) != 0) {
      for (int i = lane; i < 3 * gc; i += 32) srow[i] = (uint8_t)(i + (p - e * A));
    } else {
      if (lane < 3 * gc) srow[lane] = (uint8_t)gbyte;
      for (int i = 32 + lane; i < 3 * gc; i += 32) srow[i] = i < 3 * G ? __ldg(gt + i) : 255;
    }
    const int stop = min(total, T - gc);  // object tokens that fit
    if constexpr ((kSkip & kCopy) != 0) {
      const int4 bq = reinterpret_cast<const int4*>(blk_r)[lane];
      const int nk[kCells] = {v[0].x, v[0].y, v[0].z, v[0].w};
      const int bk[kCells] = {bq.x, bq.y, bq.z, bq.w};
      int ck = first;
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        if (nk[k] > 0 && ck < stop) {
          uint8_t* d = srow + 3 * (gc + ck);
          d[0] = loc_r[kCells * lane + k];
          d[1] = (uint8_t)bk[k];
          d[2] = (uint8_t)nk[k];
        }
        ck += nk[k];
      }
    } else {
      for (int jb = 0; jb < stop; jb += 32) {  // uniform: every lane shuffles
        const int j = jb + lane;
        int L = 0;  // the last lane whose first token is <= j: its slots hold j
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int u = __shfl_sync(0xffffffffu, first, L + step);
          if (u <= j) L += step;
        }
        const int f = __shfl_sync(0xffffffffu, first, L);
        if (j < stop) {
          int acc = f, k = 0, ck = f;  // j's slot among L's, and its first token
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            const int4 nq = reinterpret_cast<const int4*>(cnt_r)[NP * L + q];
            const int ns[4] = {nq.x, nq.y, nq.z, nq.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (q == NP - 1 && u == 3) break;
              acc += ns[u];
              if (acc <= j) {
                k = 4 * q + u + 1;
                ck = acc;
              }
            }
          }
          const int slot = kPer * L + k;
          const uint32_t fv = ldg_u16(tok_e + ((size_t)blk_r[slot] * K + (j - ck)) * 2);
          uint8_t* d = srow + 3 * (gc + j);
          d[0] = loc_r[slot];
          d[1] = (uint8_t)fv;  // feat
          d[2] = (uint8_t)(fv >> 8);  // val
        }
      }
    }
    __syncwarp();

    // the token words: word k covers row bytes [4k - mis, 4k - mis + 4)
    const int filled = min(T, gc + total);
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
    // The next agent rewrites the slots and the staging row only after its
    // loads and a __syncwarp(): no barrier is needed here.
    ar = ar_n;
    ac = ac_n;
  }
}

// The launch shape of instantiation <NP, kSkip> for T tokens.
template <int NP, int kSkip>
int shape_of(int T, int* smem, int* per_sm, int* sms) {
  *smem = (int)block_bytes(NP, T);
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (*smem > 48 * 1024)
    cudaFuncSetAttribute(obs_render2_kernel<NP, kSkip>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, obs_render2_kernel<NP, kSkip>, kThreads,
                                                *smem);
  return (int)cudaGetLastError();
}

// Launches instantiation <NP, kSkip> on mask 0's grid: min(ceil(E A / 8),
// SMs x blocks an SM holds of mask 0) blocks.
template <int NP, int kSkip>
int launch(const void* sb, const void* tok, const void* counts, const void* rc,
           const void* gcnt, const void* gtok, const void* rank, void* out,
           int E, int H, int W, int A, int NB, int K, int WH, int WW, int G, int T,
           void* stream) {
  if ((long long)E * A > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int smem, per_sm, sms;
  int err = shape_of<NP, 0>(T, &smem, &per_sm, &sms);
  if (err == 0 && kSkip != 0) {
    int per_sm_v;
    err = shape_of<NP, kSkip>(T, &smem, &per_sm_v, &sms);
  }
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long need = ((long long)E * A + kWarps - 1) / kWarps;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(need < most ? need : most);
  if (grid == 0) return 0;
  obs_render2_kernel<NP, kSkip><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sb, (const uint8_t*)tok, (const int32_t*)counts, (const int32_t*)rc,
      (const int32_t*)gcnt, (const uint8_t*)gtok, (const int32_t*)rank, (uint8_t*)out,
      E, H, W, A, NB, K, WH, WW, G, T);
  return (int)cudaGetLastError();
}

bool window_fits(int S, int T) { return S >= 1 && S <= kMaxCells && T >= 1 && T <= kMaxTokens; }

}  // namespace

// The launch shape for S window cells and T tokens: dynamic shared memory
// bytes, blocks an SM holds and the SMs of the current device; returns 0 or a
// CUDA error (cudaErrorInvalidValue past kMaxCells or kMaxTokens).
extern "C" int obs_render2_shape(int S, int T, int* smem, int* per_sm, int* sms) {
  if (!window_fits(S, T)) return (int)cudaErrorInvalidValue;
  return S <= kPass ? shape_of<1, 0>(T, smem, per_sm, sms) : shape_of<2, 0>(T, smem, per_sm, sms);
}

// Launches the render on `stream`: min(ceil(E A / 8), SMs x blocks an SM
// holds) blocks; returns cudaGetLastError() (0 = launched).
extern "C" int obs_render2_launch(
    const void* sb, const void* tok, const void* counts, const void* rc,
    const void* gcnt, const void* gtok, const void* rank, void* out,
    int E, int H, int W, int A, int NB, int K, int WH, int WW, int G, int T,
    void* stream) {
  const int S = WH * WW;
  if (!window_fits(S, T)) return (int)cudaErrorInvalidValue;
  return S <= kPass ? launch<1, 0>(sb, tok, counts, rc, gcnt, gtok, rank, out, E, H, W, A, NB,
                                   K, WH, WW, G, T, stream)
                    : launch<2, 0>(sb, tok, counts, rc, gcnt, gtok, rank, out, E, H, W, A, NB,
                                   K, WH, WW, G, T, stream);
}

// The render with the sections of `skip` stubbed (S4; the mask's bits are the
// k* constants above): none, one section, or all of them, at one pass.
// Returns cudaErrorInvalidValue for any other mask or past kPass window cells.
extern "C" int obs_render2_ablate_launch(
    const void* sb, const void* tok, const void* counts, const void* rc,
    const void* gcnt, const void* gtok, const void* rank, void* out,
    int E, int H, int W, int A, int NB, int K, int WH, int WW, int G, int T, int skip,
    void* stream) {
  if (!window_fits(WH * WW, T) || WH * WW > kPass) return (int)cudaErrorInvalidValue;
#define OBS2_CASE(m)                                                                          \
  case m:                                                                                     \
    return launch<1, m>(sb, tok, counts, rc, gcnt, gtok, rank, out, E, H, W, A, NB, K, WH, WW, \
                        G, T, stream);
  switch (skip) {
    OBS2_CASE(0)
    OBS2_CASE(kGlobals)
    OBS2_CASE(kWinread)
    OBS2_CASE(kCount)
    OBS2_CASE(kScan)
    OBS2_CASE(kCopy)
    OBS2_CASE(kFill)
    OBS2_CASE(kStore)
    OBS2_CASE(kAll)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OBS2_CASE
}
