// Token-observation render v1 (kernel K5) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces metta_tpu/ops/obs_render.py:_obs_kernel (the Pallas TPU kernel
// behind render_obs_pallas, which the JAX package's sequential step and
// reset run when tables.obs_renderer == "pl"). For every agent of every env:
// global tokens first, then the tokens of the window cells in center-out
// order, each (loc=(row<<4)|col, feat, val), the cell's first slot being the
// exclusive prefix sum of the counts of the cells before it, after the
// agent's global-token count; each cell writes min(count, K) tokens, cut at
// T, and every other slot is 255. A cell's block id comes from two planes,
// merged here as in the TPU kernel: the agent plane (agent id + 1) where an
// agent stands, else the static plane; outside the map, block 0. Its plain
// torch version is metta_tpu_torch/ops/obs_render.py:render_obs1_plain.
//
// What bounds it: bytes, on paper. Each agent reads its window's cells from
// both planes, their blocks' counts and tokens, and writes T*3 bytes (59 MB
// of output at combat's E=4096, 24 agents, T=200); a few adds per cell and a
// select per slot are far below the card's integer rate. On the card, as for
// K1 and K4, each agent's few hundred instructions, issued by the resident
// warps, set the time. The first design (a block of 128 threads per agent,
// a tile prefilled in shared memory, a block scan with two barriers per pass
// and a serial byte loop per cell) spent its time on its launch shape.
//
// Design: K1's persistent render (csrc/obs_render3.cu) on K5's two planes. A
// persistent grid of 256-thread blocks, as many as the SMs hold, one warp
// per agent at a time: warp w of the grid takes the flat agent indices w,
// w + nw, w + 2 nw, ... (nw warps in the grid). The only block barrier is at
// the start, where the block caches the window's offsets and the cells'
// location bytes. For each agent:
//   1. every load of every window cell at once: lane l takes cells l, l + 32,
//      l + 64, l + 96 of each pass of 128, issues their agent-plane and
//      static-plane loads together (they do not depend on each other),
//      merges them, then issues their four count loads, and puts each
//      cell's block id and count in the warp's own [S] arrays in shared
//      memory;
//   2. in scan order, lane l takes cells 4l .. 4l+3 of each pass in
//      registers: one warp scan over the lanes' local sums gives every cell
//      its first slot, the carry starting at the global-token count;
//   3. slot-parallel tokens: lane j takes slot j of the pass (and j + 32,
//      ...), finds the lane that holds its cell by a binary search over the
//      lanes' first slots (shuffles), reads that lane's four counts and
//      block ids from the warp's arrays (on the card, faster than seven
//      more shuffles) and writes the token's three bytes (255 past the
//      cell's K tokens) into the warp's own staging row in shared memory,
//      laid out with the output row's offset past a word boundary; the
//      loads of slots j + 32 are issued before slot j's bytes are written,
//      so an agent with many tokens waits on one load latency, not one per
//      32 slots; the global tokens (255 past G) go before them;
//   4. the row leaves in word stores: the lanes take its 32-bit words in
//      turn, the words of tokens from the staging row, the rest 255 in
//      16-byte stores; the at most two words a row shares with its
//      neighbours store only their own bytes.
// The passes are a template parameter: one at S <= 128 (the loops unrolled),
// any number above that. The next agent's position is loaded under this
// agent's work (the first agent's under the block's start).
// Few agents (the sequential step at E=1: 24 agents, 3 blocks): the time is
// each agent's chain of dependent loads and instructions on its one warp,
// and the first design, which spread an agent over 128 threads, was faster
// there. Two cures were slower on the card at every shape: a copy of the
// first agent's env's counts and tokens in shared memory at the block's
// start, and one warp an SM.
// Limits: the block's shared memory (the launcher refuses more), E * A < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 4;              // window cells a lane takes per pass
constexpr int kPass = 128;             // window cells of a pass (32 lanes x kCells)
constexpr int kMaxSmem = 232448;       // shared memory a block can use

// A warp's staging row: 3T bytes after up to 3 bytes of word offset.
__host__ __device__ size_t stage_bytes(int T) { return ((size_t)3 * T + 3 + 15) / 16 * 16; }

// Shared memory, each array 16-byte aligned: the block's window offsets
// [Sp] (int2); each warp's block ids [Sp], counts [Sp] (int) and staging
// row; the cells' location bytes [S]. Sp is S rounded up to 4.
__host__ __device__ int padded(int S) { return (S + 3) & ~3; }
size_t smem_bytes(int S, int T) {
  return (size_t)padded(S) * 8 + (size_t)kWarps * (8 * (size_t)padded(S) + stage_bytes(T)) +
         ((size_t)S + 15) / 16 * 16;
}

template <int NP>  // passes of 128 cells; 0: any number
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
    int E, int A, int H, int W, int NB, int K, int S, int G, int T, int ohr, int owr) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int Sp = padded(S);
  int2* off = reinterpret_cast<int2*>(smem);                          // [Sp]
  int* blk_all = reinterpret_cast<int*>(off + Sp);                    // [kWarps, Sp]
  int* cnt_all = blk_all + (size_t)kWarps * Sp;                       // [kWarps, Sp]
  uint8_t* stage_all = reinterpret_cast<uint8_t*>(cnt_all + (size_t)kWarps * Sp);
  uint8_t* loc = stage_all + (size_t)kWarps * stage_bytes(T);         // [S]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_agents = E * A;  // < 2^31 (the launcher checks)
  const int stride = gridDim.x * kWarps;
  const int g3 = min(3 * G, 32);  // global-token bytes loaded with the agent's position
  int p = blockIdx.x * kWarps + warp;
  int ar = 0, ac = 0, g_raw = 0;
  uint32_t gbyte = 255u;  // global token bytes 0-31 (255 past G)
  if (p < n_agents) {  // the first agent's position, loaded under the block's start
    ar = __ldg(rc + 2 * p);
    ac = __ldg(rc + 2 * p + 1);
    g_raw = __ldg(gcnt + p);
    if (lane < g3) gbyte = __ldg(gtok + (size_t)p * G * 3 + lane);
  }
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const int dr = __ldg(scan + 2 * s), dc = __ldg(scan + 2 * s + 1);
    off[s] = make_int2(dr, dc);
    loc[s] = (uint8_t)((((dr + ohr) << 4) | (dc + owr)) & 255);
  }
  __syncthreads();  // the only block barrier

  int* blk = blk_all + (size_t)warp * Sp;
  int* cnt = cnt_all + (size_t)warp * Sp;
  uint8_t* stage = stage_all + (size_t)warp * stage_bytes(T);
  const int passes = NP > 0 ? NP : (S + kPass - 1) / kPass;
  const int row = 3 * T;
  if (lane < Sp - S) {  // the pads count no tokens
    blk[S + lane] = 0;
    cnt[S + lane] = 0;
  }

  for (; p < n_agents; p += stride) {
    const int pn = p + stride;
    int ar_n = 0, ac_n = 0, g_n = 0;
    uint32_t gbyte_n = 255u;
    if (pn < n_agents) {  // the next agent's position, loaded under this agent's work
      ar_n = __ldg(rc + 2 * pn);
      ac_n = __ldg(rc + 2 * pn + 1);
      g_n = __ldg(gcnt + pn);
      if (lane < g3) gbyte_n = __ldg(gtok + (size_t)pn * G * 3 + lane);
    }
    const int e = p / A;
    const int gc = min(g_raw, T);  // slots the global tokens take (255 past G)
    const uint8_t* gt = gtok + (size_t)p * G * 3;
    const int32_t* grid_e = agent_grid + (size_t)e * H * W;
    const int32_t* sb_e = sblock + (size_t)e * H * W;
    const int32_t* cnt_e = counts + (size_t)e * NB;

    // 1. the window's loads; each cell's block id and count to the warp's arrays
    for (int q = 0; q < passes; ++q) {
      const int base = q * kPass;
      int a1[kCells], st[kCells];
#pragma unroll
      for (int k = 0; k < kCells; ++k) {  // both planes' loads, all issued (outside: 0, 0)
        const int s = base + 32 * k + lane;
        a1[k] = 0;
        st[k] = 0;
        if (s < S) {
          const int2 d = off[s];
          const int r = ar + d.x, c = ac + d.y;
          if ((unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W) {
            a1[k] = __ldg(grid_e + r * W + c);
            st[k] = __ldg(sb_e + r * W + c);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kCells; ++k) {  // then the count loads (outside the map: block 0's)
        const int s = base + 32 * k + lane;
        if (s < S) {
          const int b = a1[k] > 0 ? a1[k] : st[k];
          blk[s] = b;
          cnt[s] = __ldg(cnt_e + b);
        }
      }
    }
    __syncwarp();

    // the global tokens into the staging row: row byte i at srow[i]
    uint8_t* orow = out + (size_t)p * row;
    const int mis = (int)(reinterpret_cast<uintptr_t>(orow) & 3);
    uint8_t* srow = stage + mis;
    if (lane < 3 * gc) srow[lane] = (uint8_t)gbyte;
    for (int i = 32 + lane; i < 3 * gc; i += 32) srow[i] = i < 3 * G ? __ldg(gt + i) : 255;

    // 2-3. each pass in scan order: the cells' first slots, then its tokens
    const uint8_t* tok_e = tok + (size_t)e * NB * K * 2;
    const int room = T - gc;  // slots left after the global tokens
    int carry = 0;            // token slots of the passes before (warp-uniform)
    for (int q = 0; q < passes; ++q) {
      const int base = q * kPass;
      const int s0 = base + lane * kCells;
      int local = 0;
      if (s0 < S) {
        const int4 n = *reinterpret_cast<const int4*>(cnt + s0);
        local = n.x + n.y + n.z + n.w;
      }
      int incl = local;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const int first = carry + incl - local;  // this lane's first slot after the globals
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      const int stop = min(carry + total, room);
      // Slot j's (feat, val) and location byte, its load issued: the lane whose
      // cells hold j by a binary search over the lanes' first slots, j's cell
      // among that lane's four from the warp's counts. Past the cell's K
      // tokens the slot stays 255. Every lane shuffles (jb is uniform).
      auto fetch = [&](int jb, uint32_t& fv, uint32_t& lb) {
        const int j = jb + lane;
        int L = 0;  // the last lane whose first slot is <= j
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int v = __shfl_sync(0xffffffffu, first, L + step);
          if (v <= j) L += step;
        }
        const int c0 = __shfl_sync(0xffffffffu, first, L);
        fv = 0xFFFFu;
        lb = 255u;
        if (j < stop) {
          const int4 nL = *reinterpret_cast<const int4*>(cnt + base + L * kCells);
          const int4 bL = *reinterpret_cast<const int4*>(blk + base + L * kCells);
          const int c1 = c0 + nL.x, c2 = c1 + nL.y, c3 = c2 + nL.z;
          const int k = (j >= c1) + (j >= c2) + (j >= c3);
          const int bk = k == 0 ? bL.x : (k == 1 ? bL.y : (k == 2 ? bL.z : bL.w));
          const int i = j - (k == 0 ? c0 : (k == 1 ? c1 : (k == 2 ? c2 : c3)));
          if (i < K) {
            fv = __ldg(reinterpret_cast<const uint16_t*>(tok_e + ((size_t)bk * K + i) * 2));
            lb = loc[base + L * kCells + k];
          }
        }
      };
      // software-pipelined: the next 32 slots' loads are issued before this 32's bytes land
      uint32_t fv = 0xFFFFu, lb = 255u;
      if (carry < stop) fetch(carry, fv, lb);
      for (int jb = carry; jb < stop; jb += 32) {
        uint32_t fv_n = 0xFFFFu, lb_n = 255u;
        if (jb + 32 < stop) fetch(jb + 32, fv_n, lb_n);
        if (jb + lane < stop) {
          uint8_t* d = srow + 3 * (gc + jb + lane);
          d[0] = (uint8_t)lb;
          d[1] = (uint8_t)fv;
          d[2] = (uint8_t)(fv >> 8);
        }
        fv = fv_n;
        lb = lb_n;
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
      uint32_t word = swords[k];
      const int valid = 3 * filled - i0;  // its bytes that hold tokens (>= 1)
      if (valid < 4) word |= 0xFFFFFFFFu << (8 * valid);
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
    __syncwarp();  // the warp's arrays and staging row are rewritten by its next agent
    ar = ar_n;
    ac = ac_n;
    g_raw = g_n;
    gbyte = gbyte_n;
  }
}

template <int NP>
int shape_of(int S, int T, int* smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (*smem > 48 * 1024)
    cudaFuncSetAttribute(obs_render_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         *smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, obs_render_kernel<NP>, kThreads, *smem);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape for S window cells and T tokens: dynamic shared memory
// bytes, blocks an SM holds and the SMs of the current device; returns 0 or
// a CUDA error (cudaErrorInvalidValue where a block's shared memory cannot
// hold the window's arrays and the staging rows).
extern "C" int obs_render_shape(int S, int T, int* smem, int* per_sm, int* sms) {
  if (S < 1 || T < 1 || smem_bytes(S, T) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  *smem = (int)smem_bytes(S, T);
  return S <= kPass ? shape_of<1>(S, T, smem, per_sm, sms) : shape_of<0>(S, T, smem, per_sm, sms);
}

// Launches the render on `stream`: min(ceil(E A / 8), SMs x blocks an SM
// holds) blocks; returns cudaGetLastError() (0 = launched).
extern "C" int obs_render_launch(
    const void* agent_grid, const void* sblock, const void* tok, const void* counts,
    const void* rc, const void* gcnt, const void* gtok, const void* scan, void* out,
    int E, int A, int H, int W, int NB, int K, int S, int G, int T, int ohr, int owr,
    void* stream) {
  if ((long long)E * A > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int smem, per_sm, sms;
  const int err = obs_render_shape(S, T, &smem, &per_sm, &sms);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long need = ((long long)E * A + kWarps - 1) / kWarps;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(need < most ? need : most);
  if (grid == 0) return 0;
  const dim3 shape(grid), block(kThreads);
  void* params[] = {&agent_grid, &sblock, &tok, &counts, &rc, &gcnt, &gtok, &scan, &out,
                    &E, &A, &H, &W, &NB, &K, &S, &G, &T, &ohr, &owr};
  const void* kernel = S <= kPass ? (const void*)obs_render_kernel<1>
                                  : (const void*)obs_render_kernel<0>;
  return (int)cudaLaunchKernel(kernel, shape, block, params, smem, (cudaStream_t)stream);
}
