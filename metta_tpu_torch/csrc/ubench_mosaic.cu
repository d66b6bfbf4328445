// Primitive micro-benchmarks for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of scripts/ubench_mosaic.py (pallas_call
// at :42 in run_kernel, and at :125, :170, :190, :206): ten cases, each
// repeating one primitive that a redesigned render would be built from.
// Their plain torch versions are metta_tpu_torch/ops/ubench_mosaic.py:plain.
//
//   M5  tiny      acc = x + 1 (reps times)                     [264, 128] f32
//   M1  fold      acc += reshape(x, [264, 2048])               [4224, 128] f32
//   M1b fold      acc += reshape(x, [EA, 1408])                [EA*11, 128] f32
//   M2  transpose acc += x.T                                   [EA, 128] f32
//   M3  droll     acc += roll(x, shift[i % 24], lanes)         [16, 128] f32
//   M4  rep       acc += tile(x, 11 rows)                      [264, 128] f32
//   M6a-c gemm    in csrc/ubench_gemm.cu
//   M7  compact   ten roll/select stages over a [EA, 640] plane
//
// Every TPU case writes one output block from every grid step, so the last
// step's write stands. Here blocks run in any order, so each block writes
// its own slot [G, ...]; the wrapper's caller takes slot G-1. What the TPU
// output drops (the relayouts' other columns, the GEMMs' other rows) goes
// into a second output: a per-block checksum, the wrapping int32 sum of the
// float bit patterns (exact in any order) or, for the GEMMs, a float32 sum.
//
// Keeping the work real: the relayouts (M1, M1b, M2, M3, M4) are address
// arithmetic on Hopper, so every rep reloads each element it reads (from
// shared memory in the fold, M2 and M3, from L1 after the first rep in M4): its
// address is offset by r * rep_stride, a kernel argument the launchers set
// to 0, so that no compiler stage can prove two reps' loads alike and merge
// them (an empty asm barrier on the pointer does not stop ptxas from merging
// them). Every repeat loop carries its sum through `opaque`, an empty asm
// that stops the compiler from folding the reps into one operation (as
// jax.lax.optimization_barrier does). The loops stay loops: chip_smoke.py
// counts their instructions in the SASS and checks that each holds its
// loads and its arithmetic.
//
// What bounds them: each input byte read once and each output byte written
// once at 3.35 TB/s, or the float32 operations at the data sheet's 67 T/s,
// whichever takes longer (ops/timing.py:bound_of). M1, M1b, M2, M3 and M5
// are bound by their bytes, M4 and M7 by their operations. The data sheet
// counts an FFMA as two operations; an FADD issues at one a lane a clock,
// 132 x 128 = 16,896 adds a clock, 33.5 T/s at 1,980 MHz, so a case made of
// adds alone (M4) cannot come within half of that bound. The GEMMs (M6a-c)
// are in their own source, csrc/ubench_gemm.cu (TMA and wgmma), so that this
// file's kernels keep their code.
//
// M5 is a stream: 138 MB in and 138 MB out at G=1024, byte-bound at 0.083
// ms. Its first design, a block per g with each thread loading one float,
// adding and storing before its next load, lost to torch.add (1.34x). This
// one treats x and out as one flat array of G n floats (slot g is the range
// [g n, (g + 1) n)) and walks it in 16-byte vectors, one a thread, on a
// grid that covers the array in one round: thread v takes vector v; the
// last vector, where G n % 4 != 0, is partial and moves its floats in
// scalar loads and stores. The reps run over the vector's four
// accumulators, each element one chain of opaque adds in rep order, as the
// plain version takes them. On the card (NVIDIA H100 80GB HBM3, 700 W) the
// variants tried on this grid (more vectors a thread, streaming hints) came
// within about 2% of torch.add, the best of them within noise of it and of
// each other, so the simplest of those was kept; a persistent grid (SMs x
// blocks an SM) was slower with every variant.
//
// The fold (M1, M1b) is a streaming sum over G x n float32 elements (the
// reshape is the identity on the flat index), byte-bound at 0.70 and 0.18
// ms. Its first design, a block per g reading one element a thread at a
// time, kept about 8 KB of DRAM reads in flight an SM, under half of what
// 3.35 TB/s at about 700 ns needs, and ran at a fifth of the bound. This one
// is a persistent grid (two blocks an SM): block i takes the flat chunks
// [i C / nb, (i + 1) C / nb) of the C chunks of kFoldChunk floats (the last
// of each g may be short; none crosses a g), and its producer thread brings
// each chunk in one cp.async.bulk copy into a ring of kFoldStages
// shared-memory stages (a full and an empty mbarrier a stage), so that up to
// 192 KB an SM are in flight whatever the consumers do. Eight consumer warps
// read each chunk once every rep, in 16-byte shared loads, into 16
// independent accumulators a thread (each element's sum one chain of reps
// adds in rep order, as the plain version takes it), release the stage, and
// store the columns below 128 in 16-byte stores; the other columns' bits go
// into cks[g] by one wrapping atomicAdd a warp and g. The reps' shared
// reads (reps x 4 bytes an element at 128 bytes a clock an SM) set a floor
// above the byte bound: about 1.1-1.2 ms for M1 and 0.27-0.30 for M1b at
// reps 16.
//
// M4 (scripts/ubench_mosaic.py:141-153, the TPU body acc +
// pltpu.repeat(x_ref[0], 11, 0)) reads its [264, 128] block once a rep and
// adds it into each of its 11 copies. At G=1024, reps 16 that is 138 MB in,
// 138 MB out and 6.09 G float32 adds: bound 0.0909 ms by the operations at
// 67 T/s, and at least 0.182 ms by the FADD issue rate above. Its first
// design gave each of the 11 n outputs of a g its own thread-iteration, so
// every element was loaded 11 times a rep, behind an integer modulo, one
// dependent chain a thread at a time (2.15 ms). This one is a flat grid of
// 16-byte vectors, one a thread in one round, as M5's: each rep the thread
// loads its vector once and adds it into 11 x 4 independent accumulators,
// one for each copy of the tile, each its own chain of reps opaque adds in
// rep order (the TPU body's 2,904 rows are 2,904 adds; no copy's sum is
// taken from another's). Each chain starts from a zero of its own, the bits
// of c * rep_stride, so that no compiler stage can prove two copies' chains
// alike and merge them. Copy 0 goes to out[g] in 16-byte stores, the bits of
// copies 1-10, summed as a tree, into cks[g] by one wrapping atomicAdd a warp
// (n % 128 == 0, so a warp's 32 vectors lie in one g). Blocks of 128 threads,
// eight an SM (the launch bound caps a thread at 64 registers). On the card
// (NVIDIA H100 80GB HBM3, 700 W) the reps run at 84% of the FADD issue rate
// (chip_smoke.py times M4 at reps 1, 16 and 32; the loop's 51 instructions a
// rep hold 44 adds); above that stays a part that does not grow with reps,
// each thread's start, zeros and checksum tail, which the reps do not hide.
// Variants tried there were slower: 256- and 512-thread blocks, 768 threads
// an SM, a persistent grid, two to eight vectors a thread with or without
// the next one's load issued early, a block-level checksum, the rep loop
// unrolled twice.
//
// M2 (scripts/ubench_mosaic.py:104-113, acc + x_ref[0].T) is 50 MB in and
// 50 MB out at G=1024, eps 4: bound 0.0300 ms by the bytes. Its first design
// read output (c, r) as x[r][c] from global memory every rep, neighbouring
// threads 512 bytes apart (32 sectors a warp load for 128 useful bytes).
// This one splits x[g] [rows, 128] into four column tiles of 32, a block
// each: the block stages its tile [rows, 32] once in shared memory in
// coalesced 16-byte loads, each row padded to 33 floats, and every rep reads
// each element its outputs need from there in transposed order. A warp takes
// four of the tile's columns, its lanes consecutive rows r (lanes past the
// last row idle), so one warp read is 32 rows at one column: at a stride of
// 33 floats, 32 banks. Each thread carries its four columns' sums as four
// chains, and a warp's stores are 32 consecutive floats of an out[g] row.
// The reps' shared reads (805 MB at 128 bytes a clock an SM, about 0.024 ms
// at 1,980 MHz) are this design's floor, near the byte bound.
//
// M3 (scripts/ubench_mosaic.py:115-138, acc + pltpu.roll(x_ref[0],
// s_ref[0, i % 24], 1)) is 8.4 MB in and 8.4 MB out at G=1024, rows 16:
// bound 0.0050 ms by the bytes. Its first design walked each thread's eight
// outputs one after another, and every rep of each paid an integer modulo, a
// global load of its shift and a global (L1) load of x for one add. This one
// stages x[g] (8 KB) once in shared memory in coalesced 16-byte loads, and
// its shifts beside it. Thread t takes column j = t % 128 of rows t / 128 +
// 2 k, k < 8, as eight chains in rep order, and every rep reads element
// (j - s) & 127 of each of its rows from shared memory: a warp's 32
// consecutive columns fall in 32 banks for any s. The shift index is a
// counter that wraps at nshift. A block a g, 256 threads at no more than 32
// registers, so eight blocks an SM take G=1024 in one round on 132 SMs (the
// rep loop unrolled twice: at the compiler's four it spilled under that
// cap, and without the cap it took 79 registers and ran slower). The
// reps' shared reads (134 MB at 128 bytes a clock an SM, about 0.004 ms at
// 1,980 MHz) are its floor beside the byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTinyThreads = 512;          // M5's block
constexpr int kRepCopies = 11;             // M4's copies of the tile (ops/ubench_mosaic.py:COPIES)
constexpr int kRepThreads = 128;           // M4's block: 8 an SM at <= 64 registers
constexpr int kTrCols = 32;                // M2's column tile: x[g][:, 32 q:32 q + 32]
constexpr int kTrStride = kTrCols + 1;     // its padded row in shared memory
constexpr int kTrColsPerWarp = kTrCols / kWarps;
constexpr int kTrMaxRows = 256;            // M2's rows a block stages: 33,792 B, no opt-in needed
constexpr int kRollRowStep = kThreads / 128;  // M3: a thread a column, so 2 rows at a time
constexpr int kRollPerThread = 8;          // M3's rows a thread carries
constexpr int kRollRows = kRollRowStep * kRollPerThread;  // 16: M3's rows are a multiple
constexpr int kRollMaxRows = 64;           // M3's rows a block stages: 32 KB, no opt-in needed
constexpr int kRollMaxShifts = 32;
constexpr int kCols = 640;                 // M7's plane width
constexpr int kPerLane = kCols / 32;
constexpr int kFoldChunk = 4096;           // the fold's chunk: floats a stage holds (16 KB)
constexpr int kFoldStages = 6;             // stages of a block's ring: two blocks an SM
constexpr int kFoldConsumers = 256;        // consumer threads, then one producer warp
constexpr int kFoldThreads = kFoldConsumers + 32;
constexpr int kFoldPerThread = kFoldChunk / 4 / kFoldConsumers;  // float4s a thread a chunk
// The fold's dynamic shared memory: the ring, then a full and an empty
// mbarrier a stage.
constexpr int kFoldSmem = kFoldStages * kFoldChunk * 4 + 16 * kFoldStages;

__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

// The block's wrapping sum of `v` into *dst (thread 0 writes).
__device__ void block_bitsum(uint32_t v, int32_t* dst) {
  __shared__ uint32_t part[kWarps];
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int w = 0; w < kWarps; ++w) s += part[w];
    *dst = (int32_t)s;
  }
}

// M5: out = x + 1, reps times, over the flat [total] floats (16-byte aligned).
__global__ void __launch_bounds__(kTinyThreads) tiny_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long total, int reps) {
  const long long v = (long long)blockIdx.x * kTinyThreads + threadIdx.x;
  if (v >= (total + 3) / 4) return;  // vectors, the last one partial where total % 4 != 0
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int m = (int)min(total - 4 * v, 4LL);  // floats in this vector
  if (m == 4) {
    acc = reinterpret_cast<const float4*>(x)[v];
  } else {
    acc.x = x[4 * v];
    if (m > 1) acc.y = x[4 * v + 1];
    if (m > 2) acc.z = x[4 * v + 2];
  }
  for (int r = 0; r < reps; ++r) {
    acc.x = opaque(acc.x + 1.0f);
    acc.y = opaque(acc.y + 1.0f);
    acc.z = opaque(acc.z + 1.0f);
    acc.w = opaque(acc.w + 1.0f);
  }
  if (m == 4) {
    reinterpret_cast<float4*>(out)[v] = acc;
  } else {
    out[4 * v] = acc.x;
    if (m > 1) out[4 * v + 1] = acc.y;
    if (m > 2) out[4 * v + 2] = acc.z;
  }
}

// M1, M1b: acc [n / width, width] += reshape(x[g]) (row-major: the same
// flat index), reps times; columns < 128 -> out[g] [n / width, 128], the
// rest's bits -> cks[g] (zeroed by the caller). The fold's ring and chunks
// are described at the top of this file; ops/ubench_mosaic.py:fold_schedule
// mirrors the chunk schedule.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One 1-D bulk copy (TMA without a tensor map) of `bytes` (a multiple of 16)
// from global `src` to shared `dst`, both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The chunk's g, first element and length: chunk c of the G x per_g chunks.
__device__ __forceinline__ void fold_chunk(long long c, int per_g, int n, long long& g,
                                           int& start, int& len) {
  g = c / per_g;
  start = (int)(c - g * per_g) * kFoldChunk;
  len = min(kFoldChunk, n - start);
}

__device__ __forceinline__ uint32_t bits4(const float4& v) {
  return __float_as_uint(v.x) + __float_as_uint(v.y) + __float_as_uint(v.z) +
         __float_as_uint(v.w);
}

// Adds this warp's lanes' `bits` into cks[g] (a wrapping int32 sum).
__device__ __forceinline__ void fold_flush(uint32_t bits, int32_t* cks, long long g, int lane) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) bits += __shfl_xor_sync(0xffffffffu, bits, d);
  if (lane == 0) atomicAdd(reinterpret_cast<unsigned int*>(cks + g), bits);
}

__global__ void __launch_bounds__(kFoldThreads, 2) fold_kernel(
    const float* __restrict__ x, float* __restrict__ out, int32_t* __restrict__ cks,
    int n, int width, int reps, int rep_stride, long long chunks) {
  extern __shared__ __align__(128) uint8_t fold_smem[];
  float* ring = reinterpret_cast<float*>(fold_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFoldStages * kFoldChunk);
  uint64_t* empty = full + kFoldStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFoldStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFoldConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int per_g = (n + kFoldChunk - 1) / kFoldChunk;
  const long long begin = chunks * blockIdx.x / gridDim.x;
  const long long end = chunks * (blockIdx.x + 1) / gridDim.x;
  long long g;
  int start, len, stage = 0;
  uint32_t phase = 0;

  if (warp == kFoldConsumers / 32) {
    // ---- producer: lane 0 keeps the ring full ----
    if (lane != 0) return;
    for (long long c = begin; c < end; ++c) {
      fold_chunk(c, per_g, n, g, start, len);
      mbar_wait(empty + stage, phase ^ 1);
      mbar_expect(full + stage, 4 * len);
      bulk_load(ring + stage * kFoldChunk, x + g * n + start, 4 * len, full + stage);
      if (++stage == kFoldStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: thread t takes float4 t + kFoldConsumers q of each chunk ----
  long long cur_g = -1;
  uint32_t bits = 0;
  const int rows = n / width;
  for (long long c = begin; c < end; ++c) {
    fold_chunk(c, per_g, n, g, start, len);
    if (g != cur_g) {  // uniform: every consumer thread takes the same chunks
      if (cur_g >= 0) fold_flush(bits, cks, cur_g, lane);
      cur_g = g;
      bits = 0;
    }
    mbar_wait(full + stage, phase);
    const float4* src = reinterpret_cast<const float4*>(ring + stage * kFoldChunk) + threadIdx.x;
    float4 acc[kFoldPerThread];
#pragma unroll
    for (int q = 0; q < kFoldPerThread; ++q) acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int q = 0; q < kFoldPerThread; ++q) {
        const float4 v = src[q * kFoldConsumers];
        acc[q].x = opaque(acc[q].x + v.x);
        acc[q].y = opaque(acc[q].y + v.y);
        acc[q].z = opaque(acc[q].z + v.z);
        acc[q].w = opaque(acc[q].w + v.w);
      }
      src += rep_stride;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);  // the warp's reads of the stage are done
    if (++stage == kFoldStages) {
      stage = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int q = 0; q < kFoldPerThread; ++q) {
      const int i = 4 * (threadIdx.x + q * kFoldConsumers);  // the float4's first element
      if (i >= len) continue;
      const int f = start + i, row = f / width, col = f - row * width;
      if (col < 128) {  // a float4 never straddles column 128 (width % 128 == 0)
        *reinterpret_cast<float4*>(out + ((size_t)g * rows + row) * 128 + col) = acc[q];
      } else {
        bits += bits4(acc[q]);
      }
    }
  }
  if (cur_g >= 0) fold_flush(bits, cks, cur_g, lane);
}

// M2: acc [128, rows] += x[g].T (x [G, rows, 128]), reps times -> out[g].
// Block b takes g = b / 4 and the column tile q = b % 4 (described at the
// top of this file); dynamic shared memory: rows x kTrStride floats.
__global__ void __launch_bounds__(kThreads) transpose_kernel(
    const float* __restrict__ x, float* __restrict__ out, int rows, int reps, int rep_stride) {
  extern __shared__ __align__(16) float tile[];
  constexpr int tiles = 128 / kTrCols, vecs = kTrCols / 4;  // tiles a g, 16-byte vectors a row
  const int g = blockIdx.x / tiles, c0 = (blockIdx.x % tiles) * kTrCols;
  const float* xg = x + (size_t)g * rows * 128 + c0;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, q = i % vecs;
    const float4 v = *reinterpret_cast<const float4*>(xg + (size_t)r * 128 + 4 * q);
    float* d = tile + r * kTrStride + 4 * q;  // a padded row is not 16-byte aligned
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* og = out + ((size_t)g * 128 + c0) * rows;
  for (int r = lane; r < rows; r += 32) {  // the warp's columns warp + kWarps k
    float acc[kTrColsPerWarp];
#pragma unroll
    for (int k = 0; k < kTrColsPerWarp; ++k) acc[k] = 0.0f;
    const float* src = tile + r * kTrStride + warp;
    for (int i = 0; i < reps; ++i) {
#pragma unroll
      for (int k = 0; k < kTrColsPerWarp; ++k) acc[k] = opaque(acc[k] + src[kWarps * k]);
      src += rep_stride;
    }
#pragma unroll
    for (int k = 0; k < kTrColsPerWarp; ++k) og[(size_t)(warp + kWarps * k) * rows + r] = acc[k];
  }
}

// M3: acc [rows, 128] += roll(x[g], shifts[i % nshift], lanes), reps times
// (x [G, rows, 128], rows a multiple of kRollRows; described at the top of
// this file). Dynamic shared memory: rows x 128 floats.
__global__ void __launch_bounds__(kThreads, 8) droll_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ shifts, float* __restrict__ out,
    int rows, int nshift, int reps, int rep_stride) {
  extern __shared__ __align__(16) float tile[];
  __shared__ int shift[kRollMaxShifts];
  const int n = rows * 128;
  const float4* xg = reinterpret_cast<const float4*>(x + (size_t)blockIdx.x * n);
  for (int v = threadIdx.x; v < n / 4; v += kThreads) reinterpret_cast<float4*>(tile)[v] = xg[v];
  if (threadIdx.x < nshift) shift[threadIdx.x] = shifts[threadIdx.x];
  __syncthreads();
  const int j = threadIdx.x & 127;
  float* og = out + (size_t)blockIdx.x * n + j;
  for (int r0 = threadIdx.x >> 7; r0 < rows; r0 += kRollRows) {
    float acc[kRollPerThread];
#pragma unroll
    for (int k = 0; k < kRollPerThread; ++k) acc[k] = 0.0f;
    const float* src = tile + r0 * 128;
#pragma unroll 2
    for (int i = 0, s = 0; i < reps; ++i) {
      const float* rolled = src + ((j - shift[s]) & 127);
#pragma unroll
      for (int k = 0; k < kRollPerThread; ++k)
        acc[k] = opaque(acc[k] + rolled[k * kRollRowStep * 128]);
      src += rep_stride;
      if (++s == nshift) s = 0;
    }
#pragma unroll
    for (int k = 0; k < kRollPerThread; ++k) og[(r0 + k * kRollRowStep) * 128] = acc[k];
  }
}

// M4: acc [copies * rows, 128] += tile(x[g], copies rows), reps times, over
// the G n floats as 16-byte vectors, vector v a thread (described at the top
// of this file): copy 0 -> out[g], the other copies' bits -> cks[g] (zeroed
// by the caller). per_g (vectors a g) is a multiple of 32.
__global__ void __launch_bounds__(kRepThreads, 8) rep_kernel(
    const float4* __restrict__ x, float4* __restrict__ out, int32_t* __restrict__ cks,
    int per_g, int vecs, int reps, int rep_stride) {
  const int v = blockIdx.x * kRepThreads + threadIdx.x;
  uint32_t bits = 0;
  if (v < vecs) {  // whole warps: vecs is a multiple of 32
    float4 acc[kRepCopies];
#pragma unroll
    for (int c = 0; c < kRepCopies; ++c) {
      const float z = __int_as_float(c * rep_stride);  // +0.0f, an expression of its own
      acc[c] = make_float4(z, z, z, z);
    }
    const float4* src = x + v;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      const float4 t = *src;  // one load a rep feeds the 11 copies
#pragma unroll
      for (int c = 0; c < kRepCopies; ++c) {
        acc[c].x = opaque(acc[c].x + t.x);
        acc[c].y = opaque(acc[c].y + t.y);
        acc[c].z = opaque(acc[c].z + t.z);
        acc[c].w = opaque(acc[c].w + t.w);
      }
      src += rep_stride;
    }
    out[v] = acc[0];
    uint32_t b[kRepCopies - 1];  // copies 1-10, summed as a tree: a short tail after the reps
#pragma unroll
    for (int c = 1; c < kRepCopies; ++c) b[c - 1] = bits4(acc[c]);
    bits = ((b[0] + b[1]) + (b[2] + b[3])) + ((b[4] + b[5]) + (b[6] + b[7])) + (b[8] + b[9]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) bits += __shfl_xor_sync(0xffffffffu, bits, d);
  if ((threadIdx.x & 31) == 0 && v < vecs)
    atomicAdd(reinterpret_cast<unsigned int*>(cks + (unsigned)v / (unsigned)per_g), bits);
}

// M7: per row of x[g] [rows, 640]: v = x, d = x / 2; reps times, for b < 10:
// the plane rolled left by 2^b where d rolled left is > 0.5 (d then less
// 2^b). Columns < 128 of v -> out[g] [rows, 128], the rest's bits -> cks[g].
// One warp a row, both planes in registers: lane l holds columns l + 32 k,
// k < 20. A roll by 32 m (b >= 5) renames registers (column j + 32 m is the
// lane's own register k + m, mod 20); a roll by s < 32 takes register k of
// lane l + s, or register k + 1 where l + s wraps past 31: the source lane
// picks which (lanes l < s feed a wrapped receiver) and one shuffle moves
// it. Every register index is a constant of the unrolled rep; the reps stay
// a loop.
template <int B>
__device__ __forceinline__ void compact_stage(float (&v)[kPerLane], float (&d)[kPerLane],
                                              int lane) {
  constexpr int sh = 1 << B;
  float rv[kPerLane], rd[kPerLane];  // the planes rolled left by sh
  if (B >= 5) {
    constexpr int m = (sh / 32) % kPerLane;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      rv[k] = v[(k + m) % kPerLane];
      rd[k] = d[(k + m) % kPerLane];
    }
  } else {
    const bool feeds_wrap = lane < sh;
    const int src = (lane + sh) & 31;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int k1 = (k + 1) % kPerLane;
      rv[k] = __shfl_sync(0xffffffffu, feeds_wrap ? v[k1] : v[k], src);
      rd[k] = __shfl_sync(0xffffffffu, feeds_wrap ? d[k1] : d[k], src);
    }
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (rd[k] > 0.5f) {  // predicated: no select for d
      v[k] = rv[k];
      d[k] = rd[k] - (float)sh;
    }
  }
}

__global__ void __launch_bounds__(kThreads) compact_kernel(
    const float* __restrict__ x, float* __restrict__ out, int32_t* __restrict__ cks,
    int rows, int reps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xg = x + (size_t)blockIdx.x * rows * kCols;
  float* og = out + (size_t)blockIdx.x * rows * 128;
  uint32_t bits = 0;
  for (int row = warp; row < rows; row += kWarps) {
    float v[kPerLane], d[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      v[k] = xg[(size_t)row * kCols + lane + 32 * k];
      d[k] = v[k] * 0.5f;
    }
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      compact_stage<0>(v, d, lane);
      compact_stage<1>(v, d, lane);
      compact_stage<2>(v, d, lane);
      compact_stage<3>(v, d, lane);
      compact_stage<4>(v, d, lane);
      compact_stage<5>(v, d, lane);
      compact_stage<6>(v, d, lane);
      compact_stage<7>(v, d, lane);
      compact_stage<8>(v, d, lane);
      compact_stage<9>(v, d, lane);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        v[k] = opaque(v[k]);
        d[k] = opaque(d[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < 128) {
        og[(size_t)row * 128 + j] = v[k];
      } else {
        bits += __float_as_uint(v[k]);
      }
    }
  }
  block_bitsum(bits, cks + blockIdx.x);
}

}  // namespace

// Each entry launches its case on `stream` with rep_stride 0 (every rep
// reads the same block), one block of 256 threads per grid step for M3 and
// M7, four for M2 (one a column tile), M4's and M5's flat grids of 16-byte
// vectors (128- and 512-thread blocks) and the fold's persistent grid, and
// returns cudaGetLastError() (0 = launched).

// M5 over x [G, n] (16-byte aligned), a vector a thread in one round;
// cudaErrorInvalidValue for a misaligned x or a grid past 2^31 - 1 blocks.
extern "C" int mosaic_tiny(const void* x, void* out, int G, int n, int reps, void* stream) {
  if (G < 0 || n < 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)G * n;
  const long long grid = ((total + 3) / 4 + kTinyThreads - 1) / kTinyThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  tiny_kernel<<<(unsigned)grid, kTinyThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, total, reps);
  return (int)cudaGetLastError();
}

// The fold's launch shape on the current device: ring stages, dynamic
// shared memory bytes, blocks an SM holds and SMs; returns 0 or a CUDA error.
extern "C" int mosaic_fold_shape(int* stages, int* smem, int* per_sm, int* sms) {
  *stages = kFoldStages;
  *smem = kFoldSmem;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFoldSmem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fold_kernel, kFoldThreads, kFoldSmem);
  return (int)cudaGetLastError();
}

// The fold over x [G, n] (16-byte aligned) with rows of `width` (a multiple
// of 128 dividing n) on min(chunks, SMs x blocks an SM) blocks; cks must be
// zeroed. cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int mosaic_fold(const void* x, void* out, void* cks, int G, int n, int width,
                           int reps, void* stream) {
  if (G < 0 || n <= 0 || width <= 0 || width % 128 || n % width ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  int stages, smem, per_sm, sms;
  const int err = mosaic_fold_shape(&stages, &smem, &per_sm, &sms);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long chunks = (long long)G * ((n + kFoldChunk - 1) / kFoldChunk);
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(chunks < most ? chunks : most);
  if (grid == 0) return 0;
  fold_kernel<<<grid, kFoldThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (int32_t*)cks, n, width, reps, 0, chunks);
  return (int)cudaGetLastError();
}

// Threads a block, dynamic shared memory bytes, blocks an SM holds and SMs
// of `kernel` on the current device; returns 0 or a CUDA error.
static int relayout_shape(const void* kernel, int block, int bytes, int* threads, int* smem,
                          int* per_sm, int* sms) {
  *threads = block;
  *smem = bytes;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, block, bytes);
  return (int)cudaGetLastError();
}

// M2's launch shape at `rows` and M4's, as relayout_shape gives them.
extern "C" int mosaic_transpose_shape(int rows, int* threads, int* smem, int* per_sm, int* sms) {
  return relayout_shape((const void*)transpose_kernel, kThreads, rows * kTrStride * 4, threads,
                        smem, per_sm, sms);
}

extern "C" int mosaic_rep_shape(int* threads, int* smem, int* per_sm, int* sms) {
  return relayout_shape((const void*)rep_kernel, kRepThreads, 0, threads, smem, per_sm, sms);
}

// M2 over x [G, rows, 128] (16-byte aligned), rows <= kTrMaxRows: four
// blocks a g; cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int mosaic_transpose(const void* x, void* out, int G, int rows, int reps,
                                void* stream) {
  if (G < 0 || rows <= 0 || rows > kTrMaxRows || reinterpret_cast<uintptr_t>(x) % 16 ||
      (long long)G * (128 / kTrCols) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  transpose_kernel<<<G * (128 / kTrCols), kThreads, rows * kTrStride * 4,
                     (cudaStream_t)stream>>>((const float*)x, (float*)out, rows, reps, 0);
  return (int)cudaGetLastError();
}

// M3's launch shape at `rows`, as relayout_shape gives it.
extern "C" int mosaic_droll_shape(int rows, int* threads, int* smem, int* per_sm, int* sms) {
  return relayout_shape((const void*)droll_kernel, kThreads, rows * 128 * 4, threads, smem,
                        per_sm, sms);
}

// M3 over x [G, rows, 128] (16-byte aligned; rows a multiple of kRollRows, at
// most kRollMaxRows) with nshift <= kRollMaxShifts shifts: a block a g;
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int mosaic_droll(const void* x, const void* shifts, void* out, int G, int rows,
                            int nshift, int reps, void* stream) {
  if (G < 0 || rows <= 0 || rows % kRollRows || rows > kRollMaxRows || nshift <= 0 ||
      nshift > kRollMaxShifts || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  droll_kernel<<<G, kThreads, rows * 128 * 4, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)shifts, (float*)out, rows, nshift, reps, 0);
  return (int)cudaGetLastError();
}

// M4 over x [G, n] (16-byte aligned, n a multiple of 128, G n / 4 < 2^31)
// with kRepCopies copies, a vector a thread in one round; cks must be zeroed.
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int mosaic_rep(const void* x, void* out, void* cks, int G, int n, int reps,
                          void* stream) {
  const long long vecs = (long long)G * (n / 4);
  if (G < 0 || n <= 0 || n % 128 || vecs > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (vecs == 0) return 0;
  rep_kernel<<<(int)((vecs + kRepThreads - 1) / kRepThreads), kRepThreads, 0,
               (cudaStream_t)stream>>>((const float4*)x, (float4*)out, (int32_t*)cks, n / 4,
                                       (int)vecs, reps, 0);
  return (int)cudaGetLastError();
}

extern "C" int mosaic_compact(const void* x, void* out, void* cks, int G, int rows, int reps,
                              void* stream) {
  compact_kernel<<<G, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (int32_t*)cks, rows, reps);
  return (int)cudaGetLastError();
}
