// Discounted sum over time for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces metta_tpu/ops/discounted_sum.py:_kernel (the Pallas TPU kernel
// behind discounted_sum_reverse). Over time-major [T, B] float32 arrays:
//
//   reverse in time (the forward pass):
//     out[t] = x[t] + decay[t] * out[t+1],     t = T-1 .. 0, out[T] = 0
//   forward in time (its gradient, x = the output's gradient g):
//     out[t] = x[t] + decay[t-1] * out[t-1],   t = 0 .. T-1, out[-1] = 0
//     and, where `y` (the forward pass's output) and `gdecay` are given,
//     gdecay[t] = out[t] * y[t+1], with y[T] = 0.
//
// The plain torch version is metta_tpu_torch/ops/discounted_sum.py:
// discounted_sum_plain; autograd through it gives the same gradient.
//
// What bounds it: bytes on paper (at the learner's [255, 4080] it reads 8.3
// MB and writes 4.2 MB, 0.0037 ms at 3.35 TB/s), and below that the serial
// chain: each column is one chain of T dependent multiply-then-add pairs,
// which must stay in the plain version's order to stay bit-equal to it (no
// chunked or tree scan, which would reassociate the sums); 255 pairs take
// about 2,200 cycles. At the minibatch's [255, 60] the chain and the load
// latency are all there is. The first design ran one thread a column and
// waited a whole load latency every 16 steps.
//
// Design: a block owns a tile of C columns (8, 16 or 32, a template
// parameter picked by the wrapper from B so that the grid covers the SMs
// where B allows; see ops/discounted_sum.py:scan_plan) and walks T in
// chunks of kChunk steps. Eight loader warps bring whole chunks of x, decay
// (and y) into a ring of shared-memory stages with 4-byte cp.async copies
// (neighbouring lanes read neighbouring columns of a row, so any B works),
// each arriving on its stage's `full` mbarrier as it lands. A stage holds
// each array transposed, a column's kChunk steps contiguous (kStride floats
// a column: the pad keeps 16-byte loads aligned and free of bank
// conflicts). Up to kMaxStages chunks are in flight at once, so one load
// latency covers them all (at T <= 256 the whole column tile). One warp,
// lane = column, runs the chain from shared memory, stage after stage as
// they fill: it reads a chunk's steps in 16-byte loads (four steps each),
// runs them, writes the outputs (and gdecay) back to the stage the same
// way, and releases the stage on its `empty` mbarrier; the loaders then
// store the outputs in coalesced rows and refill the stage with a later
// chunk. The chain's code has no branch per step (a single warp has
// nothing to hide a branch behind): rows past a short chunk's end become
// the identity step (x = -0, d = 1, which leaves the running sum bit for
// bit) and are never stored. The multiply and the add round separately
// (__fmul_rn, __fadd_rn, no FMA contraction), as the plain version's two
// torch ops do, so the kernel equals it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;                  // time steps a stage holds
constexpr int kStride = 36;                 // floats a column takes in a stage array
constexpr int kMaxStages = 8;               // stages of the ring
constexpr int kLoaders = 8;                 // loader warps
constexpr int kThreads = 32 * (1 + kLoaders);
constexpr int kMinCols = 8;                 // columns of a tile: 8, 16 or 32
constexpr int kMaxCols = 32;

// The floats of one stage: x, decay[, y], out[, gdecay], each [C, kStride].
__host__ __device__ constexpr int stage_floats(int C, bool gd) {
  return (gd ? 5 : 3) * C * kStride;
}
// Dynamic shared memory: the barriers (a full and an empty one a stage, 16
// bytes in all), then the stages.
size_t smem_bytes(int C, int stages, bool gd) {
  return (size_t)16 * stages + (size_t)4 * stages * stage_floats(C, gd);
}

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

// Arrives on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Copies one float from global `src` to shared `dst` (`bytes` 0: zero fill).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// The steps [lo, lo + rows) of chunk i: from T down in reverse time, from 0 up forward.
template <bool kFwd>
__device__ __forceinline__ void chunk_span(int i, int T, int& lo, int& rows) {
  if constexpr (kFwd) {
    lo = i * kChunk;
    rows = min(kChunk, T - lo);
  } else {
    const int hi = T - i * kChunk;
    lo = max(0, hi - kChunk);
    rows = hi - lo;
  }
}

// A column's kChunk steps from a stage array, in 16-byte loads.
__device__ __forceinline__ void load_column(const float* src, float (&v)[kChunk]) {
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(src + 4 * q);
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

__device__ __forceinline__ void store_column(float* dst, const float (&v)[kChunk]) {
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q)
    *reinterpret_cast<float4*>(dst + 4 * q) =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <bool kFwd, bool kGd, int C>
__global__ void __launch_bounds__(kThreads) discounted_sum_kernel(
    const float* __restrict__ x,       // [T, B]
    const float* __restrict__ decay,   // [T, B]
    float* __restrict__ out,           // [T, B]
    const float* __restrict__ y,       // [T, B], kGd only: forward output, for gdecay
    float* __restrict__ gdecay,        // [T, B], kGd only
    int T, int B, int NS) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int tile = C * kStride;                    // floats of one array in a stage
  constexpr int sfl = stage_floats(C, kGd);
  constexpr int kOut = kGd ? 3 : 2;                    // out's array in a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  float* ring = reinterpret_cast<float*>(smem + 16 * NS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * C;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 32 * kLoaders);              // each loader thread's copies
      mbar_init(empty + s, 1);                         // the chain warp, once it is done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // the chain: lane = column, in the plain version's order
    float run = 0.0f, d_prev = 0.0f;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % NS;
      int lo, rows;
      chunk_span<kFwd>(i, T, lo, rows);
      mbar_wait(full + s, (uint32_t)(i / NS) & 1u);
      float* st = ring + s * sfl + lane * kStride;    // this column in the stage's arrays
      if (lane < C) {
        float xv[kChunk], dv[kChunk], yv[kChunk];
        load_column(st, xv);
        load_column(st + tile, dv);
        if constexpr (kGd) load_column(st + 2 * tile, yv);
        if (rows < kChunk) {                           // rows past the chunk: identity steps
#pragma unroll
          for (int r = 0; r < kChunk; ++r) {
            xv[r] = r < rows ? xv[r] : -0.0f;
            dv[r] = r < rows ? dv[r] : 1.0f;
          }
        }
        if constexpr (!kFwd) {
#pragma unroll
          for (int r = kChunk - 1; r >= 0; --r) {
            run = __fadd_rn(xv[r], __fmul_rn(dv[r], run));
            xv[r] = run;
          }
        } else {
#pragma unroll
          for (int r = 0; r < kChunk; ++r) {
            run = __fadd_rn(xv[r], __fmul_rn(d_prev, run));
            d_prev = dv[r];
            xv[r] = run;
            if constexpr (kGd) yv[r] = __fmul_rn(run, yv[r]);
          }
        }
        store_column(st + kOut * tile, xv);
        if constexpr (kGd) store_column(st + (kOut + 1) * tile, yv);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    return;
  }

  // the loaders: fill stage i % NS with chunk i once the chain has released
  // chunk i - NS from it, whose outputs they store first. Loader thread lt
  // keeps column lt % C and takes rows lt / C, lt / C + kRowStep, ... of a
  // chunk, so neighbouring threads take neighbouring columns of a row.
  constexpr int kRowStep = 32 * kLoaders / C;
  const int lt = threadIdx.x - 32;
  const int c = lt % C, r0 = lt / C;
  const bool in = c < min(C, B - c0);                  // columns past B: zero fill, no store
  const size_t step = (size_t)kRowStep * B;
  for (int i = 0; i < n_chunks + NS; ++i) {
    const int s = i % NS;
    float* sc = ring + s * sfl + c * kStride;          // column c in the stage's arrays
    if (i >= NS) {
      int lo, rows;
      chunk_span<kFwd>(i - NS, T, lo, rows);
      mbar_wait(empty + s, (uint32_t)(i / NS - 1) & 1u);
      if (in) {
        size_t g = (size_t)(lo + r0) * B + c0 + c;
        for (int r = r0; r < rows; r += kRowStep, g += step) {
          out[g] = sc[kOut * tile + r];
          if constexpr (kGd) gdecay[g] = sc[(kOut + 1) * tile + r];
        }
      }
    }
    if (i < n_chunks) {
      int lo, rows;
      chunk_span<kFwd>(i, T, lo, rows);
      const size_t g0 = (size_t)(lo + r0) * B + c0 + c;
      for (int r = r0, k = 0; r < rows; r += kRowStep, ++k) {
        const size_t g = in ? g0 + k * step : 0;
        cp_async4(sc + r, x + g, in ? 4 : 0);
        cp_async4(sc + tile + r, decay + g, in ? 4 : 0);
        if constexpr (kGd) {                           // y one step later; y[T] = 0
          const bool yin = in && lo + r + 1 < T;
          cp_async4(sc + 2 * tile + r, y + (yin ? g + B : 0), yin ? 4 : 0);
        }
      }
      cp_async_arrive(full + s);
    }
  }
}

template <bool kFwd, bool kGd, int C>
int launch(const float* x, const float* decay, float* out, const float* y, float* gdecay,
           int T, int B, int NS, cudaStream_t stream) {
  auto kernel = discounted_sum_kernel<kFwd, kGd, C>;
  const size_t smem = smem_bytes(C, NS, kGd);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + C - 1) / C;
  kernel<<<blocks, kThreads, smem, stream>>>(x, decay, out, y, gdecay, T, B, NS);
  return (int)cudaGetLastError();
}

template <bool kFwd, bool kGd>
int launch_cols(const float* x, const float* decay, float* out, const float* y, float* gdecay,
                int T, int B, int C, int NS, cudaStream_t stream) {
  if (C == kMinCols) return launch<kFwd, kGd, kMinCols>(x, decay, out, y, gdecay, T, B, NS, stream);
  if (C == 16) return launch<kFwd, kGd, 16>(x, decay, out, y, gdecay, T, B, NS, stream);
  return launch<kFwd, kGd, kMaxCols>(x, decay, out, y, gdecay, T, B, NS, stream);
}

template <bool kFwd, bool kGd, int C>
int shape_of(int NS, int* smem, int* per_sm) {
  auto kernel = discounted_sum_kernel<kFwd, kGd, C>;
  *smem = (int)smem_bytes(C, NS, kGd);
  if (*smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, *smem);
}

template <bool kFwd, bool kGd>
int shape_cols(int C, int NS, int* smem, int* per_sm) {
  if (C == kMinCols) return shape_of<kFwd, kGd, kMinCols>(NS, smem, per_sm);
  if (C == 16) return shape_of<kFwd, kGd, 16>(NS, smem, per_sm);
  return shape_of<kFwd, kGd, kMaxCols>(NS, smem, per_sm);
}

bool valid_plan(int cols, int stages) {
  return (cols == kMinCols || cols == 16 || cols == kMaxCols) && stages >= 1 &&
         stages <= kMaxStages;
}

}  // namespace

// The launch shape of a plan (`cols`, `stages`) of one direction, with or
// without gdecay: dynamic shared memory bytes, blocks an SM holds and the
// SMs of the current device; returns 0 or a CUDA error.
extern "C" int discounted_sum_shape(int forward_in_time, int gdecay, int cols, int stages,
                                    int* smem, int* per_sm, int* sms) {
  if (!valid_plan(cols, stages)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!forward_in_time) return shape_cols<false, false>(cols, stages, smem, per_sm);
  if (gdecay) return shape_cols<true, true>(cols, stages, smem, per_sm);
  return shape_cols<true, false>(cols, stages, smem, per_sm);
}

// Launches the scan on `stream` with tiles of `cols` columns and a ring of
// `stages` stages (ops/discounted_sum.py:scan_plan); returns
// cudaGetLastError() (0 = launched), cudaErrorInvalidValue for a plan the
// kernel does not take. `y` and `gdecay` are both null or both set, and only
// forward in time.
extern "C" int discounted_sum_launch(const float* x, const float* decay, float* out,
                                     const float* y, float* gdecay, int T, int B,
                                     int forward_in_time, int cols, int stages, void* stream) {
  const bool gd = gdecay != nullptr;
  if (T < 1 || B < 1 || !valid_plan(cols, stages) || stages > (T + kChunk - 1) / kChunk ||
      (gd && (y == nullptr || !forward_in_time)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!forward_in_time)
    return launch_cols<false, false>(x, decay, out, y, gdecay, T, B, cols, stages, s);
  if (gd) return launch_cols<true, true>(x, decay, out, y, gdecay, T, B, cols, stages, s);
  return launch_cols<true, false>(x, decay, out, y, gdecay, T, B, cols, stages, s);
}
