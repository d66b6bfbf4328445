// S1's GEMM cases (M6a, M6b, M6c) for Hopper (sm_90a): TMA into a ring of
// shared-memory stages, consumed by wgmma. Plain C interface for ctypes.
//
// Replaces the Pallas TPU GEMM cases of scripts/ubench_mosaic.py (k_loop_gemm
// and k_bd_gemm, pallas_call at :170, :190 and :206): out[g] = (sum over e < nE
// of a[g, e] @ b[g, e])[:128] in f32 and cks[g, t] = the f32 sum of row
// tile t of that sum, for a: [B, nE, F, Kd] and b: [B, nE, Kd, 128] bf16
// row-major (F a multiple of 128, Kd of 8). The plain torch version is
// metta_tpu_torch/ops/ubench_mosaic.py:_gemm_plain; the block schedule and
// the depth's boxes are mirrored there (gemm_schedule, gemm_boxes), where the
// CPU tests check them.
//
// What bounds it: memory. At depth 72-288 and N = 128 a GEMM does 128 FLOPs
// per byte of A, under the card's ridge of about 295, so A's bytes at
// 3.35 TB/s set the time; M6a's tensor work (64 GFLOP at the padded depth 80)
// is still half of its byte time, so loads and products must overlap.
//
// Design: a persistent grid of one block per SM. Block i takes the
// (g, 128-row tile) pairs [i * P / nb, (i + 1) * P / nb) of the P pairs in
// g-major order, so it walks consecutive tiles of one g and loads that g's
// B once. Warp 8 is the producer: its lane 0 keeps TMA loads of A's boxes
// (128 rows x 64, 32 or 16 columns) in flight into a ring of up to eight
// 16 KB stages, each with a full and an empty mbarrier, and loads B whole
// (nE x Kd x 128, <= 80 KB) behind its own pair of barriers when g changes.
// Warps 0-7 are two consumer warpgroups, rows 0-63 and 64-127 of the tile:
// each runs wgmma m64n128k16 (bf16 in, f32 accumulation in 64 registers a
// thread) over nE and the depth, one commit group a box, keeping one group
// in flight and releasing a stage when its group has completed. The epilogue
// (the tile's sum for cks; rows 0-127 of tile 0 to out) runs while the
// producer already loads the next tile.
//
// The depth is covered by boxes whose rows fit a swizzle span: 64 columns
// with the 128-byte swizzle, then a 32-column box (64-byte swizzle) and/or
// a 16-column box (32-byte swizzle); a box that runs past Kd is zero-filled
// by TMA (M6a's 72 becomes 64 + 16 = 80, not 128). A is K-major: its wgmma
// descriptor takes the box's swizzle, the 8-row group stride as SBO, and
// advances 32 bytes per k16 step inside a box. B is [Kd, 128] row-major,
// N-major for wgmma (the transpose bit): it is loaded in boxes of 16 depth
// rows x 64 columns with the 128-byte swizzle (a 3D map, so that rows past
// Kd are zero-filled, never the next matrix's), half h of N at h * kpad *
// 128 bytes (the descriptor's LBO), 8-row groups 1024 bytes apart (SBO).
//
// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is looked
// up at run time (dlopen), so the library links nothing but the runtime. The
// tensor maps are built on the host in mosaic_gemm and passed as
// __grid_constant__ kernel parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxBoxes = 9;             // 7 of 64 columns, then 32 + 16
constexpr int kStageBytes = 16384;         // one 128 x 64 bf16 box
constexpr int kMaxStages = 8;
constexpr int kBBoxRows = 16;              // B box: 16 depth rows x 64 columns
constexpr int kBBoxBytes = kBBoxRows * 128;
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block may opt into

struct Plan {
  int n;                  // boxes over the depth
  int kpad;               // the depth they cover, a multiple of 16
  int col[kMaxBoxes];     // first column of each
  int width[kMaxBoxes];   // 64, 32 or 16 columns
};

// The depth's boxes (mirrored by ops/ubench_mosaic.py:gemm_boxes): 64-wide
// boxes while 64 columns are left, then the rest r: 16 for r <= 16, 32 for
// r <= 32, 32 + 16 for r <= 48, else 64. Zero fill stays under 16 columns,
// past Kd only. A depth over kMaxDepth gets no boxes (n = 0).
constexpr int kMaxDepth = 512;
Plan make_plan(int Kd) {
  Plan p{};
  if (Kd <= 0 || Kd > kMaxDepth) return p;
  int c = 0;
  auto add = [&](int w) { p.col[p.n] = c; p.width[p.n] = w; ++p.n; c += w; };
  while (Kd - c >= 64) add(64);
  const int r = Kd - c;
  if (r > 48) {
    add(64);
  } else if (r > 32) {
    add(32);
    add(16);
  } else if (r > 16) {
    add(32);
  } else if (r > 0) {
    add(16);
  }
  p.kpad = c;
  return p;
}

__host__ __device__ size_t b_bytes(int nE, int kpad) { return (size_t)nE * kpad * 256; }

// Dynamic shared memory: alignment slack, the ring, B, the barriers, the warp sums.
size_t smem_bytes(int nE, int kpad, int stages) {
  return 1024 + (size_t)stages * kStageBytes + b_bytes(nE, kpad) + 8 * (2 * stages + 2) + 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete (the spin stays
// inside the asm, so the compiler sees no divergent loop around the wgmmas).
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

// Arrives on `bar` where `pred` holds (a predicated instruction: no branch
// around it, so the consumers' path stays convergent for wgmma).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"((uint32_t)pred)
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ uint32_t swizzle_of(int width) {  // a box's row of 2*width bytes
  return width == 64 ? 1u : (width == 32 ? 2u : 3u);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major, from da) x B (16 x 128, N-major, from db).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 1) gemm_tma_kernel(
    const __grid_constant__ CUtensorMap ta64, const __grid_constant__ CUtensorMap ta32,
    const __grid_constant__ CUtensorMap ta16, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ Plan plan, float* __restrict__ out, float* __restrict__ cks, int nE,
    int tiles, long long pairs, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ring = base;
  uint8_t* sB = ring + (size_t)stages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + b_bytes(nE, plan.kpad));
  uint64_t* empty = full + stages;
  uint64_t* bfull = empty + stages;
  uint64_t* bempty = bfull + 1;
  float* wsum = reinterpret_cast<float*>(bempty + 1);  // [2][8]

  // the warp index through a shuffle, so the compiler knows it is uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init(bfull, 1);
    mbar_init(bempty, kConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const long long begin = pairs * blockIdx.x / gridDim.x;
  const long long end = pairs * (blockIdx.x + 1) / gridDim.x;

  if (warp == kConsumers / 32) {
    // ---- producer: lane 0 issues every TMA load of this block ----
    if (lane != 0) return;
    int stage = 0, cur_g = -1;
    uint32_t phase = 0, nload = 0;
    for (long long p = begin; p < end; ++p) {
      const int g = (int)(p / tiles), tile = (int)(p % tiles);
      if (g != cur_g) {
        if (nload > 0) mbar_wait(bempty, (nload - 1) & 1);  // the last g's products are done
        mbar_expect(bfull, (uint32_t)b_bytes(nE, plan.kpad));
        for (int e = 0; e < nE; ++e)
          for (int h = 0; h < 2; ++h)
            for (int k = 0; k < plan.kpad; k += kBBoxRows)
              tma_3d(sB + ((size_t)(e * 2 + h) * plan.kpad + k) * 128, &tb, h * 64, k,
                     g * nE + e, bfull);
        cur_g = g;
        ++nload;
      }
      for (int e = 0; e < nE; ++e) {
        const int row = ((g * nE + e) * (tiles * 128)) + tile * 128;
        for (int j = 0; j < plan.n; ++j) {
          const int w = plan.width[j];
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect(full + stage, 128 * w * 2);
          const CUtensorMap* map = w == 64 ? &ta64 : (w == 32 ? &ta32 : &ta16);
          tma_2d(ring + (size_t)stage * kStageBytes, map, plan.col[j], row, full + stage);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of each tile ----
  const int wg = warp >> 2;
  int stage = 0, cur_g = -1, par = 0;
  uint32_t phase = 0, nload = 0;
  float acc[64];
  for (long long p = begin; p < end; ++p) {
    const int g = (int)(p / tiles), tile = (int)(p % tiles);
    if (g != cur_g) {
      mbar_wait(bfull, nload & 1);
      ++nload;
      cur_g = g;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    int prev = -1;
    for (int e = 0; e < nE; ++e) {
      const uint32_t b_e = smem_u32(sB + (size_t)e * 2 * plan.kpad * 128);
      for (int j = 0; j < plan.n; ++j) {
        const int w = plan.width[j];
        mbar_wait(full + stage, phase);
        const uint32_t a_wg = smem_u32(ring + (size_t)stage * kStageBytes) + wg * 64 * w * 2;
        const uint32_t swz = swizzle_of(w);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        for (int kk = 0; kk < w / 16; ++kk) {
          const uint64_t da = gmma_desc(a_wg + kk * 32, 16, 8 * w * 2, swz);
          const int ks = plan.col[j] / 16 + kk;  // k16 step over the depth
          const uint64_t db = gmma_desc(b_e + ks * kBBoxBytes, plan.kpad * 128, 1024, 1);
          wgmma_m64n128k16(acc, da, db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(acc);
        if (prev >= 0) mbar_arrive_if(empty + prev, lane == 0);  // its group has completed
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    mbar_arrive_if(empty + prev, lane == 0);
    if (p + 1 == end || (p + 1) / tiles != g) mbar_arrive_if(bempty, lane == 0);  // g's B is free

    // epilogue: the tile's sum, and rows 0-127 of tile 0
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s += acc[i];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) wsum[par * 8 + warp] = s;
    if (tile == 0) {
      const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);
      float* o = out + (size_t)g * 128 * 128 + (size_t)r * 128 + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[4 * n], acc[4 * n + 1]);
        *reinterpret_cast<float2*>(o + 8 * 128 + 8 * n) =
            make_float2(acc[4 * n + 2], acc[4 * n + 3]);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (threadIdx.x == 0) {
      float t = 0.0f;
      for (int w8 = 0; w8 < 8; ++w8) t += wsum[par * 8 + w8];
      cks[(size_t)g * tiles + tile] = t;
    }
    par ^= 1;
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                   strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int stages_for(int nE, int kpad) {  // as many as fit, up to kMaxStages
  int s = kMaxStages;
  while (s > 0 && smem_bytes(nE, kpad, s) > kSmemLimit) --s;
  return s;
}

}  // namespace

// The depth's boxes for Kd: writes their first columns and widths, returns
// their count (the C side of ops/ubench_mosaic.py:gemm_boxes).
extern "C" int ubench_gemm_plan(int Kd, int* col, int* width) {
  const Plan p = make_plan(Kd);
  for (int j = 0; j < p.n; ++j) {
    col[j] = p.col[j];
    width[j] = p.width[j];
  }
  return p.n;
}

// The launch shape for (nE, Kd): ring stages, dynamic shared memory bytes,
// blocks an SM can hold and the SMs of the current device; 0 or a CUDA error.
extern "C" int ubench_gemm_shape(int nE, int Kd, int* stages, int* smem, int* per_sm,
                                 int* sms) {
  const Plan p = make_plan(Kd);
  *stages = stages_for(nE, p.kpad);
  *smem = (int)smem_bytes(nE, p.kpad, *stages);
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(gemm_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gemm_tma_kernel, kThreads, *smem);
  return (int)cudaGetLastError();
}

// Launches the GEMM on `stream`; returns 0 or a CUDA error
// (cudaErrorInvalidValue for a shape the kernel does not take, or when the
// tensor maps cannot be built).
extern "C" int mosaic_gemm(const void* a, const void* b, void* out, void* cks, int B, int nE,
                           int F, int Kd, void* stream) {
  if (B <= 0 || nE <= 0 || F <= 0 || Kd <= 0 || Kd > kMaxDepth || F % 128 || Kd % 8 ||
      encoder() == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(Kd);
  int stages, smem, per_sm, sms;
  int err = ubench_gemm_shape(nE, Kd, &stages, &smem, &per_sm, &sms);
  if (err != 0) return err;
  if (stages < 2 || per_sm < 1) return (int)cudaErrorInvalidValue;

  CUtensorMap ta[3], tb;
  const cuuint64_t a_dims[2] = {(cuuint64_t)Kd, (cuuint64_t)B * nE * F};
  const cuuint64_t a_strides[1] = {(cuuint64_t)Kd * 2};
  const int widths[3] = {64, 32, 16};
  const CUtensorMapSwizzle swizzles[3] = {CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_SWIZZLE_64B,
                                          CU_TENSOR_MAP_SWIZZLE_32B};
  for (int i = 0; i < 3; ++i) {
    const cuuint32_t box[2] = {(cuuint32_t)widths[i], 128};
    if (!encode(&ta[i], a, 2, a_dims, a_strides, box, swizzles[i]))
      return (int)cudaErrorInvalidValue;
  }
  const cuuint64_t b_dims[3] = {128, (cuuint64_t)Kd, (cuuint64_t)B * nE};
  const cuuint64_t b_strides[2] = {256, (cuuint64_t)Kd * 256};
  const cuuint32_t b_box[3] = {64, kBBoxRows, 1};
  if (!encode(&tb, b, 3, b_dims, b_strides, b_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;

  const int tiles = F / 128;
  const long long pairs = (long long)B * tiles;
  const long long grid = pairs < (long long)sms * per_sm ? pairs : (long long)sms * per_sm;
  gemm_tma_kernel<<<(int)grid, kThreads, smem, (cudaStream_t)stream>>>(
      ta[0], ta[1], ta[2], tb, plan, (float*)out, (float*)cks, nE, tiles, pairs, stages);
  return (int)cudaGetLastError();
}
