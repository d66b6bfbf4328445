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
// Design: one thread per batch column, 32 columns per block, so a warp's
// loads of one time step are one coalesced 128-byte line and B=4080 spreads
// over 128 blocks. Only the multiply-add chain is serial: each thread loads
// the next PREFETCH steps of x and decay (and y) into registers before it
// runs them, so that many loads are in flight while the chain runs. Any T
// and any B (no 128-lane rule). The multiply and the add round separately
// (__fmul_rn, __fadd_rn, no FMA contraction), as the plain version's two
// torch ops do, so the kernel equals it bit for bit.
//
// What bounds it: bytes. At the learner's [255, 4080] it reads 8.3 MB and
// writes 4.2 MB (0.0037 ms at 3.35 TB/s); a thread's T dependent steps and
// the load latency of each prefetch window set its time at these sizes, and
// at the minibatch's [255, 60] the launch does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kPrefetch = 16;

__global__ void discounted_sum_kernel(
    const float* __restrict__ x,       // [T, B]
    const float* __restrict__ decay,   // [T, B]
    float* __restrict__ out,           // [T, B]
    const float* __restrict__ y,       // [T, B] or null: forward output, for gdecay
    float* __restrict__ gdecay,        // [T, B] or null
    int T, int B, int forward_in_time) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t stride = (size_t)B;
  float run = 0.0f;
  float d_prev = 0.0f;  // forward in time: decay of the previous step
  for (int s0 = 0; s0 < T; s0 += kPrefetch) {
    float xv[kPrefetch], dv[kPrefetch], yv[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int s = s0 + j;
      xv[j] = dv[j] = yv[j] = 0.0f;
      if (s < T) {
        const int t = forward_in_time ? s : T - 1 - s;
        xv[j] = x[t * stride + b];
        dv[j] = decay[t * stride + b];
        if (gdecay != nullptr && t + 1 < T) yv[j] = y[(t + 1) * stride + b];
      }
    }
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int s = s0 + j;
      if (s < T) {
        const int t = forward_in_time ? s : T - 1 - s;
        const float d = forward_in_time ? d_prev : dv[j];
        run = __fadd_rn(xv[j], __fmul_rn(d, run));
        out[t * stride + b] = run;
        if (forward_in_time) {
          d_prev = dv[j];
          if (gdecay != nullptr) gdecay[t * stride + b] = __fmul_rn(run, yv[j]);
        }
      }
    }
  }
}

}  // namespace

// Launches the scan on `stream`; returns cudaGetLastError() (0 = launched).
// `y` and `gdecay` are both null or both set, and only forward in time.
extern "C" int discounted_sum_launch(const float* x, const float* decay, float* out,
                                     const float* y, float* gdecay, int T, int B,
                                     int forward_in_time, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  discounted_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, decay, out, y, gdecay, T, B, forward_in_time);
  return (int)cudaGetLastError();
}
