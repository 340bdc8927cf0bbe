// Two arithmetic-ceiling probes: kernels whose time says what this card's
// CUDA cores issue, with no memory traffic worth counting.
//
// T4 replaces the TPU kernel `_kernel_E` of tools/msac_opt.py
// (`variant_E_ceiling`): the exact MSAC scorer's op mix (three residual
// components from three multiplies and four adds or subtracts each, a sum
// of squares, a clamp and a count) on register-resident values, with no
// reduction across threads. Input x (R, N), R >= 3; every element (r, n)
// takes rows 0-2 of column n as (px, py, pz) and runs `reps` iterations with
// the constants cs[i] = f32(1 + 1e-6 i), which the wrapper passes in memory
// so that the compiler can fold nothing; the output is acc + cnt, (R, N),
// as the TPU kernel's. Every operation is rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into fused multiply-adds), so the
// plain PyTorch version gives the same bits.
//
// T6 replaces `_vpu_kernel` of tools/roofline.py (`ceiling_vpu`): a
// dependent chain of 256 fused multiply-adds a = a*s + b per element. With
// s = 1 - 2^-16 and b = 2^-16, a = 1 is a fixed point, so on an input of
// ones the kernel, its plain version and the TPU kernel all return exactly
// 1.0. s and b are arguments, which the compiler cannot fold.
//
// Beside them, the floor of a launch: a kernel that does nothing, timed
// in the same run as the kernels whose time is mostly their launch (K3's
// finalist re-score). It replaces no TPU kernel.
//
// Bound on this card: operations, both (T4: 23 flops an element and
// iteration by the TPU tool's accounting; T6: 2*256 an element) at the f32
// peak. One thread an element: enough warps to hide the chains' latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFmaReps = 256;

__global__ void __launch_bounds__(kThreads)
op_mix_kernel(const float* __restrict__ x, const float* __restrict__ cs,
              float* __restrict__ out, int R, int N, int reps, float tau2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R * N) return;
  const int n = i % N;
  const float px = x[n], py = x[N + n], pz = x[2 * N + n];
  float acc = 0.f, cnt = 0.f;
  for (int r = 0; r < reps; ++r) {
    const float c = __ldg(cs + r);
    // c*px + c*py + c*pz + c, left to right, each operation rounded
    const float s = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(c, px), __fmul_rn(c, py)), __fmul_rn(c, pz)), c);
    const float ex = __fsub_rn(s, px);
    const float ey = __fsub_rn(s, py);
    const float ez = __fsub_rn(s, pz);
    const float e = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
    acc = __fadd_rn(acc, e > tau2 ? tau2 : e);
    cnt = __fadd_rn(cnt, e < tau2 ? 1.f : 0.f);
  }
  out[i] = __fadd_rn(acc, cnt);
}

__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 float s, float b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
#pragma unroll
  for (int r = 0; r < kFmaReps; ++r) a = __fmaf_rn(a, s, b);
  out[i] = a;
}

__global__ void empty_kernel() {}

}  // namespace

// T4: x (R, N) f32, cs (reps,) f32, out (R, N) f32; all contiguous, R >= 3.
extern "C" int rgbd_msac_op_mix_ceiling(const float* x, const float* cs,
                                        float* out, int R, int N, int reps,
                                        float tau2, cudaStream_t stream) {
  const int blocks = (R * N + kThreads - 1) / kThreads;
  op_mix_kernel<<<blocks, kThreads, 0, stream>>>(x, cs, out, R, N, reps, tau2);
  return static_cast<int>(cudaGetLastError());
}

// T6: x and out n f32 each, contiguous; 256 chained a = fma(a, s, b).
extern "C" int rgbd_fma_chain_ceiling(const float* x, float* out, int n,
                                      float s, float b, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  fma_chain_kernel<<<blocks, kThreads, 0, stream>>>(x, out, n, s, b);
  return static_cast<int>(cudaGetLastError());
}

// blocks blocks of kThreads threads that do nothing.
extern "C" int rgbd_empty_kernel(int blocks, cudaStream_t stream) {
  empty_kernel<<<blocks, kThreads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
