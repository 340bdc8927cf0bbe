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
// (__fmul_rn / __fadd_rn / __fsub_rn: no contraction into fused
// multiply-adds), acc is summed in iteration order, and every one of the
// R x N elements runs its own iterations (the rows of a column are equal,
// but the harness counts the work of all of them), so the plain PyTorch
// version gives the same bits and the count of operations is real.
//
// What bounds T4 on this card: at the harness's (8, 2048) x 64 the issue of
// its ~20 instructions an element and iteration (0.36 us of f32 work at the
// published peak, ~0.75 us of issue on 132 SMs) beside one launch: with
// `reps` read at run time, each iteration's constant loaded at the head of
// a chain of ~10 dependent operations, and blocks of 256 threads, it would
// run at the latency of one chain an iteration on half the SMs. The design:
//  - `reps` = 64 is compiled in (the generic instance stays for any other
//    count): the 64 residuals of an element are independent and only the
//    acc and cnt chains are serial, so a thread has the ILP to issue on
//    every cycle;
//  - the constants are read by 16-byte loads once a thread, from memory,
//    so the compiler folds none of them. It does not hold all 64 at once:
//    the compiled kernel has 32 registers and no spills, so it loads them
//    near their use (~20 SASS instructions an element and iteration);
//  - blocks of 128 threads spread the 16,384 elements over 128 SMs. An
//    element's iterations split over 4 or 8 lanes, which hand their clamped
//    values through shared memory to one lane that sums them in order, was
//    slower at (8, 2048) and at (8, 131072): more warps, but more
//    instructions for the hand-over.
//
// T6 replaces `_vpu_kernel` of tools/roofline.py (`ceiling_vpu`): a
// dependent chain of 256 fused multiply-adds a = a*s + b per element. With
// s = 1 - 2^-16 and b = 2^-16, a = 1 is a fixed point, so on an input of
// ones the kernel, its plain version and the TPU kernel all return exactly
// 1.0. s and b are arguments, which the compiler cannot fold. Bound:
// operations (2*256 an element at the f32 peak); one thread an element,
// enough warps to hide the chain's latency.
//
// Beside them, the floor of a launch: a kernel that does nothing, timed
// in the same run as the kernels whose time is mostly their launch (K1, K3's
// finalist re-score, K4). It replaces no TPU kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFmaReps = 256;
constexpr int kOpMixReps = 64;       // the harness's iterations, compiled in
constexpr int kOpMixThreads = 128;   // 128 blocks at (8, 2048): one a SM

// The squared residual of one iteration: c*px + c*py + c*pz + c, left to
// right, minus each coordinate, squared and summed; each operation rounded.
__device__ __forceinline__ float op_mix_residual(float c, float px, float py, float pz) {
  const float s = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(c, px), __fmul_rn(c, py)), __fmul_rn(c, pz)), c);
  const float ex = __fsub_rn(s, px);
  const float ey = __fsub_rn(s, py);
  const float ez = __fsub_rn(s, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
}

// min(e, tau2) that keeps NaN, as torch.clamp(e, max=tau2) does.
__device__ __forceinline__ float op_mix_clamp(float e, float tau2) { return e > tau2 ? tau2 : e; }

// One thread an element. kReps > 0: that many iterations, compiled in, the
// constants read as float4 (cs 16-byte aligned); kReps == 0: `reps` at run
// time, each constant read in its iteration.
template <int kReps>
__global__ void __launch_bounds__(kOpMixThreads)
op_mix_kernel(const float* __restrict__ x, const float* __restrict__ cs,
              float* __restrict__ out, int R, int N, int reps, float tau2) {
  const int i = blockIdx.x * kOpMixThreads + threadIdx.x;
  if (i >= R * N) return;
  const int n = i % N;
  const float px = x[n], py = x[N + n], pz = x[2 * N + n];
  float acc = 0.f, cnt = 0.f;
  if constexpr (kReps > 0) {
    float c[kReps];
#pragma unroll
    for (int r = 0; r < kReps; r += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(cs) + r / 4);
      c[r] = v.x;
      c[r + 1] = v.y;
      c[r + 2] = v.z;
      c[r + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < kReps; ++r) {
      const float e = op_mix_residual(c[r], px, py, pz);
      acc = __fadd_rn(acc, op_mix_clamp(e, tau2));
      cnt = __fadd_rn(cnt, e < tau2 ? 1.f : 0.f);
    }
  } else {
    for (int r = 0; r < reps; ++r) {
      const float e = op_mix_residual(__ldg(cs + r), px, py, pz);
      acc = __fadd_rn(acc, op_mix_clamp(e, tau2));
      cnt = __fadd_rn(cnt, e < tau2 ? 1.f : 0.f);
    }
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

// T4: x (R, N) f32, cs (reps,) f32 16-byte aligned, out (R, N) f32; all
// contiguous, R >= 3, reps >= 1.
extern "C" int rgbd_msac_op_mix_ceiling(const float* x, const float* cs,
                                        float* out, int R, int N, int reps,
                                        float tau2, cudaStream_t stream) {
  const int blocks = (R * N + kOpMixThreads - 1) / kOpMixThreads;
  if (reps == kOpMixReps) {
    op_mix_kernel<kOpMixReps><<<blocks, kOpMixThreads, 0, stream>>>(x, cs, out, R, N, reps, tau2);
  } else {
    op_mix_kernel<0><<<blocks, kOpMixThreads, 0, stream>>>(x, cs, out, R, N, reps, tau2);
  }
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
