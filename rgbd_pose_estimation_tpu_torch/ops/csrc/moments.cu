// Minimal-set moments for RANSAC hypothesis generation.
//
// Replaces the TPU kernel `_moments_kernel` of
// rgbd_pose_estimation_tpu/ops/moments.py (`minimal_moments`). That kernel
// is a one-hot (N, KT) selection matrix times bf16 hi/lo feature planes,
// a form chosen because the TPU's gather unit is slow. On Hopper the whole
// correspondence set (24 bytes a row, 48 KB at N = 2048) sits in L1/L2, so
// each hypothesis simply gathers its m rows and sums in f32.
//
// Bound on this card: bytes, 4*(m*K + 16*K) + 24*N, i.e. well under a
// microsecond at K = 32768: the kernel is bound by its launch. The design
// therefore only keeps the traffic coalesced where it is large: one thread
// per hypothesis, and the (16, K) output written row by row so that a
// warp's 32 stores are neighbours. The gathers go through the read-only
// cache.
//
// The products and sums are written with explicit round-to-nearest
// intrinsics, in the order j = 0..m-1, so that no multiply-add contraction
// makes the result differ from the plain PyTorch version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void minimal_moments_kernel(const int* __restrict__ idx,
                                       const float* __restrict__ p,
                                       const float* __restrict__ q,
                                       float* __restrict__ out,
                                       int K, int m, int N) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float sp[3] = {0.f, 0.f, 0.f};
  float sq[3] = {0.f, 0.f, 0.f};
  float so[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int* row = idx + static_cast<size_t>(k) * m;
  for (int j = 0; j < m; ++j) {
    // Clamped for memory safety only: indices are distinct rows < N by
    // the sampler's contract.
    const int i = min(max(row[j], 0), N - 1);
    float pa[3], qa[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pa[a] = __ldg(p + 3 * static_cast<size_t>(i) + a);
      qa[a] = __ldg(q + 3 * static_cast<size_t>(i) + a);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      sp[a] = __fadd_rn(sp[a], pa[a]);
      sq[a] = __fadd_rn(sq[a], qa[a]);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        so[a * 3 + b] = __fadd_rn(so[a * 3 + b], __fmul_rn(pa[a], qa[b]));
      }
    }
  }
  const size_t stride = static_cast<size_t>(K);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out[(0 + a) * stride + k] = sp[a];
    out[(3 + a) * stride + k] = sq[a];
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) out[(6 + c) * stride + k] = so[c];
  out[15 * stride + k] = static_cast<float>(m);
}

}  // namespace

// idx (K, m) int32, p and q (N, 3) f32, out (16, K) f32; all contiguous.
extern "C" int rgbd_minimal_moments(const int* idx, const float* p,
                                    const float* q, float* out, int K, int m,
                                    int N, cudaStream_t stream) {
  const int blocks = (K + kThreads - 1) / kThreads;
  minimal_moments_kernel<<<blocks, kThreads, 0, stream>>>(idx, p, q, out, K, m, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgbd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
