// Horn solves of the 3D-3D RANSAC estimator: the K hypotheses from their
// minimal-set moments, and the refit of the winner on its inliers.
//
// Replaces no TPU kernel. In the JAX package this is jnp code
// (solvers/absolute_orientation.py::horn_from_moments and the refit `scan`
// inside ransac/engine.py::estimate_pose_3d3d) that XLA fuses into a few
// loops. Eager PyTorch runs the same component-wise algebra as one small
// launch per line: ~1,000 launches for the hypotheses and ~3,600 for two
// refit rounds, which the host issues one by one while the card waits.
//
// What bounds it on this card: neither bytes nor operations. The hypotheses
// read 64 bytes and write 64 bytes each (4 MB at K = 32768, 1.3 us at the
// HBM peak) and do ~960 f32 operations each at iters = 4 (0.5 us at the f32
// peak); the refit reads N rows of 24 bytes a pass (48 KB at N = 2048).
// Both are bound by latency: the length of one problem's dependent chain of
// operations (three squarings, `iters` power steps, atan2/cos/sin), and in
// the refit two such chains on one thread.
//
// The design: one thread a problem, the whole eigen solve in its registers
// (horn.cuh), so a solve is one launch whatever its length.
// - horn_hypotheses_kernel: one thread a hypothesis, reading its column of
//   the (16, K) moments that minimal_moments_kernel wrote (neighbouring
//   threads read neighbouring words) and writing its (4, 4) pose as four
//   float4 stores. Blocks of 128 threads: 256 blocks at K = 32768.
// - horn_refit_3d3d_kernel: the whole refit in one block, so that no round
//   goes back to the host. Each round: the residuals under the current pose
//   and the hard-inlier mask r^2 < tau^2, a block reduction of the weight
//   sum and the weighted centroids, a second pass for the centred weighted
//   covariance (as horn_quaternion centres it), then one thread runs Horn
//   (12 power steps) while the others wait; with fewer than 3 inliers the
//   pose is kept. After the last round: the final mask, its count and
//   validity. The threads stride over the N rows, so any N works.

#include <cuda_runtime.h>

#include "horn.cuh"

namespace {

constexpr int kHypThreads = 128;
constexpr int kRefitThreads = 512;
constexpr int kRefitWarps = kRefitThreads / 32;
constexpr int kRefitIters = 12;

__global__ void __launch_bounds__(kHypThreads)
horn_hypotheses_kernel(const float* __restrict__ mom, float* __restrict__ out, int K,
                       int iters) {
  const int k = blockIdx.x * kHypThreads + threadIdx.x;
  if (k >= K) return;
  const size_t stride = static_cast<size_t>(K);
  float m[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m[r] = __ldg(mom + r * stride + k);
  // solvers/absolute_orientation.py::horn_from_moments: H_ab = Σ p_a q_b −
  // (Σ p_a)(Σ q_b) / n.
  const float inv = 1.f / horn::clamp_min(m[15], 1e-12f);
  const float cp[3] = {horn::mul(m[0], inv), horn::mul(m[1], inv), horn::mul(m[2], inv)};
  const float cq[3] = {horn::mul(m[3], inv), horn::mul(m[4], inv), horn::mul(m[5], inv)};
  float s[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      s[3 * a + b] = horn::sub(m[6 + 3 * a + b], horn::mul(horn::mul(m[a], m[3 + b]), inv));
    }
  }
  float T[12];
  horn::from_components(cp, cq, s, iters, T);
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(k) * 16);
  o[0] = make_float4(T[0], T[1], T[2], T[3]);
  o[1] = make_float4(T[4], T[5], T[6], T[7]);
  o[2] = make_float4(T[8], T[9], T[10], T[11]);
  o[3] = make_float4(0.f, 0.f, 0.f, 1.f);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sums v[] over the block; every thread gets the totals.
template <int kV>
__device__ __forceinline__ void block_sum(float (&v)[kV], float (*red)[kRefitWarps]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const float x = warp_sum(v[i]);
    if (lane == 0) red[i][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float x = warp_sum(lane < kRefitWarps ? red[i][lane] : 0.f);
      if (lane == 0) red[i][0] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kV; ++i) v[i] = red[i][0];
  __syncthreads();  // red is written again by the next reduction
}

// |R p + t − q|² of row i under the pose T (3x4 row-major).
__device__ __forceinline__ float residual2(const float* T, const float* __restrict__ p,
                                           const float* __restrict__ q, int i, float (&pi)[3],
                                           float (&qi)[3]) {
  float e = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pi[a] = __ldg(p + 3 * i + a);
    qi[a] = __ldg(q + 3 * i + a);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d =
        qi[a] - (pi[0] * T[4 * a] + pi[1] * T[4 * a + 1] + pi[2] * T[4 * a + 2] + T[4 * a + 3]);
    e += d * d;
  }
  return e;
}

__global__ void __launch_bounds__(kRefitThreads)
horn_refit_3d3d_kernel(const float* __restrict__ p, const float* __restrict__ q,
                       const float* __restrict__ T0, float* __restrict__ pose,
                       bool* __restrict__ mask, float* __restrict__ num,
                       bool* __restrict__ valid, int N, int rounds, float tau2,
                       int min_inliers) {
  __shared__ float T[16];
  __shared__ float red[9][kRefitWarps];
  __shared__ int count_by_warp[kRefitWarps];
  if (threadIdx.x < 16) T[threadIdx.x] = T0[threadIdx.x];
  __syncthreads();
  float pi[3], qi[3];
  for (int round = 0; round < rounds; ++round) {
    // The weight sum and the weighted sums of p and q on the hard inliers.
    // Every row enters with its weight 0 or 1, as in the plain version, so
    // that a NaN coordinate reaches the sums there and here alike.
    float s[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < N; i += kRefitThreads) {
      const float w = residual2(T, p, q, i, pi, qi) < tau2 ? 1.f : 0.f;
      s[0] += w;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s[1 + a] += w * pi[a];
        s[4 + a] += w * qi[a];
      }
    }
    block_sum(s, red);
    if (s[0] < 3.f) continue;  // fewer than 3 inliers: keep the pose (block-uniform)
    const float wsum = horn::clamp_min(s[0], 1e-12f);
    const float cp[3] = {s[1] / wsum, s[2] / wsum, s[3] / wsum};
    const float cq[3] = {s[4] / wsum, s[5] / wsum, s[6] / wsum};
    // Σ w (p − cp)(q − cq)ᵀ.
    float c[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < N; i += kRefitThreads) {
      const float w = residual2(T, p, q, i, pi, qi) < tau2 ? 1.f : 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float wpc = w * (pi[a] - cp[a]);
#pragma unroll
        for (int b = 0; b < 3; ++b) c[3 * a + b] += wpc * (qi[b] - cq[b]);
      }
    }
    block_sum(c, red);
    if (threadIdx.x == 0) {
      float Tn[12];
      horn::from_components(cp, cq, c, kRefitIters, Tn);
#pragma unroll
      for (int j = 0; j < 12; ++j) T[j] = Tn[j];
      T[12] = 0.f;
      T[13] = 0.f;
      T[14] = 0.f;
      T[15] = 1.f;
    }
    __syncthreads();
  }
  // The inliers of the final pose.
  int count = 0;
  for (int i = threadIdx.x; i < N; i += kRefitThreads) {
    const bool in = residual2(T, p, q, i, pi, qi) < tau2;
    mask[i] = in;
    count += in;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(0xffffffffu, count, o);
  if (threadIdx.x % 32 == 0) count_by_warp[threadIdx.x / 32] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kRefitWarps; ++w) total += count_by_warp[w];
    num[0] = static_cast<float>(total);
    valid[0] = total >= min_inliers;
  }
  if (threadIdx.x < 16) pose[threadIdx.x] = T[threadIdx.x];
}

}  // namespace

// mom (16, K) f32 as minimal_moments writes it; out (K, 4, 4) f32; both
// contiguous. K >= 1, iters >= 0.
extern "C" int rgbd_horn_hypotheses(const float* mom, float* out, int K, int iters,
                                    cudaStream_t stream) {
  const int blocks = (K + kHypThreads - 1) / kHypThreads;
  horn_hypotheses_kernel<<<blocks, kHypThreads, 0, stream>>>(mom, out, K, iters);
  return static_cast<int>(cudaGetLastError());
}

// p, q (N, 3) f32; T0 and pose (4, 4) f32; mask (N,) bool; num () f32;
// valid () bool; all contiguous. One block.
extern "C" int rgbd_horn_refit_3d3d(const float* p, const float* q, const float* T0,
                                    float* pose, bool* mask, float* num, bool* valid, int N,
                                    int rounds, float tau2, int min_inliers,
                                    cudaStream_t stream) {
  horn_refit_3d3d_kernel<<<1, kRefitThreads, 0, stream>>>(p, q, T0, pose, mask, num, valid, N,
                                                          rounds, tau2, min_inliers);
  return static_cast<int>(cudaGetLastError());
}
