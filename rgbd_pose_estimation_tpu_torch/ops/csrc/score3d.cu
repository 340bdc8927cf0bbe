// Exact f32 MSAC scoring of K poses against N 3D-3D correspondences.
//
// Replaces the TPU kernel `_score3d_kernel` of
// rgbd_pose_estimation_tpu/ops/ransac_score.py (`score_poses_3d3d`): per
// pose k, sum_n min(|R_k p_n + t_k - q_n|^2, tau^2) and the inlier count
// sum_n [e < tau^2]. True f32 on the CUDA cores: no TF32, no bf16.
//
// Bound on this card: operations, 23*K*N f32 (the bytes, 4*(14*K + 6*N),
// are negligible). Two shapes call it: the estimator's finalist re-score
// (K = a few dozen), which is bound by its launch, and the exact scoring
// of all K hypotheses (K = tens of thousands). One kernel serves both: a
// block scores kPoses poses at once, each thread loads a correspondence
// into registers once and applies every pose of the block to it (poses are
// broadcast from shared memory), then the block reduces over N. kPoses = 1
// gives the small case one block per pose, so that a few dozen poses still
// spread over a few dozen SMs; kPoses = 8 gives the large case eight uses
// of every correspondence load.
//
// NaN: a degenerate minimal set gives a NaN pose, and the caller ranks NaN
// scores last. fminf() would drop the NaN and return tau^2, so the clamp is
// written as a comparison, which passes a NaN residual through to the sum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int kPoses>
__global__ void score3d_kernel(const float* __restrict__ poses,
                               const float* __restrict__ p,
                               const float* __restrict__ q,
                               float* __restrict__ msac,
                               float* __restrict__ count,
                               int K, int N, float tau2) {
  __shared__ float s_pose[kPoses][12];
  __shared__ float s_msac[kPoses][kWarps];
  __shared__ float s_count[kPoses][kWarps];

  const int k0 = blockIdx.x * kPoses;
  for (int i = threadIdx.x; i < kPoses * 12; i += kThreads) {
    const int k = k0 + i / 12;
    s_pose[i / 12][i % 12] =
        k < K ? poses[static_cast<size_t>(k) * 12 + i % 12] : 0.f;
  }
  __syncthreads();

  float m[kPoses], c[kPoses];
#pragma unroll
  for (int j = 0; j < kPoses; ++j) {
    m[j] = 0.f;
    c[j] = 0.f;
  }
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float px = __ldg(p + 3 * n), py = __ldg(p + 3 * n + 1), pz = __ldg(p + 3 * n + 2);
    const float qx = __ldg(q + 3 * n), qy = __ldg(q + 3 * n + 1), qz = __ldg(q + 3 * n + 2);
#pragma unroll
    for (int j = 0; j < kPoses; ++j) {
      const float* T = s_pose[j];  // 9 rotation row-major, 3 translation
      const float ex = T[0] * px + T[1] * py + T[2] * pz + T[9] - qx;
      const float ey = T[3] * px + T[4] * py + T[5] * pz + T[10] - qy;
      const float ez = T[6] * px + T[7] * py + T[8] * pz + T[11] - qz;
      const float e = ex * ex + ey * ey + ez * ez;
      m[j] += e > tau2 ? tau2 : e;  // NaN stays NaN
      c[j] += e < tau2 ? 1.f : 0.f;
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kPoses; ++j) {
    float mj = m[j], cj = c[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mj += __shfl_down_sync(0xffffffffu, mj, off);
      cj += __shfl_down_sync(0xffffffffu, cj, off);
    }
    if (lane == 0) {
      s_msac[j][warp] = mj;
      s_count[j][warp] = cj;
    }
  }
  __syncthreads();
  if (threadIdx.x < kPoses && k0 + threadIdx.x < K) {
    float mj = 0.f, cj = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mj += s_msac[threadIdx.x][w];
      cj += s_count[threadIdx.x][w];
    }
    msac[k0 + threadIdx.x] = mj;
    count[k0 + threadIdx.x] = cj;
  }
}

}  // namespace

// poses (K, 12) f32 [9 rotation row-major, 3 translation], p and q (N, 3)
// f32, msac and count (K,) f32; all contiguous.
extern "C" int rgbd_score_poses_3d3d(const float* poses, const float* p,
                                     const float* q, float* msac, float* count,
                                     int K, int N, float tau2,
                                     cudaStream_t stream) {
  if (K <= 1024) {
    score3d_kernel<1><<<K, kThreads, 0, stream>>>(poses, p, q, msac, count, K, N, tau2);
  } else {
    score3d_kernel<8><<<(K + 7) / 8, kThreads, 0, stream>>>(poses, p, q, msac, count, K, N, tau2);
  }
  return static_cast<int>(cudaGetLastError());
}
