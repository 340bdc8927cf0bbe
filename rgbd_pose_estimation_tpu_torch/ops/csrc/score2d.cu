// MSAC scoring of K world->camera poses against N (3D point, normalized-2D
// observation) pairs.
//
// Replaces the TPU kernel `_score2d_kernel` of
// rgbd_pose_estimation_tpu/ops/ransac_score.py (`score_poses_2d3d`): per
// pose k, with X_c = R_k X_n + t_k and e = |X_c.xy / X_c.z - obs_n|^2 on the
// normalized image plane, sum_n min(e, tau^2) and the inlier count
// sum_n [e < tau^2]. A point behind the camera (X_c.z < 1e-6) is an outlier:
// its e is set to 4 tau^2, so it adds tau^2 to the score and nothing to the
// count. True f32 on the CUDA cores; the division is IEEE (this file is
// compiled without fast-math), written as the TPU kernel writes it: one
// reciprocal of the guarded depth, two products.
//
// Bound on this card: operations, 26*K*N f32 (the bytes, 4*(14*K + 5*N), are
// negligible: every correspondence is used by every pose). The RANSAC engine
// calls it once an estimate with all 4K P3P root poses. A block scores kPoses
// poses at once: each thread loads a correspondence into registers once and
// applies every pose of the block to it (poses are broadcast from shared
// memory), then the block reduces over N with a warp tree and a fixed-order
// sum over its warps. No atomics: the same input gives the same bits.
// kPoses = 1 gives a small K one block per pose, so that it still spreads
// over the SMs; kPoses = 8 gives a large K eight uses of every load.
//
// NaN: a degenerate minimal sample gives a NaN pose, and the caller masks NaN
// scores. fminf() would drop the NaN and return tau^2, so the clamp is a
// comparison, which passes a NaN error through to the sum; `z < 1e-6` is
// false for NaN, so a NaN depth is not "behind" and reaches the sum as well.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int kPoses>
__global__ void score2d_kernel(const float* __restrict__ poses,
                               const float* __restrict__ points,
                               const float* __restrict__ obs,
                               float* __restrict__ msac,
                               float* __restrict__ count,
                               int K, int N, float tau2) {
  __shared__ __align__(16) float s_pose[kPoses][12];
  __shared__ float s_msac[kPoses][kWarps];
  __shared__ float s_count[kPoses][kWarps];

  const int k0 = blockIdx.x * kPoses;
  for (int i = threadIdx.x; i < kPoses * 12; i += kThreads) {
    const int k = k0 + i / 12;
    s_pose[i / 12][i % 12] =
        k < K ? poses[static_cast<size_t>(k) * 12 + i % 12] : 0.f;
  }
  __syncthreads();

  const float behind_e = 4.f * tau2;
  float m[kPoses], c[kPoses];
#pragma unroll
  for (int j = 0; j < kPoses; ++j) {
    m[j] = 0.f;
    c[j] = 0.f;
  }
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float X = __ldg(points + 3 * n), Y = __ldg(points + 3 * n + 1),
                Z = __ldg(points + 3 * n + 2);
    const float ou = __ldg(obs + 2 * n), ov = __ldg(obs + 2 * n + 1);
#pragma unroll
    for (int j = 0; j < kPoses; ++j) {
      const float* T = s_pose[j];  // 9 rotation row-major, 3 translation
      const float cx = T[0] * X + T[1] * Y + T[2] * Z + T[9];
      const float cy = T[3] * X + T[4] * Y + T[5] * Z + T[10];
      const float cz = T[6] * X + T[7] * Y + T[8] * Z + T[11];
      const bool behind = cz < 1e-6f;  // false for NaN
      const float iz = 1.f / (behind ? 1.f : cz);
      const float du = cx * iz - ou;
      const float dv = cy * iz - ov;
      float e = du * du + dv * dv;
      e = behind ? behind_e : e;
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

// poses (K, 12) f32 [9 rotation row-major, 3 translation], points (N, 3) and
// obs (N, 2) f32, msac and count (K,) f32; all contiguous.
extern "C" int rgbd_score_poses_2d3d(const float* poses, const float* points,
                                     const float* obs, float* msac, float* count,
                                     int K, int N, float tau2,
                                     cudaStream_t stream) {
  if (K <= 1024) {
    score2d_kernel<1><<<K, kThreads, 0, stream>>>(poses, points, obs, msac, count, K, N, tau2);
  } else {
    score2d_kernel<8><<<(K + 7) / 8, kThreads, 0, stream>>>(poses, points, obs, msac, count, K, N, tau2);
  }
  return static_cast<int>(cudaGetLastError());
}
