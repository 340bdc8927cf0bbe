// Exact f32 MSAC scoring of K poses against N 3D-3D correspondences.
//
// Replaces the TPU kernel `_score3d_kernel` of
// rgbd_pose_estimation_tpu/ops/ransac_score.py (`score_poses_3d3d`): per
// pose k, sum_n min(|R_k p_n + t_k - q_n|^2, tau^2) and the inlier count
// sum_n [e < tau^2]. True f32 on the CUDA cores: no TF32, no bf16.
//
// The kernel is the template of score3d.cuh (shared with the measurement
// variants T1 and T5 in msac_variants.cu); see there for its design and
// bound. Two shapes call it here: the estimator's finalist re-score (K = a
// few dozen), which is bound by its launch, and the exact scoring of all K
// hypotheses (K = tens of thousands). kPoses = 1 gives the small case one
// block per pose, so that a few dozen poses still spread over a few dozen
// SMs; kPoses = 8 gives the large case eight uses of every correspondence
// load.

#include "score3d.cuh"

// poses (K, 12) f32 [9 rotation row-major, 3 translation], p and q (N, 3)
// f32, msac and count (K,) f32; all contiguous.
extern "C" int rgbd_score_poses_3d3d(const float* poses, const float* p,
                                     const float* q, float* msac, float* count,
                                     int K, int N, float tau2,
                                     cudaStream_t stream) {
  using score3d::kThreads;
  using score3d::score3d_kernel;
  if (K <= 1024) {
    score3d_kernel<1, true><<<K, kThreads, 0, stream>>>(poses, p, q, msac, count, K, N, tau2);
  } else {
    score3d_kernel<8, true><<<(K + 7) / 8, kThreads, 0, stream>>>(poses, p, q, msac, count, K, N, tau2);
  }
  return static_cast<int>(cudaGetLastError());
}
