// Exact f32 MSAC scoring of K poses against N 3D-3D correspondences.
//
// Replaces the TPU kernel `_score3d_kernel` of
// rgbd_pose_estimation_tpu/ops/ransac_score.py (`score_poses_3d3d`): per
// pose k, sum_n min(|R_k p_n + t_k - q_n|^2, tau^2) and the inlier count
// sum_n [e < tau^2]. True f32 on the CUDA cores: no TF32, no bf16.
//
// The kernel is msac_exact.cuh's, with the 3D-3D residual; see there for
// its design and bound. Two shapes call it: the estimator's finalist
// re-score (K = a few dozen), one pose a block so that it spreads over the
// SMs, and the exact scoring of all K hypotheses (K = tens of thousands),
// pose-stationary with the poses a thread that T1's sweep, on the same
// kernel, measured fastest for that K.

#include "msac_exact.cuh"

// poses (K, 12) f32 [9 rotation row-major, 3 translation], p and q (N, 3)
// f32, msac and count (K,) f32; all contiguous.
extern "C" int rgbd_score_poses_3d3d(const float* poses, const float* p,
                                     const float* q, float* msac, float* count,
                                     int K, int N, float tau2,
                                     cudaStream_t stream) {
  return msac_exact::launch_estimator<msac_exact::Residual3D3D>(poses, p, q, msac, count, K,
                                                                N, tau2, stream);
}
