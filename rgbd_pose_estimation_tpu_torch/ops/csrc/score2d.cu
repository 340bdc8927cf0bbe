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
// compiled without fast-math): one reciprocal of the guarded depth, two
// products.
//
// The kernel is msac_exact.cuh's, with the 2D-3D residual; see there for
// its design, its bound, its reciprocal and its NaN handling. The RANSAC
// engine calls it once an estimate with all 4K P3P root poses (8192 at
// config 2: pose-stationary, one pose a thread); up to 1024 poses, one pose
// a block.

#include "msac_exact.cuh"

// poses (K, 12) f32 [9 rotation row-major, 3 translation], points (N, 3) and
// obs (N, 2) f32, msac and count (K,) f32; all contiguous.
extern "C" int rgbd_score_poses_2d3d(const float* poses, const float* points,
                                     const float* obs, float* msac, float* count,
                                     int K, int N, float tau2,
                                     cudaStream_t stream) {
  return msac_exact::launch_estimator<msac_exact::Residual2D3D>(poses, points, obs, msac,
                                                                count, K, N, tau2, stream);
}
