from rgbd_pose_estimation_tpu_torch.ops.icp_jtj import (
    icp_jtj_jtr,
    icp_jtj_jtr_reference,
)
from rgbd_pose_estimation_tpu_torch.ops.moments import (
    minimal_moments,
    minimal_moments_reference,
)
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import (
    best_pose_3d3d,
    score_poses_3d3d,
    score_poses_3d3d_quad,
    score_poses_3d3d_reference,
    score_poses_2d3d,
    score_poses_2d3d_reference,
)

__all__ = [
    "icp_jtj_jtr",
    "icp_jtj_jtr_reference",
    "minimal_moments",
    "minimal_moments_reference",
    "best_pose_3d3d",
    "score_poses_3d3d",
    "score_poses_3d3d_quad",
    "score_poses_3d3d_reference",
    "score_poses_2d3d",
    "score_poses_2d3d_reference",
]
