from rgbd_pose_estimation_tpu_torch.ransac.prosac import (
    prosac_windows,
    sample_minimal_sets,
)
from rgbd_pose_estimation_tpu_torch.ransac.engine import (
    RansacResult,
    estimate_pose_3d3d,
    estimate_pose_3d3d_adaptive,
    estimate_pose_3d3d_normals,
    estimate_pose_2d3d,
    estimate_pose_2d3d_adaptive,
    required_hypotheses,
)

__all__ = [
    "prosac_windows",
    "sample_minimal_sets",
    "RansacResult",
    "estimate_pose_3d3d",
    "estimate_pose_3d3d_adaptive",
    "estimate_pose_3d3d_normals",
    "estimate_pose_2d3d",
    "estimate_pose_2d3d_adaptive",
    "required_hypotheses",
]
