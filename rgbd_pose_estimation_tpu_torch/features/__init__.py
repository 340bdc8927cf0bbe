from rgbd_pose_estimation_tpu_torch.features.frontend import (
    detect_orb,
    match_descriptors,
    matched_3d3d,
    matched_2d3d,
)

__all__ = ["detect_orb", "match_descriptors", "matched_3d3d", "matched_2d3d"]
