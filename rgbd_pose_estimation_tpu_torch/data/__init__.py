from rgbd_pose_estimation_tpu_torch.data.synthetic import (
    synthetic_correspondences,
    synthetic_depth_scene,
    synthetic_sequence,
    synthetic_sequence_hard,
)

__all__ = [
    "synthetic_correspondences",
    "synthetic_depth_scene",
    "synthetic_sequence",
    "synthetic_sequence_hard",
]
