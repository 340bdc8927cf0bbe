from rgbd_pose_estimation_tpu_torch.models.frame_pair import FramePairEstimator
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry, Keyframe
from rgbd_pose_estimation_tpu_torch.models.sequence_parallel import (
    sequence_parallel_odometry,
)
from rgbd_pose_estimation_tpu_torch.models.slam import Slam

__all__ = ["FramePairEstimator", "DenseOdometry", "Keyframe", "Slam",
           "sequence_parallel_odometry"]
