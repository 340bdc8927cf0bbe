from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry, Keyframe

__all__ = ["DenseOdometry", "Keyframe"]
