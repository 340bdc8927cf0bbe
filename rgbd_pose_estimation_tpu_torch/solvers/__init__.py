from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import (
    kabsch,
    umeyama,
    horn_quaternion,
    horn_from_moments,
)

__all__ = [
    "kabsch",
    "umeyama",
    "horn_quaternion",
    "horn_from_moments",
]
