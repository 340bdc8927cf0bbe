from rgbd_pose_estimation_tpu_torch.eval.ate import ate_rmse, align_umeyama, rpe
from rgbd_pose_estimation_tpu_torch.eval.traj_io import (
    write_tum_trajectory,
    read_tum_trajectory,
    associate_timestamps,
)

__all__ = [
    "ate_rmse",
    "align_umeyama",
    "rpe",
    "write_tum_trajectory",
    "read_tum_trajectory",
    "associate_timestamps",
]
