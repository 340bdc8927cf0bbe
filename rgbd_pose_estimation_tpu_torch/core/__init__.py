from rgbd_pose_estimation_tpu_torch.core.lie import (
    so3_hat,
    so3_exp,
    se3_exp,
    se3_inverse,
    se3_compose,
    se3_apply,
    quat_to_rotmat,
    rt_to_matrix,
    matrix_to_rt,
)

__all__ = [
    "so3_hat",
    "so3_exp",
    "se3_exp",
    "se3_inverse",
    "se3_compose",
    "se3_apply",
    "quat_to_rotmat",
    "rt_to_matrix",
    "matrix_to_rt",
]
