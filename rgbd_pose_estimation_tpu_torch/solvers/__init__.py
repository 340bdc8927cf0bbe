from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import (
    kabsch,
    umeyama,
    horn_quaternion,
    horn_from_moments,
)
from rgbd_pose_estimation_tpu_torch.solvers.p3p import p3p, p3p_best
from rgbd_pose_estimation_tpu_torch.solvers.pnp import pnp_dlt, pnp_refine

__all__ = [
    "kabsch",
    "umeyama",
    "horn_quaternion",
    "horn_from_moments",
    "p3p",
    "p3p_best",
    "pnp_dlt",
    "pnp_refine",
]
