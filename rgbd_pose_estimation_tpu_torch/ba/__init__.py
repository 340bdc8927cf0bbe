from rgbd_pose_estimation_tpu_torch.ba.schur import (
    BAProblem,
    ba_solve,
    ba_step,
    make_synthetic_ba_problem,
    reprojection_rmse,
)

__all__ = [
    "BAProblem",
    "ba_solve",
    "ba_step",
    "make_synthetic_ba_problem",
    "reprojection_rmse",
]
