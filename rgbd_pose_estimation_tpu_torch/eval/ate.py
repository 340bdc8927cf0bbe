"""Trajectory evaluation: ATE and RPE (Sturm et al. 2012, TUM benchmark).

Counterpart of the JAX package's ``eval/ate.py``. The Umeyama alignment
reuses the absolute-orientation solver of ``solvers/``, so the evaluator and
the pose solver share one code path. It computes in float32 on CPU tensors,
as the reference does on its host: the inputs are small (F x 3).
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.lie import matrix_to_rt, se3_inverse
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import umeyama


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def align_umeyama(est_xyz, gt_xyz, with_scale: bool = False):
    """Best similarity/rigid alignment est → gt. Returns ``(T, s)``."""
    T, s = umeyama(_f32(est_xyz), _f32(gt_xyz), with_scale=with_scale)
    return T.numpy(), float(s)


def ate_rmse(est_xyz, gt_xyz, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment (meters)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    T, s = align_umeyama(est, gt, with_scale)
    R, t = T[:3, :3], T[:3, 3]
    aligned = s * est @ R.T + t
    err = aligned - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over a fixed frame delta.

    Args are ``(F, 4, 4)`` world→camera pose arrays. Returns dict with
    translational RMSE (m) and rotational RMSE (rad).
    """
    est = _f32(est_poses)
    gt = _f32(gt_poses)
    # Relative motions i -> i+delta in each trajectory.
    e_rel = est[delta:] @ se3_inverse(est[:-delta])
    g_rel = gt[delta:] @ se3_inverse(gt[:-delta])
    err = se3_inverse(g_rel) @ e_rel
    R, t = matrix_to_rt(err)
    t_err = np.asarray(torch.linalg.norm(t, dim=-1).numpy(), np.float64)
    cos = np.clip(
        (np.trace(R.numpy(), axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0
    )
    r_err = np.arccos(cos)
    return {
        "trans_rmse": float(np.sqrt(np.mean(t_err**2))),
        "rot_rmse": float(np.sqrt(np.mean(r_err**2))),
    }
