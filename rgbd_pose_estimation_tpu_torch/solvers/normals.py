"""Point+normal reduced-sample minimal solvers.

Counterpart of the JAX package's ``solvers/normals.py``. Surface normals
add two rotational constraints per correspondence, so the minimal sample
for a rigid transform shrinks from 3 points to 2 — and RANSAC's cost to
find an uncontaminated sample drops from O(1/w³) to O(1/w²) at inlier
ratio w. With 1 point + its normal the pose is determined up to the yaw
about the normal; we emit a small fan of yaw hypotheses and let the scorer
disambiguate (the same all-roots-as-hypotheses pattern the P3P path uses).

All solvers are batched over leading axes and branch with masks only.
"""

from __future__ import annotations

import math

import torch

from rgbd_pose_estimation_tpu_torch.core.lie import rt_to_matrix, so3_exp
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import (
    horn_rotation_directions,
)


def procrustes_rotation(vp: torch.Tensor, vq: torch.Tensor, weights=None) -> torch.Tensor:
    """Best rotation R with vq_i ≈ R vp_i (no centroiding — directions).

    ``vp``/``vq`` are ``(..., M, 3)`` direction sets. Solved via the
    quaternion Horn path (``horn_rotation_directions``): the same optimum
    as SVD Procrustes restricted to proper rotations, without an SVD, and
    orthonormal by construction, as the fast scorer's quadratic form needs.
    """
    return horn_rotation_directions(vp, vq, weights)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)


def ao_2pt_normals(p: torch.Tensor, q: torch.Tensor, np_: torch.Tensor, nq: torch.Tensor):
    """Rigid pose from TWO point+normal correspondences.

    Args: ``p``/``q`` ``(..., 2, 3)`` points, ``np_``/``nq`` ``(..., 2, 3)``
    unit normals, with q ≈ R p + t and nq ≈ R np_.
    The rotation aligns the direction triplet {p2-p1, n1, n2}; the
    translation matches centroids. Returns ``(..., 4, 4)``.
    """
    dp = _unit(p[..., 1, :] - p[..., 0, :])
    dq = _unit(q[..., 1, :] - q[..., 0, :])
    vp = torch.stack([dp, np_[..., 0, :], np_[..., 1, :]], dim=-2)
    vq = torch.stack([dq, nq[..., 0, :], nq[..., 1, :]], dim=-2)
    R = procrustes_rotation(vp, vq)
    cp = torch.mean(p, dim=-2)
    cq = torch.mean(q, dim=-2)
    t = cq - torch.einsum("...ij,...j->...i", R, cp)
    return rt_to_matrix(R, t)


def _axis(like: torch.Tensor, i: int) -> torch.Tensor:
    """Unit axis ``i`` broadcast to ``like``'s shape, filled on the device
    (a tensor made from a Python list would be copied from the host)."""
    e = torch.zeros(3, dtype=like.dtype, device=like.device)
    e[i].fill_(1.0)
    return e.expand(like.shape)


def ao_1pt_normal_fan(
    p: torch.Tensor, q: torch.Tensor, np_: torch.Tensor, nq: torch.Tensor,
    num_yaw: int = 8,
):
    """Pose family from ONE point+normal correspondence.

    Aligning n_p to n_q leaves one free rotation about n_q; returns
    ``num_yaw`` hypotheses sampling that circle uniformly —
    ``(..., num_yaw, 4, 4)``. Downstream MSAC scoring picks the yaw (and
    usually kills the whole sample unless the scene is normal-degenerate).
    """
    np_u = _unit(np_)
    nq_u = _unit(nq)
    # Minimal rotation taking np_u to nq_u (axis = np x nq).
    axis = torch.linalg.cross(np_u, nq_u, dim=-1)
    s = torch.linalg.norm(axis, dim=-1)
    c = torch.sum(np_u * nq_u, dim=-1)
    angle = torch.atan2(s, c)
    axis_u = axis / torch.clamp(s[..., None], min=1e-9)
    # Antiparallel fallback: any axis orthogonal to np_u.
    ortho = torch.linalg.cross(np_u, _axis(np_u, 0), dim=-1)
    ortho_n = torch.linalg.norm(ortho, dim=-1, keepdim=True)
    ortho2 = torch.linalg.cross(np_u, _axis(np_u, 1), dim=-1)
    ortho = _unit(torch.where(ortho_n > 1e-6, ortho, ortho2))
    axis_u = torch.where(s[..., None] > 1e-6, axis_u, ortho)
    R0 = so3_exp(axis_u * angle[..., None])

    yaw = torch.arange(num_yaw, dtype=p.dtype, device=p.device) * (2.0 * math.pi / num_yaw)
    # Rotation about nq_u by each yaw, composed after the alignment.
    w = nq_u[..., None, :] * yaw[:, None]  # (..., num_yaw, 3)
    Ry = so3_exp(w)
    R = Ry @ R0[..., None, :, :]
    t = q[..., None, :] - torch.einsum("...yij,...j->...yi", R, p)
    return rt_to_matrix(R, t)
