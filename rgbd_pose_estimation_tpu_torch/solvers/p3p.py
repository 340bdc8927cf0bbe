"""Batched P3P: camera pose from three 2D-3D correspondences.

Counterpart of the JAX package's ``solvers/p3p.py``. Uses Grunert's
classical reduction (as analyzed in Haralick et al. 1994, "Review and
Analysis of Solutions of the Three Point Perspective Pose Estimation
Problem"): the three law-of-cosines constraints reduce to a quartic in the
ratio of two ray depths, giving up to four pose solutions.

- the quartic is solved in closed form with masked real-root extraction
  (``core/poly.py``) — no host branching, so the solver runs over thousands
  of RANSAC minimal samples at once;
- each recovered depth triple yields three camera-frame points; the pose is
  then produced by the 3-point Horn solver (quaternion power iteration,
  elementwise arithmetic only), the 3D-3D path's solver, on a
  ``(..., 4 roots, 3 points, 3)`` batch;
- invalid roots surface as ``valid=False`` with finite dummy poses, so
  downstream scoring simply masks them out.

Conventions: ``rays`` are *unit* bearing vectors in the camera frame,
``points`` are the corresponding 3D world points. The returned pose ``T`` is
world→camera: ``x_cam = R x_world + t``.
"""

from __future__ import annotations

import math

import torch

from rgbd_pose_estimation_tpu_torch.core.poly import solve_quartic_real
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import horn_quaternion


def p3p(points: torch.Tensor, rays: torch.Tensor):
    """Solve P3P for ``(..., 3, 3)`` world points and unit rays.

    Returns ``(T, valid)`` where ``T`` is ``(..., 4, 4, 4)`` (up to 4 root
    poses, world→camera) and ``valid`` is ``(..., 4)`` boolean.
    """
    P1, P2, P3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]
    f1, f2, f3 = rays[..., 0, :], rays[..., 1, :], rays[..., 2, :]

    # Side lengths (opposite the same-numbered vertex) and ray angles.
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)  # a^2, opposite P1
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)  # b^2, opposite P2
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)  # c^2, opposite P3
    cos_a = torch.sum(f2 * f3, dim=-1)  # angle at the camera subtending a
    cos_b = torch.sum(f1 * f3, dim=-1)
    cos_c = torch.sum(f1 * f2, dim=-1)

    b2_safe = torch.clamp(b2, min=1e-12)
    acb = (a2 - c2) / b2_safe  # (a^2 - c^2)/b^2
    apc = (a2 + c2) / b2_safe  # (a^2 + c^2)/b^2
    bc = (b2 - c2) / b2_safe
    ba = (b2 - a2) / b2_safe

    # Grunert quartic in v = s3/s1 (Haralick et al. 1994, Eq. for Grunert).
    A4 = (acb - 1.0) ** 2 - 4.0 * (c2 / b2_safe) * cos_a**2
    A3 = 4.0 * (
        acb * (1.0 - acb) * cos_b
        - (1.0 - apc) * cos_a * cos_c
        + 2.0 * (c2 / b2_safe) * cos_a**2 * cos_b
    )
    A2 = 2.0 * (
        acb**2
        - 1.0
        + 2.0 * acb**2 * cos_b**2
        + 2.0 * bc * cos_a**2
        - 4.0 * apc * cos_a * cos_b * cos_c
        + 2.0 * ba * cos_c**2
    )
    A1 = 4.0 * (
        -acb * (1.0 + acb) * cos_b
        + 2.0 * (a2 / b2_safe) * cos_c**2 * cos_b
        - (1.0 - apc) * cos_a * cos_c
    )
    A0 = (1.0 + acb) ** 2 - 4.0 * (a2 / b2_safe) * cos_c**2

    v, v_valid = solve_quartic_real(A4, A3, A2, A1, A0)  # (..., 4)

    # Back-substitute: u = s2/s1 as a rational function of v.
    cos_a_, cos_b_, cos_c_ = (
        cos_a[..., None],
        cos_b[..., None],
        cos_c[..., None],
    )
    acb_ = acb[..., None]
    num = (-1.0 + acb_) * v**2 - 2.0 * acb_ * cos_b_ * v + 1.0 + acb_
    den = 2.0 * (cos_c_ - v * cos_a_)
    den_ok = torch.abs(den) > 1e-9
    u = num / torch.where(den_ok, den, 1.0)

    # s1 from the b-equation: s1^2 (1 + v^2 - 2 v cos_b) = b^2.
    s1_den = 1.0 + v * v - 2.0 * v * cos_b_
    s1_ok = s1_den > 1e-9
    s1 = torch.sqrt(b2_safe[..., None] / torch.where(s1_ok, s1_den, 1.0))
    s2 = u * s1
    s3 = v * s1

    depths_ok = (s1 > 0) & (s2 > 0) & (s3 > 0)
    valid = v_valid & den_ok & s1_ok & depths_ok

    # Camera-frame points for every root: X_i = s_i * f_i.
    # Shapes: (..., 4 roots, 3 pts, 3).
    Xc = torch.stack(
        [
            s1[..., None] * f1[..., None, :],
            s2[..., None] * f2[..., None, :],
            s3[..., None] * f3[..., None, :],
        ],
        dim=-2,
    )
    Pw = points[..., None, :, :].expand(Xc.shape)  # a view, not a copy

    # World→camera rigid transform per root via 3-point Horn (no SVD).
    T = horn_quaternion(Pw, Xc)
    return T, valid


def p3p_best(
    points: torch.Tensor,
    rays: torch.Tensor,
    extra_point: torch.Tensor,
    extra_ray: torch.Tensor,
):
    """P3P + disambiguation by a fourth correspondence.

    Picks, per problem, the root whose reprojection (angular) error on the
    extra point is smallest. Returns ``(T, valid)`` with ``T`` ``(..., 4, 4)``.
    """
    T, valid = p3p(points, rays)  # (..., 4, 4, 4), (..., 4)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Xc = torch.einsum("...rij,...j->...ri", R, extra_point) + t
    Xc_dir = Xc / torch.clamp(torch.linalg.norm(Xc, dim=-1, keepdim=True), min=1e-12)
    align = torch.sum(Xc_dir * extra_ray[..., None, :], dim=-1)
    score = torch.where(valid, align, -math.inf)
    k = torch.argmax(score, dim=-1)
    # Selected by a one-hot product: a gather by an index tensor of no
    # dimensions would be read back to the host.
    onehot = (k[..., None] == torch.arange(4, device=T.device)).to(T.dtype)
    T_best = torch.einsum("...rij,...r->...ij", T, onehot)
    return T_best, torch.any(valid, dim=-1)
