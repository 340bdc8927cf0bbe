"""N-point PnP: DLT initialization and Gauss-Newton reprojection refinement.

Counterpart of the JAX package's ``solvers/pnp.py``. Complements the P3P
minimal solver with the overdetermined 2D-3D case. Batched over leading
axes; fixed iteration counts, no branch on a tensor's value.

``pnp_refine`` doubles as the sparse Gauss-Newton refinement component:
RANSAC hands it an inlier-weighted correspondence set and an initial pose,
it returns the polished pose. Levenberg-Marquardt damping is folded in
(fixed lambda) so near-degenerate inlier sets don't blow up the 6x6 solve.

``pnp_dlt`` calls ``torch.linalg.eigh`` / ``svd`` / ``det`` (library calls
in the JAX package too); it is not on the RANSAC estimator's path.
``pnp_refine`` is, and reads nothing back: its 6x6 solve is
``torch.linalg.solve_ex``, which neither checks its status on the host nor
raises. Each of its steps is some hundred small launches on the card (the
SE(3) exponential of one 6-vector is most of them).
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.core.lie import (
    matrix_to_rt,
    rt_to_matrix,
    se3_exp,
)


def pnp_dlt(points: torch.Tensor, obs: torch.Tensor, weights=None):
    """Direct linear transform PnP from normalized image observations.

    Args:
      points: ``(..., N, 3)`` world points, N >= 6.
      obs: ``(..., N, 2)`` normalized image coordinates (x/z, y/z).
      weights: optional ``(..., N)`` weights.

    Returns ``(..., 4, 4)`` world→camera pose. The DLT estimate of [R|t] is
    projected onto SE(3) (SVD orthonormalization with det fix + scale
    recovery, cheirality-corrected sign).
    """
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=points.dtype, device=points.device)
    X, Y, Z = points[..., 0], points[..., 1], points[..., 2]
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    x, y = obs[..., 0], obs[..., 1]

    # Two rows per correspondence of A p = 0 with p = vec([R|t]) (12 vector).
    row_x = torch.stack(
        [X, Y, Z, one, zero, zero, zero, zero, -x * X, -x * Y, -x * Z, -x],
        dim=-1,
    )
    row_y = torch.stack(
        [zero, zero, zero, zero, X, Y, Z, one, -y * X, -y * Y, -y * Z, -y],
        dim=-1,
    )
    A = torch.cat([row_x, row_y], dim=-2)  # (..., 2N, 12)
    w2 = torch.cat([weights, weights], dim=-1)[..., None]
    # Smallest eigenvector of AtA (12x12 symmetric) — batched eigh.
    AtA = torch.einsum("...ni,...nj->...ij", A * w2, A)
    _, vecs = torch.linalg.eigh(AtA)
    p = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue

    M = p.reshape(p.shape[:-1] + (3, 4))

    # The eigenvector sign is arbitrary: pick the sign giving positive mean
    # projective depth (cheirality) *before* orthonormalization.
    z_raw = (
        torch.einsum("...j,...nj->...n", M[..., 2, :3], points) + M[..., 2:3, 3]
    )
    flip = torch.where(torch.mean(z_raw, dim=-1) < 0, -1.0, 1.0)
    M = M * flip[..., None, None]
    R_raw = M[..., :3]
    t_raw = M[..., 3]

    # Project the rotation block onto SO(3) (det-fixed SVD) and recover the
    # common projective scale from the singular values.
    U, S, Vt = torch.linalg.svd(R_raw)
    scale = torch.mean(S, dim=-1)
    det = torch.linalg.det(U @ Vt)
    D = torch.zeros_like(R_raw)
    D[..., 0, 0].fill_(1.0)
    D[..., 1, 1].fill_(1.0)
    D[..., 2, 2].copy_(torch.where(det < 0, -1.0, 1.0))
    R = U @ D @ Vt
    t = t_raw / torch.clamp(scale, min=1e-12)[..., None]
    return rt_to_matrix(R, t)


def _reproj_residuals(T, points, obs):
    """Per-point normalized-plane reprojection residuals ``(..., N, 2)``."""
    R, t = matrix_to_rt(T)
    Xc = torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]
    z = torch.clamp(Xc[..., 2], min=1e-6)
    proj = Xc[..., :2] / z[..., None]
    return proj - obs, Xc


def pnp_refine(
    T0: torch.Tensor,
    points: torch.Tensor,
    obs: torch.Tensor,
    weights=None,
    iters: int = 8,
    damping: float = 1e-6,
):
    """Gauss-Newton (LM-damped) refinement of a world→camera pose.

    Minimizes Σ w_i ||π(R X_i + t) − obs_i||² over SE(3), with analytic
    Jacobians and a fixed number of iterations. Left-multiplicative update:
    T ← exp(ξ) T.
    """
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=points.dtype, device=points.device)
    w = weights[..., None, None]
    T = T0
    for _ in range(iters):
        r, Xc = _reproj_residuals(T, points, obs)  # (..., N, 2), (..., N, 3)
        x, y_, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        z = torch.clamp(z, min=1e-6)
        iz = 1.0 / z
        iz2 = iz * iz
        # d proj / d Xc  (2x3), then chain with d Xc/d ξ = [I | -[Xc]_x].
        zero = torch.zeros_like(x)
        # Rows for u = x/z.
        Ju = torch.stack(
            [
                iz,
                zero,
                -x * iz2,
                -x * y_ * iz2,
                1.0 + x * x * iz2,
                -y_ * iz,
            ],
            dim=-1,
        )
        Jv = torch.stack(
            [
                zero,
                iz,
                -y_ * iz2,
                -(1.0 + y_ * y_ * iz2),
                x * y_ * iz2,
                x * iz,
            ],
            dim=-1,
        )
        J = torch.stack([Ju, Jv], dim=-2)  # (..., N, 2, 6)
        JtJ = torch.einsum("...nri,...nrj->...ij", J * w, J)
        Jtr = torch.einsum("...nri,...nr->...i", J * w, r)
        H = JtJ + damping * torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
        # solve_ex: torch.linalg.solve checks for singularity on the host,
        # which would stall the stream at every step.
        delta = -torch.linalg.solve_ex(H, Jtr[..., None])[0][..., 0]
        T = se3_exp(delta) @ T
    return T
