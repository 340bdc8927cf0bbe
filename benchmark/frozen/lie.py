"""SE(3) helpers the frozen generators need.

Copied from rgbd_pose_estimation_tpu_torch/core/lie.py at commit 01a5bf9
(``so3_hat``, ``_sinc``, ``_cosc``, ``so3_exp``, ``_left_jacobian``,
``se3_exp``, ``rt_to_matrix``, ``se3_apply``), unchanged in arithmetic, so that
a later change to the program cannot move the benchmark's inputs.
"""

from __future__ import annotations

import torch

_SMALL_ANGLE = 1e-4


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc(theta):
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _cosc(theta):
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 0.5 - theta * theta / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + _sinc(theta)[..., None, None] * W + _cosc(theta)[..., None, None] * W2


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    W2 = W @ W
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    c = torch.where(
        small, 1.0 / 6.0 - theta * theta / 120.0, (safe - torch.sin(safe)) / (safe * safe * safe)
    )[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + _cosc(theta)[..., None, None] * W + c * W2


def rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """``(..., 6)`` twist [v, w] → ``(..., 4, 4)`` pose."""
    v, w = xi[..., :3], xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", _left_jacobian(w), v)
    return rt_to_matrix(so3_exp(w), t)


def se3_apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``(..., 4, 4)`` poses applied to ``(..., N, 3)`` points."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]
