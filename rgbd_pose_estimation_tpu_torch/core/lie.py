"""Batched SO(3)/SE(3) Lie-group operations in PyTorch.

Counterpart of the JAX package's ``core/lie.py``. Everything here:

- is batched over arbitrary leading axes (``...`` in shapes);
- is float32-safe: small-angle Taylor fallbacks everywhere a ``sin(x)/x``-style
  ratio appears, so values are finite at the identity;
- branches with ``torch.where`` masks only, never on tensor values in
  Python, so nothing here synchronises with the device.

Poses are canonically 4x4 homogeneous matrices (``(..., 4, 4)``).
The logarithms, the left Jacobians and the adjoint are not ported yet; they
come with the dense-ICP slice that first needs them.
"""

from __future__ import annotations

import torch

# Below this angle (radians) we switch to Taylor expansions of the
# trigonometric ratios; 1e-4 keeps full f32 accuracy on both branches.
_SMALL_ANGLE = 1e-4


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Map ``(..., 3)`` axis-angle vectors to ``(..., 3, 3)`` skew matrices."""
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


def _sinc(theta: torch.Tensor) -> torch.Tensor:
    """sin(t)/t with Taylor fallback (1 - t^2/6) near zero."""
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _cosc(theta: torch.Tensor) -> torch.Tensor:
    """(1 - cos(t))/t^2 with Taylor fallback (1/2 - t^2/24) near zero."""
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(
        small, 0.5 - theta * theta / 24.0, (1.0 - torch.cos(safe)) / (safe * safe)
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: ``(..., 3)`` tangent → ``(..., 3, 3)`` rotation."""
    theta = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * W2


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(w): translation part of the SE(3) exponential."""
    theta = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    W2 = W @ W
    b = _cosc(theta)[..., None, None]
    # (theta - sin theta)/theta^3 with Taylor fallback 1/6 - t^2/120.
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    c = torch.where(
        small,
        1.0 / 6.0 - theta * theta / 120.0,
        (safe - torch.sin(safe)) / (safe * safe * safe),
    )[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + b * W + c * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: ``(..., 6)`` twist [v, w] → ``(..., 4, 4)`` pose.

    Convention: ``xi[..., :3]`` is the translational part v, ``xi[..., 3:]``
    the rotational part w.
    """
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = torch.einsum("...ij,...j->...i", _left_jacobian(w), v)
    return rt_to_matrix(R, t)


def rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., 3, 3)`` + ``(..., 3)`` into ``(..., 4, 4)`` homogeneous."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device
    ).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_rt(T: torch.Tensor):
    """Split ``(..., 4, 4)`` homogeneous pose into ``(R, t)``."""
    return T[..., :3, :3], T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform without a general 4x4 solve."""
    R, t = matrix_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_matrix(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B — spelled out so intent is greppable at call sites."""
    return A @ B


def se3_apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply ``(..., 4, 4)`` pose(s) to ``(..., N, 3)`` points."""
    R, t = matrix_to_rt(T)
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``(..., 4)`` in (w, x, y, z) order → rotation matrix."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )
