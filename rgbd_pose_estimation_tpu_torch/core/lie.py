"""Batched SO(3)/SE(3) Lie-group operations in PyTorch.

Counterpart of the JAX package's ``core/lie.py``. Everything here:

- is batched over arbitrary leading axes (``...`` in shapes);
- is float32-safe: small-angle Taylor fallbacks everywhere a ``sin(x)/x``-style
  ratio appears, so values are finite at the identity;
- branches with ``torch.where`` masks only, never on tensor values in
  Python, so nothing here synchronises with the device.

Poses are canonically 4x4 homogeneous matrices (``(..., 4, 4)``): composition
is then a plain matmul. ``(R, t)`` accessors are provided for code that wants
the split form.
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


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`so3_hat`: ``(..., 3, 3)`` skew → ``(..., 3)``."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → axis-angle, safe near 0 and near pi.

    Near theta = pi the standard ``vee(R - R^T)/(2 sinc)`` formula loses the
    axis; we recover it from the diagonal of ``R + I`` (whose columns are
    proportional to the axis outer product) and fix signs from the off-diagonal.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(cos_theta)

    # Generic branch: w = theta/(2 sin(theta)) * vee(R - R^T).
    vee = so3_vee(R - R.transpose(-1, -2))
    generic = 0.5 / _sinc(theta)[..., None] * vee

    # Near-pi branch: axis from the largest diagonal of B = (R + I)/2;
    # B = axis axis^T when theta == pi exactly.
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    # Take column k of B and normalize; gather via one-hot to stay batched.
    onehot = _one_hot(k, 3, R.dtype)
    col = torch.einsum("...ij,...j->...i", B, onehot)
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=1e-12)
    # Sign: make axis agree with vee(R - R^T) when that is nonzero.
    sign = torch.where(torch.sum(axis * vee, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    near_pi = (axis * sign) * theta[..., None]

    use_pi = (torch.pi - theta) < 1e-3
    return torch.where(use_pi[..., None], near_pi, generic)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``(...,)`` indices → ``(..., n)`` one-hot rows of ``dtype``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


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


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the SO(3) left Jacobian."""
    theta = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    W2 = W @ W
    small = theta < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe * 0.5
    # (1/theta^2) (1 - theta sin / (2 (1 - cos))) = (1 - half*cot(half))/theta^2
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (safe * safe),
    )[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye - 0.5 * W + cot_term * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: ``(..., 6)`` twist [v, w] → ``(..., 4, 4)`` pose.

    Convention: ``xi[..., :3]`` is the translational part v, ``xi[..., 3:]``
    the rotational part w.
    """
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = torch.einsum("...ij,...j->...i", _left_jacobian(w), v)
    return rt_to_matrix(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: ``(..., 4, 4)`` pose → ``(..., 6)`` twist [v, w]."""
    R, t = matrix_to_rt(T)
    w = so3_log(R)
    v = torch.einsum("...ij,...j->...i", _left_jacobian_inv(w), t)
    return torch.cat([v, w], dim=-1)


def rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., 3, 3)`` + ``(..., 3)`` into ``(..., 4, 4)`` homogeneous."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # Filled on the device: a tensor made from a Python list would be copied
    # from the host, and that copy waits for the stream.
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def matrix_to_rt(T: torch.Tensor):
    """Split ``(..., 4, 4)`` homogeneous pose into ``(R, t)``."""
    return T[..., :3, :3], T[..., :3, 3]


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:  # alias
    return rt_to_matrix(R, t)


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


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3) for twist order [v, w]: ``(..., 6, 6)``.

    Satisfies ``T exp(xi^) T^-1 = exp((Ad_T xi)^)``:
    ``Ad = [[R, [t]x R], [0, R]]``.
    """
    R, t = matrix_to_rt(T)
    tx = so3_hat(t)
    top = torch.cat([R, tx @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


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


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion (w, x, y, z), branchless.

    Computes all four of Shepperd's candidate solutions (one per largest
    element of the quaternion) and selects by mask, so it batches. Each
    candidate is scaled so the shared element is the squared magnitude;
    normalization at the end removes the scale.
    """
    m = R
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    t = m00 + m11 + m22
    pivots = torch.stack(
        [1.0 + t, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    # Candidates built around w, x, y and z being largest.
    qw0 = torch.stack(
        [pivots[..., 0], m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
         m[..., 1, 0] - m[..., 0, 1]], dim=-1)
    qx0 = torch.stack(
        [m[..., 2, 1] - m[..., 1, 2], pivots[..., 1], m[..., 0, 1] + m[..., 1, 0],
         m[..., 0, 2] + m[..., 2, 0]], dim=-1)
    qy0 = torch.stack(
        [m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0], pivots[..., 2],
         m[..., 1, 2] + m[..., 2, 1]], dim=-1)
    qz0 = torch.stack(
        [m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
         m[..., 1, 2] + m[..., 2, 1], pivots[..., 3]], dim=-1)
    # Pick the candidate whose pivot (its own squared element) is largest:
    # that is the numerically safest of the four.
    k = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw0, qx0, qy0, qz0], dim=-2)  # (..., 4 cands, 4)
    onehot = _one_hot(k, 4, R.dtype)
    q = torch.einsum("...ck,...c->...k", cands, onehot)
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    # Canonical sign: w >= 0.
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
