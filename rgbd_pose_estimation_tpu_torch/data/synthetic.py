"""Synthetic problems with exact ground truth — the test oracle.

Counterpart of the JAX package's ``data/synthetic.py``. Only the 3D-3D
correspondence generator is ported so far; the analytically raycast depth
scenes come with the dense-ICP slice.

Pose convention everywhere: ``T`` maps world → camera (``x_cam = R x_w + t``).
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.core.lie import se3_apply, se3_exp


def synthetic_correspondences(
    generator: torch.Generator,
    n: int = 512,
    outlier_frac: float = 0.0,
    noise: float = 0.0,
    motion_scale: float = 0.5,
    batch: tuple = (),
    device="cuda",
):
    """Random 3D-3D correspondence problems with known pose and inlier mask.

    Returns ``(p, q, T_gt, inlier_mask)`` with shapes ``batch + (n, 3)`` etc.,
    created on ``device`` (``generator`` must live there too). Outliers
    replace q with uniform random points in the scene bounding box. The same
    distribution as the JAX package's generator, not the same numbers: the
    two frameworks' random streams differ.
    """
    batch = tuple(batch)
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, **f32) * (hi - lo) + lo

    p = uniform(batch + (n, 3), -1.0, 1.0)
    p = p * torch.tensor([2.0, 2.0, 1.0], **f32) + torch.tensor([0.0, 0.0, 2.5], **f32)
    xi = torch.randn(batch + (6,), generator=generator, **f32) * motion_scale
    T = se3_exp(xi)
    q = se3_apply(T, p)
    q = q + noise * torch.randn(q.shape, generator=generator, **f32)
    out = torch.rand(batch + (n,), generator=generator, **f32) < outlier_frac
    q_out = uniform(q.shape, -2.0, 2.0) + torch.tensor([0.0, 0.0, 2.5], **f32)
    q = torch.where(out[..., None], q_out, q)
    return p, q, T, ~out
