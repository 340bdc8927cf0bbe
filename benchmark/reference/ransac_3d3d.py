"""Plain reference of robust 3D-3D rigid pose estimation (configuration 1).

Written from the method's description, in plain PyTorch, for the benchmark's
check: K minimal sets of ``sample_size`` distinct correspondences drawn
uniformly (its own sampler, from its own seed), a Kabsch solve (SVD) of each,
the exact MSAC score Σ min(r², τ²) of every hypothesis over all N
correspondences, the best one, then ``refit_rounds`` least-squares refits
on the hard inliers r² < τ² of the current pose (kept when fewer than three),
and the inliers of the final pose. The result of such an estimate is the
least-squares pose of its consensus set, which does not depend on which
good sample found it: that is what makes two estimators' poses comparable.

Imports torch only. Every product of matrices goes through
:func:`benchmark.reference.precision.matmul`, so that the same code gives the
float32 reference and its TF32 control.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import matmul


def _kabsch(P, Q, w, precision):
    """Weighted least-squares rotation and translation, batched: P, Q
    ``(B, N, 3)``, w ``(B, N)`` → ``(B, 4, 4)``."""
    ws = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    cp = matmul(w[:, None, :], P, precision)[:, 0] / ws
    cq = matmul(w[:, None, :], Q, precision)[:, 0] / ws
    Pc = (P - cp[:, None]) * w[..., None]
    H = matmul(Pc.transpose(1, 2).contiguous(), (Q - cq[:, None]).contiguous(), precision)
    U, _, Vh = torch.linalg.svd(H.double())
    V = Vh.transpose(1, 2)
    D = torch.ones(H.shape[0], 3, dtype=torch.float64, device=H.device)
    D[:, 2] = torch.sign(torch.linalg.det(V @ U.transpose(1, 2)))
    R = (V * D[:, None, :]) @ U.transpose(1, 2)
    R = R.float()
    t = cq - matmul(R, cp[..., None].contiguous(), precision)[..., 0]
    T = torch.eye(4, device=P.device).repeat(P.shape[0], 1, 1)
    T[:, :3, :3], T[:, :3, 3] = R, t
    return T


def residuals2(T, p, q, precision):
    """Squared residuals |R p + t − q|² of poses ``(B, 4, 4)`` on one problem."""
    Rp = matmul(p[None].expand(T.shape[0], -1, -1).contiguous(),
                T[:, :3, :3].transpose(1, 2).contiguous(), precision)
    return ((Rp + T[:, None, :3, 3] - q[None]) ** 2).sum(-1)


def estimate(generator, p, q, num_hypotheses, threshold, refit_rounds, sample_size,
             precision="float32", chunk=8192):
    """Pose ``(4, 4)`` and inlier count of one problem ``p``, ``q`` ``(N, 3)``."""
    N = p.shape[0]
    tau2 = threshold * threshold
    best_score, best_T = None, None
    for k0 in range(0, num_hypotheses, chunk):
        k = min(chunk, num_hypotheses - k0)
        keys = torch.rand((k, N), generator=generator, device=p.device)
        idx = torch.topk(keys, sample_size, dim=1).indices
        T = _kabsch(p[idx], q[idx], torch.ones(k, sample_size, device=p.device), precision)
        score = torch.clamp(residuals2(T, p, q, precision), max=tau2).sum(-1)
        score = torch.where(torch.isnan(score), float("inf"), score)
        i = int(torch.argmin(score))
        if best_score is None or float(score[i]) < best_score:
            best_score, best_T = float(score[i]), T[i]
    T = best_T
    for _ in range(refit_rounds):
        w = (residuals2(T[None], p, q, precision)[0] < tau2).float()
        if float(w.sum()) >= 3:
            T = _kabsch(p[None], q[None], w[None], precision)[0]
    count = int((residuals2(T[None], p, q, precision)[0] < tau2).sum())
    return T, count


def count_inliers(T, p, q, threshold):
    """Inliers of a given pose, in float32."""
    return int((residuals2(T[None], p, q, "float32")[0] < threshold * threshold).sum())
