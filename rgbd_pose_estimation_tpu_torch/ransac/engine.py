"""Batched RANSAC/PROSAC engine: hypothesize → score → refit.

Counterpart of the 3D-3D part of the JAX package's ``ransac/engine.py``. A
fixed batch of K hypotheses is drawn at once, solved at once from
minimal-set moments, all K are ranked against all N correspondences, a few
finalists are re-scored exactly, and a weighted Horn refit on the winner's
inliers finishes the job. Nothing here reads a value back to the host, so
the whole estimate is queued on the stream without a stall; the adaptive
wrapper reads one number back between its two rounds.

There is ONE algorithm (the JAX package's production branch); the only
choice made here is kernel or plain version, by the device of the tensors:
on CUDA tensors the three CUDA kernels of ``ops`` are launched, on CPU
tensors their plain versions run in the same structure.

Entry points: :func:`estimate_pose_3d3d`, :func:`estimate_pose_3d3d_adaptive`.
The 2D-3D and the normals estimators are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch

from rgbd_pose_estimation_tpu_torch.ops.moments import minimal_moments
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import best_pose_3d3d
from rgbd_pose_estimation_tpu_torch.ransac.prosac import sample_minimal_sets
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import (
    horn_from_moments,
    horn_quaternion,
    kabsch,
)
from rgbd_pose_estimation_tpu_torch.utils.config import RansacConfig


class RansacResult(typing.NamedTuple):
    pose: torch.Tensor  # (4, 4) best pose
    inlier_mask: torch.Tensor  # (N,) bool under the best pose
    num_inliers: torch.Tensor  # () f32
    score: torch.Tensor  # () MSAC score of the best hypothesis (pre-refit)
    valid: torch.Tensor  # () bool — enough inliers found
    # Static: candidate poses scored against all correspondences; adaptive
    # schedules sum their rounds.
    num_hypotheses: int


def pad_correspondences_3d3d(p, q, n_target: int):
    """Pad (p, q) to ``n_target`` rows with rigid-INCONSISTENT sentinels.

    Naive constant sentinels are dangerous: identical pad pairs are mutually
    consistent, so a hypothesis mapping the pad point to the pad target
    scores every pad row as an inlier and can beat the true model. Instead
    the pads lie on two lines with *different* point spacings (173 vs 171.6
    per index) — an isometry can match at most one pad pair within any
    threshold below ~0.7, and the pads sit ~1e4 away from any real scene so
    they can never mix with real inliers.
    """
    n = p.shape[0]
    pad = n_target - n
    if pad <= 0:
        return p, q
    i = torch.arange(pad, dtype=p.dtype, device=p.device)
    p_pad = torch.stack(
        [1e4 + 137.0 * i, -2e4 - 91.0 * i, 3e4 + 53.0 * i], dim=-1
    )
    q_pad = torch.stack(
        [-3e4 - 71.0 * i, 1e4 + 119.0 * i, -2e4 - 101.0 * i], dim=-1
    )
    return torch.cat([p, p_pad]), torch.cat([q, q_pad])


def _ceil128(n: int) -> int:
    return ((n + 127) // 128) * 128


def estimate_pose_3d3d(
    generator: torch.Generator, p, q, cfg: RansacConfig = RansacConfig()
) -> RansacResult:
    """Robust rigid pose from N 3D-3D correspondences (q ≈ R p + t).

    ``p``/``q`` are ``(N, 3)`` f32 on one device, ``generator`` lives on the
    same device; for PROSAC, order the correspondences by descending match
    quality. Returns a :class:`RansacResult` of tensors on that device.
    """
    idx = sample_minimal_sets(
        generator, p.shape[0], cfg.num_hypotheses, cfg.sample_size, cfg.prosac,
        device=p.device,
    )  # (K, m)
    return _estimate_from_samples(idx, p, q, cfg)


def _estimate_from_samples(idx, p, q, cfg: RansacConfig) -> RansacResult:
    """Everything after the sampler, from given ``(K, m)`` int32 minimal
    sets — so that a test can hand in the very sets another sampler drew."""
    if cfg.solver not in ("horn", "kabsch"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    N = p.shape[0]
    tau2 = cfg.threshold**2
    # The sentinel padding to a multiple of 128 is kept from the JAX
    # package (no kernel here needs it) so that both score the same
    # correspondence set; idx only addresses rows < N, so the pad
    # sentinels are never selected.
    p_pad, q_pad = pad_correspondences_3d3d(p, q, _ceil128(N))
    if cfg.solver == "horn":
        mom = minimal_moments(idx, p_pad, q_pad)
        # iters=4: HYPOTHESES tolerate sloppy rotations — their deviation
        # from iters=12 is far inside the MSAC threshold, and the winner
        # is re-solved exactly from its inliers by the refit.
        # Non-hypothesis callers keep the default 12.
        T = horn_from_moments(mom, iters=4)  # (K, 4, 4)
    else:
        ix = idx.long()
        T = kabsch(p[ix], q[ix])  # (K, 4, 4)

    # Fast ranking over all K + exact finalist re-score; NaN scores from
    # degenerate minimal sets rank last in both passes.
    _, best_score, T_best = best_pose_3d3d(
        T, p_pad, q_pad, cfg.threshold, return_pose=True
    )

    def residuals(T_cur):
        return torch.sum((q - (p @ T_cur[:3, :3].T + T_cur[:3, 3])) ** 2, dim=-1)

    # Iteratively refit on hard inliers of the current model.
    for _ in range(cfg.refit_rounds):
        w = (residuals(T_best) < tau2).to(p.dtype)
        # Degenerate guard: with <3 inliers keep the current model.
        enough = torch.sum(w) >= 3
        # Horn, not Kabsch: the same least-squares optimum without an SVD.
        T_new = horn_quaternion(
            p, q, weights=torch.where(enough, w, torch.ones_like(w))
        )
        T_best = torch.where(enough, T_new, T_best)

    inliers = residuals(T_best) < tau2
    num = torch.sum(inliers.to(torch.float32))
    return RansacResult(
        pose=T_best,
        inlier_mask=inliers,
        num_inliers=num,
        score=best_score,
        valid=num >= cfg.min_inliers,
        num_hypotheses=idx.shape[0],
    )


def required_hypotheses(
    inlier_ratio: float, sample_size: int, confidence: float
) -> int:
    """Standard RANSAC stopping bound (Chum–Matas use the same form for
    PROSAC's non-randomness test): minimal samples needed so that the
    probability of drawing at least one uncontaminated set reaches
    ``confidence`` at the given inlier ratio. Uniform-sampling bound —
    conservative under PROSAC's quality-ordered sampling."""
    eps = min(max(float(inlier_ratio), 0.0), 1.0 - 1e-9)
    p_good = eps**sample_size
    if p_good <= 1e-12:
        return 1 << 30
    if p_good >= 1.0 - 1e-12:
        return 1
    return int(math.ceil(math.log(1.0 - confidence) / math.log(1.0 - p_good)))


def estimate_pose_3d3d_adaptive(
    generator: torch.Generator, p, q, cfg: RansacConfig = RansacConfig()
) -> RansacResult:
    """Two-round adaptive schedule around :func:`estimate_pose_3d3d`.

    A fixed large K wastes work at high inlier ratios. A
    ``cfg.probe_hypotheses`` probe runs first; its inlier ratio is read
    back (the function's single host synchronisation) and plugged into the
    standard confidence bound — only when the bound demands more samples
    than the probe drew does the full ``cfg.num_hypotheses`` round run (on
    the same generator's stream).

    Returns a :class:`RansacResult` whose ``num_hypotheses`` is the total
    actually scored this call (the per-frame work metric).
    """
    probe_cfg = dataclasses.replace(cfg, num_hypotheses=cfg.probe_hypotheses)
    res = estimate_pose_3d3d(generator, p, q, probe_cfg)
    ratio = float(res.num_inliers) / max(int(p.shape[0]), 1)
    need = required_hypotheses(ratio, cfg.sample_size, cfg.confidence)
    if need <= cfg.probe_hypotheses or cfg.num_hypotheses <= cfg.probe_hypotheses:
        return res
    full = estimate_pose_3d3d(generator, p, q, cfg)
    # num_hypotheses counts candidate POSES scored, so adaptive totals sum
    # the rounds' own fields.
    total = res.num_hypotheses + full.num_hypotheses
    best = full if float(full.num_inliers) >= float(res.num_inliers) else res
    return best._replace(num_hypotheses=total)
