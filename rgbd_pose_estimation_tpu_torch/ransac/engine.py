"""Batched RANSAC/PROSAC engine: hypothesize → score → refit.

Counterpart of the JAX package's ``ransac/engine.py``. A fixed batch of K
hypotheses is drawn at once and solved at once, all of them are scored
against all N correspondences, and a refit on the winner's inliers finishes
the job. No estimator reads a value back to the host, so a whole estimate
is queued on the stream without a stall; the adaptive wrappers read one
number back between their two rounds.

There is ONE algorithm per estimator (the JAX package's production
branch); the only choice made here is kernel or plain version, by the
device of the tensors: on CUDA tensors the CUDA kernels of ``ops`` are
launched, on CPU tensors their plain versions run in the same structure.

Entry points:

- :func:`estimate_pose_3d3d` (+ ``_adaptive``) — depth-to-depth
  correspondences: hypotheses from minimal-set moments, fast ranking of all
  K, exact re-score of a few finalists, weighted Horn refit;
- :func:`estimate_pose_3d3d_normals` — the same scoring and refit from
  2-correspondence point+normal samples (``solvers/normals.py``);
- :func:`estimate_pose_2d3d` (+ ``_adaptive``) — 2D-3D via P3P: all quartic
  roots of every minimal sample are scored as independent hypotheses (4K
  poses), which subsumes root disambiguation — the scoring argmin *is* the
  disambiguator; the winner is polished by damped Gauss-Newton.

Each estimator is its sampler call plus a ``_estimate_..._from_samples``
function that takes the ``(K, m)`` minimal sets, so that a test can hand in
the very sets another sampler drew.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch

from rgbd_pose_estimation_tpu_torch.ops.horn import horn_refit_3d3d
from rgbd_pose_estimation_tpu_torch.ops.moments import minimal_moments
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import (
    best_pose_3d3d,
    pack_poses,
    score_poses_2d3d,
    unpack_pose,
)
from rgbd_pose_estimation_tpu_torch.ransac.prosac import sample_minimal_sets
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import (
    horn_from_moments,
    horn_quaternion,
    kabsch,
)
from rgbd_pose_estimation_tpu_torch.solvers.normals import ao_2pt_normals
from rgbd_pose_estimation_tpu_torch.solvers.p3p import p3p
from rgbd_pose_estimation_tpu_torch.solvers.pnp import pnp_refine
from rgbd_pose_estimation_tpu_torch.utils.config import RansacConfig


class RansacResult(typing.NamedTuple):
    pose: torch.Tensor  # (4, 4) best pose
    inlier_mask: torch.Tensor  # (N,) bool under the best pose
    num_inliers: torch.Tensor  # () f32
    score: torch.Tensor  # () MSAC score of the best hypothesis (pre-refit)
    valid: torch.Tensor  # () bool — enough inliers found
    # Static: candidate poses scored against all correspondences — the one
    # metric definition (utils/metrics.py HYPOTHESES_DEFINITION): P3P
    # samples count their 4 roots, adaptive schedules sum their rounds.
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


def pad_points_obs_2d3d(points, obs, n_target: int):
    """Pad (points, obs) to ``n_target`` with always-outlier sentinels: the
    pad points sit at distinct negative depths (behind every plausible
    camera), which the scorers and refit already treat as outliers."""
    n = points.shape[0]
    pad = n_target - n
    if pad <= 0:
        return points, obs
    i = torch.arange(pad, dtype=points.dtype, device=points.device)
    pts_pad = torch.stack(
        [1e4 + 137.0 * i, -2e4 - 91.0 * i, -(1e4 + 53.0 * i)], dim=-1
    )
    obs_pad = torch.stack([50.0 + i, -50.0 - 2.0 * i], dim=-1)
    return torch.cat([points, pts_pad]), torch.cat([obs, obs_pad])


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
    return _refit_3d3d(T_best, best_score, p, q, cfg, idx.shape[0])


def _refit_3d3d(T_best, best_score, p, q, cfg: RansacConfig, num_hypotheses: int):
    """The end shared by the 3D-3D estimators: ``cfg.refit_rounds`` weighted
    Horn refits on the hard inliers of the current model, then the result.
    For CUDA tensors the whole refit is one launch of
    ``horn_refit_3d3d_kernel`` (``ops/horn.py``); for CPU tensors the plain
    version, :func:`_refit_3d3d_reference`, runs."""
    if not p.is_cuda:
        return _refit_3d3d_reference(T_best, best_score, p, q, cfg, num_hypotheses)
    pose, inliers, num, valid = horn_refit_3d3d(
        T_best, p, q, cfg.threshold**2, cfg.refit_rounds, cfg.min_inliers
    )
    return RansacResult(
        pose=pose,
        inlier_mask=inliers,
        num_inliers=num,
        score=best_score,
        valid=valid,
        num_hypotheses=num_hypotheses,
    )


def _refit_3d3d_reference(T_best, best_score, p, q, cfg: RansacConfig, num_hypotheses: int):
    """Plain PyTorch version of :func:`_refit_3d3d`, on any device."""
    tau2 = cfg.threshold**2

    def residuals(T_cur):
        return torch.sum((q - (p @ T_cur[:3, :3].T + T_cur[:3, 3])) ** 2, dim=-1)

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
        num_hypotheses=num_hypotheses,
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


def estimate_pose_3d3d_normals(
    generator: torch.Generator, p, q, n_p, n_q, cfg: RansacConfig = RansacConfig()
) -> RansacResult:
    """Robust rigid pose from point+normal correspondences (2-pt samples).

    Uses the reduced 2-correspondence minimal solver (``solvers/normals.py``):
    at inlier ratio w the chance of an uncontaminated sample is w² instead
    of w³, so far fewer hypotheses are needed under heavy contamination.
    Scoring/refit are identical to :func:`estimate_pose_3d3d` (normals are
    only used for hypothesis generation).
    """
    idx = sample_minimal_sets(
        generator, p.shape[0], cfg.num_hypotheses, 2, cfg.prosac, device=p.device
    )  # (K, 2)
    return _estimate_3d3d_normals_from_samples(idx, p, q, n_p, n_q, cfg)


def _estimate_3d3d_normals_from_samples(idx, p, q, n_p, n_q, cfg: RansacConfig):
    """Everything after the sampler, from given ``(K, 2)`` int32 samples."""
    ix = idx.long()
    T = ao_2pt_normals(p[ix], q[ix], n_p[ix], n_q[ix])  # (K, 4, 4), R orthonormal
    p_pad, q_pad = pad_correspondences_3d3d(p, q, _ceil128(p.shape[0]))
    _, best_score, T_best = best_pose_3d3d(
        T, p_pad, q_pad, cfg.threshold, return_pose=True
    )
    return _refit_3d3d(T_best, best_score, p, q, cfg, idx.shape[0])


def estimate_pose_2d3d(
    generator: torch.Generator, points, obs, cfg: RansacConfig = RansacConfig(),
    refine_iters: int = 8,
) -> RansacResult:
    """Robust world→camera pose from N (3D point, normalized-2D obs) pairs.

    ``points`` ``(N, 3)`` and ``obs`` ``(N, 2)`` f32 on one device,
    ``generator`` on the same. P3P hypotheses: every real quartic root of
    every minimal sample enters the scoring batch (4K poses); invalid roots
    get +inf score. The winner is polished by damped Gauss-Newton on its
    inliers.
    """
    idx = sample_minimal_sets(
        generator, points.shape[0], cfg.num_hypotheses, 3, cfg.prosac,
        device=points.device,
    )  # (K, 3)
    return _estimate_2d3d_from_samples(idx, points, obs, cfg, refine_iters)


def _minimal_rays(idx, points, obs):
    """The ``(K, 3, 3)`` points of ``(K, 3)`` minimal samples and the unit
    bearing rays ``(K, 3, 3)`` of their observations."""
    ix = idx.long()
    om = obs[ix]  # (K, 3, 2)
    rays = torch.cat([om, torch.ones_like(om[..., :1])], dim=-1)
    return points[ix], rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


def _pack_root_poses(T_roots, valid):
    """``(K, 4, 4, 4)`` root poses → the packed ``(4K, 12)`` rows the scorer
    reads, invalid roots replaced by the identity (finite math; the caller
    sets their score to +inf)."""
    P_all = pack_poses(T_roots.reshape(-1, 4, 4))
    # The identity row is filled on the device: a tensor made from a Python
    # list would be copied from the host, and that copy waits for the stream.
    ident = torch.zeros(12, dtype=P_all.dtype, device=P_all.device)
    ident[0:9:4].fill_(1.0)
    return torch.where(valid.reshape(-1, 1), P_all, ident)


def _best_root_pose(P_all, valid_all, points, obs, threshold: float):
    """Score all packed root poses and return ``(pose, score)`` of the best
    valid one. NaN scores of degenerate samples rank last."""
    msac, _ = score_poses_2d3d(P_all, points, obs, threshold)
    msac = torch.where(valid_all & ~torch.isnan(msac), msac, math.inf)
    # Indexed with a (1,) tensor: a 0-d tensor index would be read back to
    # the host, which stalls the stream.
    best = torch.argmin(msac).reshape(1)
    return unpack_pose(P_all[best][0]), msac[best][0]


def _estimate_2d3d_from_samples(
    idx, points, obs, cfg: RansacConfig, refine_iters: int = 8
) -> RansacResult:
    """Everything after the sampler, from given ``(K, 3)`` int32 samples."""
    K = idx.shape[0]
    tau2 = cfg.threshold**2
    T_roots, valid = p3p(*_minimal_rays(idx, points, obs))  # (K, 4, 4, 4), (K, 4)
    P_all = _pack_root_poses(T_roots, valid)

    # The sentinel padding to a multiple of 128 is kept from the JAX package
    # (the kernel here does not need it) so that both score the same rows.
    pts_pad, obs_pad = pad_points_obs_2d3d(points, obs, _ceil128(points.shape[0]))
    T_best, best_score = _best_root_pose(
        P_all, valid.reshape(K * 4), pts_pad, obs_pad, cfg.threshold
    )

    def inlier_w(T_cur):
        Xc = points @ T_cur[:3, :3].T + T_cur[:3, 3]
        z = torch.clamp(Xc[:, 2], min=1e-6)
        e = torch.sum((Xc[:, :2] / z[:, None] - obs) ** 2, dim=-1)
        e = torch.where(Xc[:, 2] < 1e-6, math.inf, e)
        return (e < tau2).to(points.dtype)

    w = inlier_w(T_best)
    T_ref = pnp_refine(T_best, points, obs, weights=w, iters=refine_iters)
    # Keep the refinement only if it didn't lose inliers (robustness guard).
    w_ref = inlier_w(T_ref)
    better = torch.sum(w_ref) >= torch.sum(w)
    T_best = torch.where(better, T_ref, T_best)

    inliers = inlier_w(T_best) > 0
    num = torch.sum(inliers.to(torch.float32))
    return RansacResult(
        pose=T_best,
        inlier_mask=inliers,
        num_inliers=num,
        score=best_score,
        valid=num >= cfg.min_inliers,
        num_hypotheses=K * 4,
    )


def estimate_pose_2d3d_adaptive(
    generator: torch.Generator, points, obs, cfg: RansacConfig = RansacConfig(),
    refine_iters: int = 8,
) -> RansacResult:
    """Two-round adaptive schedule around :func:`estimate_pose_2d3d` (same
    contract as :func:`estimate_pose_3d3d_adaptive`). The probe draws
    ``max(cfg.probe_hypotheses, 64)`` samples, and the bound is taken for a
    sample size of 3."""
    probe_cfg = dataclasses.replace(
        cfg, num_hypotheses=max(cfg.probe_hypotheses, 64)
    )
    res = estimate_pose_2d3d(generator, points, obs, probe_cfg, refine_iters)
    ratio = float(res.num_inliers) / max(int(points.shape[0]), 1)
    need = required_hypotheses(ratio, 3, cfg.confidence)
    if need <= probe_cfg.num_hypotheses or cfg.num_hypotheses <= probe_cfg.num_hypotheses:
        return res
    full = estimate_pose_2d3d(generator, points, obs, cfg, refine_iters)
    total = res.num_hypotheses + full.num_hypotheses
    best = full if float(full.num_inliers) >= float(res.num_inliers) else res
    return best._replace(num_hypotheses=total)
