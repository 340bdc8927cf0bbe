"""RANSAC hypothesis scoring: K poses against N correspondences.

Counterpart of the JAX package's ``ops/ransac_score.py``. Three scorers and
the selector built on the first two:

- :func:`score_poses_3d3d` — exact f32 MSAC score and inlier count per pose
  (CUDA kernel ``csrc/score3d.cu`` on the header ``csrc/msac_exact.cuh``,
  replacing the Pallas kernel ``_score3d_kernel``);
- :func:`score_poses_3d3d_quad_fused` — fast MSAC ranking through the
  17-term bilinear form with bf16-rounded operands (CUDA kernel
  ``csrc/quad_bf16_mma.cu``, on the tensor cores, replacing the Pallas kernel
  ``_quad_fused_kernel``);
- :func:`best_pose_3d3d` — fast ranking of all K, exact re-score of a few
  finalists, argmin;
- :func:`score_poses_2d3d` — MSAC score and inlier count per world→camera
  pose against (3D point, normalized-2D observation) pairs (CUDA kernel
  ``csrc/score2d.cu``, the same header with the 2D-3D residual, replacing
  the Pallas kernel ``_score2d_kernel``).

In the JAX package the fast ranking of ``best_pose_3d3d`` is a plain matrix
product whose clip-and-sum epilogue the XLA compiler fuses. PyTorch has no
such compiler pass: a matrix product would write the whole (K, N) residual
matrix to device memory. So here the fused kernel IS the fast pass, and the
exact kernel IS the finalist re-score.

For CUDA tensors each scorer launches its kernel or raises; the plain
versions beside them (:func:`score_poses_3d3d_reference`,
:func:`score_poses_3d3d_quad`, :func:`score_poses_2d3d_reference`) run for
CPU tensors only. No kernel needs K or N to be a multiple of anything.

Padding contract: callers may pad N by appending far-away sentinel
correspondences (``ransac.engine.pad_correspondences_3d3d``) — those always
land outside the inlier threshold, adding the constant ``pad·τ²`` to every
pose's exact MSAC score (ordering preserved) and nothing to inlier counts.
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.ops import _build


def pack_poses(T: torch.Tensor) -> torch.Tensor:
    """``(K, 4, 4)`` poses → ``(K, 12)`` [9 rotation row-major, 3 translation]."""
    K = T.shape[0]
    return torch.cat([T[:, :3, :3].reshape(K, 9), T[:, :3, 3]], dim=-1)


def unpack_pose(row: torch.Tensor) -> torch.Tensor:
    """One ``(12,)`` packed pose row → ``(4, 4)`` homogeneous matrix."""
    T = torch.eye(4, dtype=row.dtype, device=row.device)
    T[:3, :3] = row[:9].reshape(3, 3)
    T[:3, 3] = row[9:12]
    return T


# --------------------------------------------------------------------------
# Exact scoring: residual = ||R p + t - q||
# --------------------------------------------------------------------------


def score_poses_3d3d(T: torch.Tensor, p: torch.Tensor, q: torch.Tensor, threshold: float):
    """Score K poses against N 3D-3D correspondences, in true f32.

    Args: T ``(K, 4, 4)``, p/q ``(N, 3)``. Returns ``(msac_score,
    inlier_count)``, both ``(K,)`` f32. A NaN pose scores NaN.
    """
    return _score_packed(pack_poses(T), p, q, threshold)


def _score_packed(poses: torch.Tensor, p, q, threshold: float):
    """:func:`score_poses_3d3d` on packed ``(K, 12)`` poses."""
    if not poses.is_cuda:
        return _score_packed_reference(poses, p, q, threshold)
    dev = poses.device
    K, N = poses.shape[0], p.shape[0]
    if min(K, N) < 1:
        raise ValueError(f"score_poses_3d3d: empty problem K={K} N={N}")
    _build.check_cuda_input("poses", poses, torch.float32, (K, 12), dev)
    _build.check_cuda_input("p", p, torch.float32, (N, 3), dev)
    _build.check_cuda_input("q", q, torch.float32, (N, 3), dev)
    msac = torch.empty((K,), dtype=torch.float32, device=dev)
    count = torch.empty((K,), dtype=torch.float32, device=dev)
    _build.launch(
        "score_poses_3d3d",
        poses.data_ptr(), p.data_ptr(), q.data_ptr(),
        msac.data_ptr(), count.data_ptr(), K, N, float(threshold) ** 2,
    )
    return msac, count


def _score_packed_reference(poses, p, q, threshold: float):
    R = poses[:, :9].reshape(-1, 3, 3)
    t = poses[:, 9:12]
    pred = torch.einsum("kij,nj->kni", R, p) + t[:, None, :]
    e = torch.sum((pred - q[None]) ** 2, dim=-1)  # (K, N)
    tau2 = threshold * threshold
    # torch.clamp propagates NaN, as the kernel does.
    msac = torch.sum(torch.clamp(e, max=tau2), dim=-1)
    count = torch.sum((e < tau2).to(torch.float32), dim=-1)
    return msac, count


def score_poses_3d3d_reference(T, p, q, threshold: float):
    """Plain PyTorch version of :func:`score_poses_3d3d`. Builds a
    ``(K, N, 3)`` tensor: chunk over K when both are large."""
    return _score_packed_reference(pack_poses(T), p, q, threshold)


# --------------------------------------------------------------------------
# Fast path: MSAC via ONE (K,17)x(17,N) product (quadratic expansion)
# --------------------------------------------------------------------------


def _quad_features(T: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """Factor the squared 3D-3D residual into a 17-dim bilinear form.

    For orthonormal R (|R p| = |p|):

        e(k,n) = |R_k p_n + t_k - q_n|^2
               = |p_n|^2 + |q_n|^2 + |t_k|^2
                 + 2 t_k·(R_k p_n) - 2 (R_k p_n)·q_n - 2 t_k·q_n
               = feat(k) · pn(n)

    with feat(k) = [vec(R_k), 2 R_kᵀt_k, -2 t_k, |t_k|^2, 1]  (K, 17) and
    pn(n) = [-2 q_n⊗p_n, p_n, q_n, 1, |p_n|^2+|q_n|^2]        (17, N).
    """
    K, N = T.shape[0], p.shape[0]
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    feat = torch.cat(
        [
            R.reshape(K, 9),
            2.0 * torch.einsum("kij,ki->kj", R, t),
            -2.0 * t,
            torch.sum(t * t, dim=-1, keepdim=True),
            torch.ones((K, 1), dtype=T.dtype, device=T.device),
        ],
        dim=-1,
    )
    qp = -2.0 * (q[:, :, None] * p[:, None, :]).reshape(N, 9)
    pn = torch.cat(
        [
            qp.T,
            p.T,
            q.T,
            torch.ones((1, N), dtype=p.dtype, device=p.device),
            (torch.sum(p * p, -1) + torch.sum(q * q, -1))[None, :],
        ],
        dim=0,
    )
    return feat, pn


def _quad_scores_reference(feat, pn, threshold: float):
    e = feat.bfloat16().float() @ pn.bfloat16().float()
    # clip, not minimum: squared residuals are nonnegative by construction,
    # but bf16 rounding of the expansion (~coord_scale^2 * 2^-8 absolute)
    # can drive near-zero entries — and the ~1e4 pad sentinels — negative,
    # which min(e, tau2) would inject into the ranking sum as spurious
    # negative terms. torch.clamp propagates NaN, as the kernel does.
    return torch.sum(torch.clamp(e, 0.0, threshold * threshold), dim=1)


def score_poses_3d3d_quad(T, p, q, threshold: float):
    """Plain PyTorch version of :func:`score_poses_3d3d_quad_fused`: the
    operands rounded to bf16, multiplied and accumulated in f32, clipped to
    [0, τ²] and summed over n. It materializes the (K, N) matrix."""
    feat, pn = _quad_features(T, p, q)
    return _quad_scores_reference(feat, pn, threshold)


def score_poses_3d3d_quad_fused(T, p, q, threshold: float):
    """Fast MSAC ranking scores ``(K,)`` for ORTHONORMAL poses.

    ``Σ_n clip(feat_k · pn_n, 0, τ²)`` with both operands rounded to bf16
    (round to nearest even) and f32 accumulation; no inlier counts. The
    scores carry ~1e-2 relative error — ample for candidate RANKING but not
    for exact parity; :func:`best_pose_3d3d` re-scores the top candidates
    exactly before the final argmin. Conditioning: the expansion's error
    grows as coord_scale² × bf16_eps, so keep |p|, |q| under ~10 scene
    units. A NaN pose scores NaN.
    """
    feat, pn = _quad_features(T, p, q)
    return _quad_scores(feat, pn, threshold)


def _quad_scores(feat: torch.Tensor, pn: torch.Tensor, threshold: float):
    """The fused ranking on prebuilt f32 operands ``feat (K, 17)``,
    ``pn (17, N)``."""
    if not feat.is_cuda:
        return _quad_scores_reference(feat, pn, threshold)
    dev = feat.device
    K, N = feat.shape[0], pn.shape[1]
    if min(K, N) < 1:
        raise ValueError(f"score_poses_3d3d_quad_fused: empty problem K={K} N={N}")
    _build.check_cuda_input("feat", feat, torch.float32, (K, 17), dev)
    _build.check_cuda_input("pn", pn, torch.float32, (17, N), dev)
    out = torch.empty((K,), dtype=torch.float32, device=dev)
    _build.launch(
        "score_poses_3d3d_quad_fused",
        feat.data_ptr(), pn.data_ptr(), out.data_ptr(), K, N,
        float(threshold) ** 2,
    )
    return out


def best_pose_3d3d(
    T: torch.Tensor,
    p: torch.Tensor,
    q: torch.Tensor,
    threshold: float,
    top: int = 0,
    impl: str = "auto",
    selection: str = "group",
    return_pose: bool = False,
):
    """Select the best of K poses: fast ranking pass + exact finalist pass.

    ``impl="auto"`` and ``"two_stage"`` (the same here): all K hypotheses
    are ranked by the fused quad-form scorer, then the ``top`` finalists are
    re-scored by the exact f32 scorer and the final argmin is taken over
    exact scores. The true winner is recovered whenever it survives
    finalist ``selection`` under ~1e-2-relative fast scores; if more
    near-ties exist than finalists they are interchangeable for the refit
    that follows (the engine re-derives inliers from the winner exactly).
    ``impl="exact"`` scores all K exactly and skips the fast pass.

    Finalist poses are reconstructed EXACTLY from rows of the (K, 17) quad
    feature matrix (R is columns 0:9 verbatim; t = -0.5 × columns 12:15 —
    both exact in f32), as the JAX package does, so the winning pose is
    bit-identical to what that package returns for the same row.

    ``selection``:

    - ``"group"`` (default) — reshape the (K,) fast scores into ``top``
      contiguous groups and take one argmin per group: sort-free, always
      contains the global fast argmin. Needs ``K % top == 0``; otherwise
      exact top-k is taken;
    - ``"topk"`` — exact ``torch.topk``;
    - ``"approx"`` — the JAX package's bucketed approximate top-k has no
      PyTorch counterpart; exact top-k is taken.

    ``top=0`` (default) scales the finalist window with K —
    ``max(16, K // 1024)`` — so the exact re-score band widens as the
    near-tie population grows at large K.

    NaN scores (degenerate minimal sets) rank last in both passes.
    Returns ``(best_index, best_exact_msac)`` as 0-d tensors (no host
    synchronisation) — plus the winning ``(4, 4)`` pose when
    ``return_pose=True``.
    """
    if impl not in ("auto", "two_stage", "exact"):
        raise ValueError(f"unknown impl {impl!r}")
    if selection not in ("group", "topk", "approx"):
        raise ValueError(f"unknown selection {selection!r}")
    K = T.shape[0]
    if top <= 0:
        top = max(16, K // 1024)
    top = min(top, K)
    inf = float("inf")
    if impl == "exact":
        msac, _ = score_poses_3d3d(T, p, q, threshold)
        msac = torch.where(torch.isnan(msac), inf, msac)
        # Indexed with a (1,) tensor: a 0-d tensor index would be read
        # back to the host, which stalls the stream.
        best = torch.argmin(msac).reshape(1)
        if return_pose:
            return best[0], msac[best][0], T[best][0]
        return best[0], msac[best][0]
    feat, pn = _quad_features(T, p, q)
    fast = _quad_scores(feat, pn, threshold)
    fast = torch.where(torch.isnan(fast), inf, fast)
    if selection == "group" and K % top == 0:
        g = fast.reshape(top, K // top)
        cand = torch.argmin(g, dim=1) + torch.arange(top, device=T.device) * (K // top)
    else:
        cand = torch.topk(fast, top, largest=False).indices
    # Finalist poses from feat rows: R = feat[:, :9] verbatim,
    # t = -0.5 * feat[:, 12:15].
    featc = feat[cand]
    finalists = torch.cat([featc[:, :9], -0.5 * featc[:, 12:15]], dim=-1)
    exact, _ = _score_packed(finalists, p, q, threshold)
    exact = torch.where(torch.isnan(exact), inf, exact)
    j = torch.argmin(exact).reshape(1)
    if return_pose:
        return cand[j][0], exact[j][0], unpack_pose(finalists[j][0])
    return cand[j][0], exact[j][0]


# --------------------------------------------------------------------------
# 2D-3D scoring: residual = || proj(R X + t) - obs ||  (normalized plane)
# --------------------------------------------------------------------------


def score_poses_2d3d(T: torch.Tensor, points: torch.Tensor, obs: torch.Tensor, threshold: float):
    """Score K world→camera poses against N (3D point, normalized-2D) pairs.

    Args: T ``(K, 4, 4)`` — or packed ``(K, 12)`` rows (:func:`pack_poses`
    layout); ``points`` ``(N, 3)``, ``obs`` ``(N, 2)``. Returns
    ``(msac_score, inlier_count)``, both ``(K,)`` f32. A point behind the
    camera (depth < 1e-6) is an outlier: it adds τ² to the score and nothing
    to the count, which is what the pad rows of
    ``ransac.engine.pad_points_obs_2d3d`` rely on. A NaN pose scores NaN.
    """
    poses = T if T.dim() == 2 else pack_poses(T)
    if not poses.is_cuda:
        return score_poses_2d3d_reference(poses, points, obs, threshold)
    dev = poses.device
    K, N = poses.shape[0], points.shape[0]
    if min(K, N) < 1:
        raise ValueError(f"score_poses_2d3d: empty problem K={K} N={N}")
    _build.check_cuda_input("poses", poses, torch.float32, (K, 12), dev)
    _build.check_cuda_input("points", points, torch.float32, (N, 3), dev)
    _build.check_cuda_input("obs", obs, torch.float32, (N, 2), dev)
    msac = torch.empty((K,), dtype=torch.float32, device=dev)
    count = torch.empty((K,), dtype=torch.float32, device=dev)
    _build.launch(
        "score_poses_2d3d",
        poses.data_ptr(), points.data_ptr(), obs.data_ptr(),
        msac.data_ptr(), count.data_ptr(), K, N, float(threshold) ** 2,
    )
    return msac, count


def score_poses_2d3d_reference(T, points, obs, threshold: float):
    """Plain PyTorch version of :func:`score_poses_2d3d` (``(K, 4, 4)`` or
    packed ``(K, 12)`` poses). Builds a ``(K, N, 3)`` tensor: chunk over K
    when both are large."""
    if T.dim() == 2:
        R = T[:, :9].reshape(-1, 3, 3)
        t = T[:, 9:12]
    else:
        R = T[:, :3, :3]
        t = T[:, :3, 3]
    Xc = torch.einsum("kij,nj->kni", R, points) + t[:, None, :]
    z = Xc[..., 2]
    behind = z < 1e-6
    proj = Xc[..., :2] / torch.where(behind, 1.0, z)[..., None]
    e = torch.sum((proj - obs[None]) ** 2, dim=-1)
    tau2 = threshold * threshold
    e = torch.where(behind, 4.0 * tau2, e)
    # torch.clamp propagates NaN, as the kernel does.
    msac = torch.sum(torch.clamp(e, max=tau2), dim=-1)
    count = torch.sum((e < tau2).to(torch.float32), dim=-1)
    return msac, count
