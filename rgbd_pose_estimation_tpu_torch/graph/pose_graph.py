"""Keyframe SE(3) pose-graph optimization (configuration 4,
``configs/config4_pose_graph.yaml``).

Counterpart of the JAX package's ``graph/pose_graph.py``. ``cfg.iters``
Gauss-Newton iterations, each:

  batched edge residuals r_e = log(T_meas^-1 T_i T_j^-1)
  block normal equations over the keyframes (dense ≤ ``dense_max_nodes``)
  damped Cholesky solve (or block-Jacobi PCG) + per-node right retraction
  T_i ← T_i exp(δ_i)

Jacobians use the small-residual approximation J_i = Ad(T_j) = -J_j (exact
as r→0); node 0 is gauge-fixed with a strong prior. Nothing in the
optimizer reads a value back to the host.

The reference sums each edge's blocks into its nodes with scatter-adds;
on the card those would be float atomics, whose order (and so the last
bits) changes from run to run. Here every such sum is a product with the
(K, E) incidence matrix of the graph (entries 0, +1, -1; TF32 is off
package-wide), which gives the same bits on every run.

Loop closures: keyframe pairs that are spatially near (or look alike) but
temporally far are verified by dense ICP between their stored pyramids,
and accepted edges get the loop information weight.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.lie import (
    se3_adjoint,
    se3_exp,
    se3_inverse,
    se3_log,
)
from rgbd_pose_estimation_tpu_torch.utils.config import PoseGraphConfig


_GAUGE_W = 1e6  # strong prior pinning node 0 (the gauge freedom)


def _incidence(K: int, edges: torch.Tensor, dtype) -> torch.Tensor:
    """(K, E) one-hot: entry [k, e] is 1 where edge e touches node k. Made
    by a comparison (``one_hot`` checks its range on the host)."""
    nodes = torch.arange(K, device=edges.device)
    return (nodes[:, None] == edges[None, :]).to(dtype)


def _edge_terms(T, edges_i, edges_j, T_meas_inv, weights):
    """Batched edge residuals + weighted Gauss-Newton blocks.

    J_i = Ad(T_j) = -J_j (small-residual approximation, exact as r→0).
    Returns ``(r (E,6), AtA (E,6,6) = JᵀwJ, Atr (E,6) = Jᵀwr)``.
    """
    Ti = T[edges_i]  # (E, 4, 4)
    Tj = T[edges_j]
    M = T_meas_inv @ Ti @ se3_inverse(Tj)
    r = se3_log(M)  # (E, 6)
    A = se3_adjoint(Tj)  # (E, 6, 6)
    w = weights[:, None, None]
    AtA = torch.einsum("eki,ekj->eij", A, A) * w
    Atr = torch.einsum("eki,ek->ei", A, r) * weights[:, None]
    return r, AtA, Atr


def _gather_b(D, Atr):
    """b = Σ_e (+Atr_e at node i, −Atr_e at node j): ``D`` is the signed
    incidence S_i − S_j."""
    return D @ Atr


def _solve_dense(K, D, AtA, b, damping):
    """Materialize the (6K, 6K) normal equations; Cholesky solve.

    H[k, l] = Σ_e D[k, e] D[l, e] AtA_e: +AtA at (i, i) and (j, j), −AtA at
    (i, j) and (j, i), as the reference's four scatter-adds. Exact and
    fastest up to a few hundred keyframes; O(K²) memory caps it there.
    """
    E = AtA.shape[0]
    G = D[:, :, None] * AtA.reshape(1, E, 36)  # (K, E, 36)
    H = (D @ G.permute(1, 0, 2).reshape(E, K * 36)).reshape(K, K, 6, 6)
    H[0, 0] += _GAUGE_W * torch.eye(6, dtype=AtA.dtype, device=AtA.device)
    Hd = H.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    Hd = Hd + damping * torch.eye(K * 6, dtype=AtA.dtype, device=AtA.device)
    # cholesky_ex does not check its status on the host (which would wait for
    # the stream), nor do the two triangular solves.
    L, _ = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, -b.reshape(K * 6, 1), upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True).reshape(K, 6)


def _solve_pcg(K, edges_i, edges_j, D, S, AtA, b, damping, pcg_iters):
    """Matrix-free block-Jacobi-preconditioned CG.

    The Hessian is never materialized: each matvec is one gather, one
    batched 6×6 product and one incidence product over the edge list —
    O(E·36) work and memory. Block-Jacobi (per-node 6×6 inverse)
    preconditioning handles the different edge counts per node. A fixed
    number of iterations, and no value read back. ``S`` is S_i + S_j.
    """
    eye6 = torch.eye(6, dtype=AtA.dtype, device=AtA.device)
    E = AtA.shape[0]
    Hdiag = (S @ AtA.reshape(E, 36)).reshape(K, 6, 6)
    Hdiag = Hdiag + damping * eye6
    Hdiag[0] += _GAUGE_W * eye6
    Minv, _ = torch.linalg.inv_ex(Hdiag)  # batched 6×6 block-Jacobi preconditioner

    def matvec(x):  # (K, 6) → (K, 6)
        d = x[edges_i] - x[edges_j]
        yd = torch.einsum("eij,ej->ei", AtA, d)
        y = D @ yd
        y = y + damping * x
        y[0] += _GAUGE_W * x[0]
        return y

    rhs = -b
    x = torch.zeros_like(rhs)
    rr = rhs
    z = torch.einsum("kij,kj->ki", Minv, rhs)
    p = z
    for _ in range(pcg_iters):
        Ap = matvec(p)
        rz = torch.sum(rr * z)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = torch.einsum("kij,kj->ki", Minv, rr)
        beta = torch.sum(rr * z) / torch.clamp(rz, min=1e-20)
        p = z + beta * p
    return x


def optimize_pose_graph(
    poses: torch.Tensor,  # (K, 4, 4) world→camera initial estimates
    edges_i: torch.Tensor,  # (E,) int
    edges_j: torch.Tensor,  # (E,) int
    T_meas: torch.Tensor,  # (E, 4, 4): measured camera-j → camera-i transform
    weights: torch.Tensor,  # (E,) information weights
    cfg: PoseGraphConfig = PoseGraphConfig(),
):
    """Gauss-Newton over the keyframe graph, on the tensors' device.

    Backend per ``cfg.solver``: dense Cholesky (exact, K ≤ a few hundred)
    or matrix-free block-Jacobi PCG (long sequences); "auto" switches on
    ``cfg.dense_max_nodes``. Both run the identical GN outer loop. Returns
    ``(T_opt (K, 4, 4), costs (iters,))``.
    """
    K = poses.shape[0]
    use_dense = cfg.solver == "dense" or (
        cfg.solver == "auto" and K <= cfg.dense_max_nodes
    )
    if not use_dense and cfg.solver not in ("pcg", "auto"):
        raise ValueError(f"unknown pose-graph solver: {cfg.solver!r}")
    T_meas_inv = se3_inverse(T_meas)
    edges_i, edges_j = edges_i.long(), edges_j.long()
    S_i = _incidence(K, edges_i, poses.dtype)
    S_j = _incidence(K, edges_j, poses.dtype)
    D = S_i - S_j

    T = poses
    costs = []
    for _ in range(cfg.iters):
        r, AtA, Atr = _edge_terms(T, edges_i, edges_j, T_meas_inv, weights)
        b = _gather_b(D, Atr)
        if use_dense:
            delta = _solve_dense(K, D, AtA, b, cfg.damping)
        else:
            delta = _solve_pcg(K, edges_i, edges_j, D, S_i + S_j, AtA, b,
                               cfg.damping, cfg.pcg_iters)
        costs.append(torch.sum(weights * torch.sum(r * r, dim=-1)))
        T = T @ se3_exp(delta)
    return T, torch.stack(costs)


# Depth-thumbnail descriptor shape (rows, cols).
DESCRIPTOR_SHAPE = (12, 16)
DESCRIPTOR_DIM = DESCRIPTOR_SHAPE[0] * DESCRIPTOR_SHAPE[1]


def frame_descriptor(frame) -> np.ndarray:
    """Tiny appearance descriptor of an IcpFrame: normalized depth thumbnail.

    Computed on the host from the coarsest stored pyramid level — depth-only,
    so it works for pure-depth odometry too. Mean/std normalization makes
    the cosine similarity invariant to absolute scene distance.
    """
    z = frame.vertices[-1][..., 2]
    z = z.cpu().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)  # coarsest depth
    h, w = z.shape
    th, tw = DESCRIPTOR_SHAPE
    ys = (np.arange(th) * h) // th
    xs = (np.arange(tw) * w) // tw
    thumb = z[np.ix_(ys, xs)].astype(np.float32).reshape(-1)
    thumb = thumb - thumb.mean()
    n = np.linalg.norm(thumb)
    return thumb / n if n > 1e-9 else thumb


def keyframe_descriptor(kf) -> np.ndarray:
    """:func:`frame_descriptor` of ``kf.frame``, cached on the Keyframe."""
    if getattr(kf, "descriptor", None) is not None:
        return kf.descriptor
    desc = frame_descriptor(kf.frame)
    kf.descriptor = desc
    return desc


def loop_candidates(
    kfs,
    max_dist: float,
    min_gap: int,
    max_candidates: int,
    appearance_top: int = 10,
    appearance_min_sim: float = 0.85,
):
    """Candidate keyframe pairs for loop closure, two complementary cues.

    (1) *Geometric*: estimated camera centers within ``max_dist`` — precise
    when drift is small. (2) *Appearance*: most-similar depth thumbnails
    (cosine ≥ ``appearance_min_sim``) — catches loops the drifted poses
    miss. Both require a temporal gap of ``min_gap`` keyframes. Returns
    index pairs, geometric candidates first (sorted by distance).
    """
    K = len(kfs)
    centers = np.stack([-k.pose[:3, :3].T @ k.pose[:3, 3] for k in kfs])
    d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    ia, ib = np.triu_indices(K, k=min_gap + 1)
    near = d[ia, ib] < max_dist
    order = np.argsort(d[ia, ib][near], kind="stable")
    pairs = list(zip(ia[near][order].tolist(), ib[near][order].tolist()))
    seen = set(pairs)

    D = np.stack([keyframe_descriptor(k) for k in kfs])  # (K, d)
    sim = D @ D.T
    iu = np.triu_indices(K, k=min_gap + 1)
    order = np.argsort(-sim[iu])[:appearance_top]
    for o in order:
        a, b = int(iu[0][o]), int(iu[1][o])
        if sim[a, b] >= appearance_min_sim and (a, b) not in seen:
            pairs.append((a, b))
            seen.add((a, b))
    return pairs[:max_candidates]


def _inverse_np(poses: np.ndarray) -> np.ndarray:
    """Rigid inverses of ``(..., 4, 4)`` host poses, in float32 on the CPU."""
    return se3_inverse(torch.from_numpy(np.array(poses, np.float32))).numpy()


def detect_loop_closures(
    odo,
    max_dist: float = 0.5,
    min_gap: int = 3,
    max_candidates: int = 20,
    min_overlap: float = 0.3,
):
    """Geometrically-verified loop closures between stored keyframes.

    Candidates come from :func:`loop_candidates` (center proximity +
    appearance similarity). Verification: dense ICP between the stored
    pyramids of every candidate (``icp/dense.py::icp_track_batch``), and
    one read-back for all of them. Accepted when the association overlap
    stays above ``min_overlap``. Returns ``[(kf_a, kf_b, T_b_to_a,
    overlap), ...]`` with indices into ``odo.keyframes``.

    The reference pads the batch to a multiple of 4 by repeating pair 0, so
    that its compiler sees few shapes; here only the real pairs are tracked,
    which changes no output.
    """
    from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame, icp_track_batch

    kfs = odo.keyframes
    if len(kfs) < min_gap + 2:
        return []
    pairs = loop_candidates(kfs, max_dist, min_gap, max_candidates)
    if not pairs:
        return []
    device = kfs[0].frame.vertices[0].device
    # Initialize from current pose estimates: T_b→a = T_a T_b^-1.
    inv_poses = _inverse_np(np.stack([k.pose for k in kfs], 0))
    T_init = torch.from_numpy(
        np.stack([kfs[a].pose @ inv_poses[b] for a, b in pairs], 0).astype(np.float32)
    ).to(device)

    def stack(frames):
        return IcpFrame(*(
            tuple(torch.stack(level) for level in zip(*leaves))
            for leaves in zip(*frames)
        ))

    src = stack([kfs[b].frame for _, b in pairs])
    tgt = stack([kfs[a].frame for a, _ in pairs])
    T_rel, stats = icp_track_batch(odo.cam, odo.icp_cfg, T_init, src, tgt)
    valid0 = torch.sum(torch.sum(src.normals[0] ** 2, dim=-1) > 0.5, dim=(1, 2))
    host = torch.cat([T_rel.reshape(-1, 16), stats[:, 1:2],
                      valid0[:, None].to(T_rel.dtype)], dim=1).cpu().numpy()
    overlap = host[:, 16] / np.maximum(np.asarray(host[:, 17], np.float64), 1.0)
    T_rel = host[:, :16].reshape(-1, 4, 4)
    return [
        (a, b, T_rel[k], float(overlap[k]))
        for k, (a, b) in enumerate(pairs)
        if overlap[k] > min_overlap
    ]


def keyframe_graph(odo, loops, cfg: PoseGraphConfig = PoseGraphConfig()):
    """The keyframe graph of ``odo`` (odometry edges, then the ``loops`` of
    :func:`detect_loop_closures`) as the arguments of
    :func:`optimize_pose_graph` on the keyframes' device: ``(poses, edges_i,
    edges_j, T_meas, weights)``."""
    kfs = odo.keyframes
    kf_index_of = {k.index: n for n, k in enumerate(kfs)}
    edges_i, edges_j, T_meas, weights = [], [], [], []
    # Odometry edges: (frame j=new kf) → (frame i=old kf) relative transforms.
    for i_frame, j_frame, T_rel in odo.odom_edges:
        edges_i.append(kf_index_of[i_frame])
        edges_j.append(kf_index_of[j_frame])
        T_meas.append(T_rel)
        weights.append(1.0 / cfg.odom_sigma**2)
    for a, b, T_rel, overlap in loops:
        edges_i.append(a)
        edges_j.append(b)
        T_meas.append(T_rel)
        weights.append(overlap / cfg.loop_sigma**2)
    device = kfs[0].frame.vertices[0].device
    ship = lambda a, dtype: torch.from_numpy(np.asarray(a, dtype)).to(device)
    return (
        ship(np.stack([k.pose for k in kfs]), np.float32),
        ship(edges_i, np.int32),
        ship(edges_j, np.int32),
        ship(np.stack(T_meas), np.float32),
        ship(weights, np.float32),
    )


def optimize_trajectory(odo, cfg: PoseGraphConfig = PoseGraphConfig()):
    """Configuration 4: keyframe graph (odometry + loop edges) → GN →
    corrected full trajectory, on the odometry's device.

    Non-keyframe poses are corrected rigidly with their parent keyframe:
    each frame keeps its odometry-relative transform to the nearest earlier
    keyframe, re-anchored on that keyframe's optimized pose.
    """
    kfs = odo.keyframes
    if len(kfs) < 2:
        return odo.trajectory()
    graph = keyframe_graph(odo, detect_loop_closures(odo), cfg)
    T_opt, _ = optimize_pose_graph(*graph, cfg)
    T_opt = T_opt.cpu().numpy()

    # Re-anchor every frame on its parent keyframe's optimized pose.
    kf_indices = [k.index for k in kfs]
    kf_inv = _inverse_np(np.stack([k.pose for k in kfs]))
    out = []
    cur_kf = 0
    for f, pose in enumerate(odo.poses):
        while cur_kf + 1 < len(kf_indices) and kf_indices[cur_kf + 1] <= f:
            cur_kf += 1
        # pose = T_f (world→cam). Relative to keyframe: T_f·T_kf^-1 stays.
        rel = pose @ kf_inv[cur_kf]
        out.append(rel @ T_opt[cur_kf])
    return np.stack(out)
