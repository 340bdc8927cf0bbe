"""Configuration 5 end to end on a mesh: one call wiring every mechanism.

Counterpart of the JAX package's ``models/distributed_slam.py``:

1. **Sequence-parallel front-end**: the video splits into overlapping
   chunks tracked independently (``models/sequence_parallel.py``);
2. **Ring loop-candidate search**: keyframe depth-thumbnail descriptors are
   scored all-pairs by the ring (``parallel/sharded.py::ring_similarity``);
3. **Batched geometric verification**: every candidate pair tracked by the
   fused ICP step, the pair axis split over the ranks
   (``parallel/sharded.py::icp_verify_sharded``);
4. **Pose-graph optimization** over the keyframes;
5. **Blocked sharded BA**: landmark clustering, the all-to-all relayout
   into rank-local blocks, ``ba_solve_blocked`` with O(C) collectives a CG
   matvec.

A mesh is a ``torch.distributed`` group, one rank a device
(``parallel/mesh.py``), so the reference's process count and index are the
group's size and this rank. Every per-keyframe and per-pair stage is split
over the ranks: each rank tracks its own chunks, builds ICP pyramids and
descriptors only for its contiguous keyframe span (the descriptors joined
by one ``allgather_hosts``), builds and tracks only its own rows of the
verification batch (``put_process_rows``), and detects and matches BA
features only on its share of keyframes and pairs (``ba/build.py``). What
stays replicated (candidate selection, the anchor and keyframe pose graphs,
the union-find track building) is O(K) host arithmetic on identical
exchanged inputs. On a mesh of one rank every stage runs whole in this
process.

The single-device twin is ``models/slam.py::Slam``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ba.build import build_ba_problem
from rgbd_pose_estimation_tpu_torch.ba.cluster import block_ba_problem_device
from rgbd_pose_estimation_tpu_torch.ba.schur import prune_observations, with_odometry_priors
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.graph.pose_graph import (
    DESCRIPTOR_DIM,
    _inverse_np,
    frame_descriptor,
    optimize_pose_graph,
)
from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame, make_icp_frame
from rgbd_pose_estimation_tpu_torch.models.sequence_parallel import sequence_parallel_odometry
from rgbd_pose_estimation_tpu_torch.parallel.mesh import (
    REPLICATED,
    allgather_hosts,
    fetch_global,
    partition_bounds,
    put_global,
    put_process_rows,
)
from rgbd_pose_estimation_tpu_torch.parallel.sharded import (
    ba_solve_blocked,
    icp_verify_sharded,
    layout_slots,
    ring_similarity,
)
from rgbd_pose_estimation_tpu_torch.parallel.specs import ROWS
from rgbd_pose_estimation_tpu_torch.utils.config import PipelineConfig
from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger


def _procs(mesh):
    """The reference's ``(process_count, process_index)``: one rank a process."""
    return (mesh.size, mesh.rank) if mesh.size > 1 else (1, 0)


def _pad_pow2_rows(x: np.ndarray, multiple: int):
    k = x.shape[0]
    pad = (-k) % multiple
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x, k


def ring_loop_candidates(
    mesh,
    descriptors: np.ndarray,  # (K, D) unit-norm keyframe descriptors
    min_gap: int,
    max_candidates: int,
    min_sim: float = 0.85,
):
    """Loop-closure candidate pairs from the ring similarity.

    The all-pairs (K, K) similarity is computed on the mesh, a ``(K/n,
    K/n)`` tile a ring step on each rank; the small top-k filter runs on
    the host, the same on every rank. The descriptors are padded to a
    multiple of the mesh size with zero rows (cosine 0: never a
    candidate)."""
    D, k_real = _pad_pow2_rows(descriptors.astype(np.float32), mesh.size)
    sim_dev = ring_similarity(mesh, put_global(mesh, ROWS, D))
    sim = fetch_global(mesh, ROWS, sim_dev)[:k_real, :k_real]
    ia, ib = np.triu_indices(k_real, k=min_gap + 1)
    vals = sim[ia, ib]
    order = np.argsort(-vals)[:max_candidates]
    return [(int(ia[o]), int(ib[o])) for o in order if vals[o] >= min_sim]


class _Select:
    """Lazy index-remapped view of a sequence (keeps lazy loaders lazy)."""

    def __init__(self, base, ids):
        self._base = base
        self._ids = list(ids)

    def __len__(self):
        return len(self._ids)

    def __getitem__(self, i):
        return self._base[self._ids[i]]


def _device_depth(depth, device) -> torch.Tensor:
    if isinstance(depth, torch.Tensor):
        return depth.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(depth, np.float32)).to(device)


class _FrameCache:
    """ICP pyramids of keyframes, built on demand on ``device`` (per rank).

    Each rank builds only the pyramids its own split stages touch: its
    descriptor span and the keyframes its verification rows reference;
    ``built`` is the per-rank scaling observable.
    """

    def __init__(self, cam, depths, kf_idx, icp_cfg, device):
        self._cam = cam
        self._depths = depths
        self._kf_idx = kf_idx
        self._cfg = icp_cfg
        self._device = device
        self._cache: dict = {}

    def __call__(self, pos: int):
        if pos not in self._cache:
            depth = _device_depth(self._depths[self._kf_idx[pos]], self._device)
            self._cache[pos] = make_icp_frame(self._cam, depth, self._cfg)
        return self._cache[pos]

    @property
    def built(self) -> int:
        return len(self._cache)


def _local_span(n: int, procs: int, pid: int):
    b = partition_bounds(n, procs)
    return int(b[pid]), int(b[pid + 1])


def _stack_frames(frames) -> IcpFrame:
    """One ``IcpFrame`` whose leaves stack ``frames``' along a new axis 0."""
    return IcpFrame(*(tuple(torch.stack(level) for level in zip(*leaves))
                      for leaves in zip(*frames)))


def verify_loop_pairs(
    mesh,
    cam: CameraIntrinsics,
    icp_cfg,
    pairs,  # [(a, b)] keyframe-position pairs
    kf_poses: np.ndarray,  # (K, 4, 4) initial keyframe poses
    frame_of,  # pos -> IcpFrame (per-rank cache)
    stats: Optional[dict] = None,
    inv_poses: Optional[np.ndarray] = None,  # precomputed inverses of kf_poses
):
    """Geometrically verify candidate pairs, the pair axis split over the
    ranks.

    Pads the pair list to a multiple of the mesh size, gives each rank a
    contiguous block of rows (each rank builds frames ONLY for its rows;
    ``put_process_rows`` makes them one split batch), tracks the batch with
    ``icp_verify_sharded`` (the fused ICP step on the card) and gathers the
    (B, 4, 4) relative poses and overlap ratios on every rank. Returns
    ``[(a, b, T_rel (4, 4), overlap)]`` for all input pairs; pad rows (zero
    frames) are tracked and dropped. ``stats["verify_pairs_local"]`` is this
    rank's count of real pair rows.

    The overlap ratio is the reference's: the association count at the
    finest level, summed over the ``source_stride`` sample, over the source
    frame's valid-normal pixel count at full resolution (ROADMAP.md queue
    3). Under a finest stride s > 1 it is ~1/s² of the true overlap.
    """
    B = len(pairs)
    if B == 0:
        if stats is not None:
            stats["verify_pairs_local"] = 0
        return []
    n = mesh.size
    procs, pid = _procs(mesh)
    B_pad = B + ((-B) % n)
    rows_per_proc = B_pad // procs
    r0, r1 = pid * rows_per_proc, (pid + 1) * rows_per_proc
    if stats is not None:
        stats["verify_pairs_local"] = max(0, min(r1, B) - min(r0, B))

    if inv_poses is None:
        inv_poses = _inverse_np(kf_poses)
    dummy = None
    T_loc, src_loc, tgt_loc = [], [], []
    for r in range(r0, r1):
        if r < B:
            a, b = pairs[r]
            T_loc.append(np.asarray(kf_poses[a] @ inv_poses[b], np.float32))
            src_loc.append(frame_of(b))
            tgt_loc.append(frame_of(a))
        else:
            if dummy is None:
                dummy = make_icp_frame(
                    cam, torch.zeros((cam.height, cam.width), device=mesh.device), icp_cfg)
            T_loc.append(np.eye(4, dtype=np.float32))
            src_loc.append(dummy)
            tgt_loc.append(dummy)

    T0 = put_process_rows(mesh, ROWS, np.stack(T_loc, 0))
    src = put_process_rows(mesh, ROWS, _stack_frames(src_loc))
    tgt = put_process_rows(mesh, ROWS, _stack_frames(tgt_loc))

    T_rel, st, valid0 = icp_verify_sharded(mesh, cam, icp_cfg, T0, src, tgt)
    T_rel = fetch_global(mesh, ROWS, T_rel)[:B]
    st = fetch_global(mesh, ROWS, st)[:B]
    valid0 = fetch_global(mesh, ROWS, valid0)[:B]
    ovl = st[:, 1] / np.maximum(valid0.astype(np.float64), 1.0)
    return [(a, b, T_rel[k], float(ovl[k])) for k, (a, b) in enumerate(pairs)]


def distributed_slam(
    cam: CameraIntrinsics,
    depths: Sequence[np.ndarray],
    grays: Optional[Sequence[np.ndarray]],
    mesh,
    cfg: PipelineConfig = PipelineConfig(),
    n_chunks: int = 2,
    overlap: int = 3,
    kf_stride: Optional[int] = None,
    bundle_adjust: bool = True,
    loop_min_gap: int = 2,
    loop_max_candidates: int = 16,
    loop_min_overlap: float = 0.3,
    metrics: Optional[MetricsLogger] = None,
    detector: Optional[str] = None,
):
    """The whole pipeline on ``mesh`` (every rank calls it with the same
    arguments); returns the optimized ``(F, 4, 4)`` float32 host trajectory,
    the same on every rank.

    ``depths`` and ``grays`` are host images (a lazy sequence is indexed
    only where this rank needs a frame); ``grays`` is required when
    ``bundle_adjust=True`` (feature tracks). ``detector`` overrides
    ``cfg.frontend.detector`` for the BA feature front-end (``"orb"`` host
    OpenCV, ``"tpu"`` FAST+BRIEF on the device). Everything runs on the
    mesh's device.
    """
    metrics = metrics or MetricsLogger()
    n = len(depths)
    procs, pid = _procs(mesh)
    device = mesh.device
    detector = detector if detector is not None else cfg.frontend.detector

    # (1) Sequence-parallel odometry, with each chunk's own keyframe choices
    # (the policy of the single-device Slam); kf_stride overrides them. Each
    # rank tracks only its contiguous share of the chunks.
    sp_stats: dict = {}
    traj, kf_auto = sequence_parallel_odometry(
        cam, depths, n_chunks=n_chunks, overlap=overlap,
        icp_cfg=cfg.icp, kf_cfg=cfg.keyframe, pg_cfg=cfg.pose_graph,
        return_keyframes=True, mesh=mesh, stats=sp_stats, device=device,
    )
    metrics.log(stage="odometry", frames=n, chunks=n_chunks, **sp_stats)

    if kf_stride is not None:
        kf_idx = list(range(0, n, kf_stride))
    else:
        kf_idx = list(kf_auto)
    if kf_idx[-1] != n - 1:
        kf_idx.append(n - 1)
    K = len(kf_idx)
    kf_poses0 = np.stack([np.asarray(traj[i], np.float32) for i in kf_idx])

    # Per-rank pyramid builder: only the keyframes this rank's split stages
    # touch are built (or their depths read).
    frame_of = _FrameCache(cam, depths, kf_idx, cfg.icp, device)

    # (2) Keyframe descriptors over this rank's keyframe span; one
    # all-gather (a disjoint-support sum) assembles the whole set.
    d0, d1 = _local_span(K, procs, pid)
    desc = np.zeros((K, DESCRIPTOR_DIM), np.float32)
    for pos in range(d0, d1):
        desc[pos] = frame_descriptor(frame_of(pos))
    if procs > 1:
        desc = allgather_hosts(mesh, desc).sum(axis=0)
    metrics.log(stage="keyframes", count=K,
                policy="stride" if kf_stride is not None else "odometry",
                descriptors_local=d1 - d0)

    # Ring candidate search: split compute, then the same small top-k on
    # every rank.
    pairs = ring_loop_candidates(mesh, desc, loop_min_gap, loop_max_candidates)

    # (3) Verification, the candidate-pair axis split over the ranks. The
    # inverses serve the edge build and the re-anchoring below too.
    inv_kf = _inverse_np(kf_poses0)
    v_stats: dict = {}
    verified = verify_loop_pairs(mesh, cam, cfg.icp, pairs, kf_poses0, frame_of,
                                 stats=v_stats, inv_poses=inv_kf)
    loop_edges = [(a, b, T_rel, ovl) for a, b, T_rel, ovl in verified if ovl > loop_min_overlap]
    metrics.log(stage="loops", candidates=len(pairs), accepted=len(loop_edges),
                pyramids_built=frame_of.built, **v_stats)

    # (4) Keyframe pose graph: odometry edges from the stitched trajectory
    # and the verified loop edges.
    ei, ej, Tm, w = [], [], [], []
    for a in range(K - 1):
        ei.append(a)
        ej.append(a + 1)
        Tm.append(kf_poses0[a] @ inv_kf[a + 1])
        w.append(1.0 / cfg.pose_graph.odom_sigma**2)
    for a, b, T_rel, ovl in loop_edges:
        ei.append(a)
        ej.append(b)
        Tm.append(T_rel)
        w.append(ovl / cfg.pose_graph.loop_sigma**2)

    def ship(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    T_opt, _ = optimize_pose_graph(
        ship(kf_poses0, np.float32), ship(ei, np.int32), ship(ej, np.int32),
        ship(np.stack(Tm), np.float32), ship(w, np.float32), cfg.pose_graph,
    )
    kf_poses = T_opt.cpu().numpy()
    metrics.log(stage="pose_graph", keyframes=K, edges=len(ei))

    # (5) Blocked sharded BA over keyframe features. Detection and matching
    # are split over the ranks inside build_ba_problem; the lazy _Select
    # views keep a lazy frame loader lazy.
    if bundle_adjust:
        if grays is None:
            raise ValueError("bundle_adjust=True requires gray images")
        prob, info = build_ba_problem(
            cam,
            _Select(grays, kf_idx),
            _Select(depths, kf_idx),
            kf_poses,
            extra_pairs=[(a, b) for a, b, _, _ in loop_edges],
            # A multiple of the mesh size too (the reference's max(8, size),
            # equal for every power of two).
            pad_to_multiple=math.lcm(8, mesh.size),
            max_features=cfg.frontend.max_features,
            detector=detector,
            mesh=mesh if procs > 1 else None,
            device=device,
        )
        metrics.log(stage="ba_build", **{
            k: info[k] for k in
            ("num_landmarks", "num_observations", "detector", "detect_calls",
             "match_pairs_local") if k in info
        })
        prob = prune_observations(prob, cfg.ba.huber_delta * 3.0, cfg.ba.depth_weight)
        if cfg.ba.prior_weight > 0:
            # Odometry fusion: consecutive keyframes and the verified loop
            # pairs (their relative transforms are ICP-verified).
            edges = [(a, a + 1) for a in range(K - 1)]
            edges += [(a, b) for a, b, _, _ in loop_edges]
            prob = with_odometry_priors(prob, cfg.ba.prior_weight, edges)
        # The relayout: the observation payload moves from the frame-ordered
        # to the landmark-blocked split on the devices (one all-to-all a
        # field); overflow is counted and must be zero (the capacity is
        # exact).
        blocked, layout, cstats, dropped = block_ba_problem_device(mesh, prob)
        dropped = int(fetch_global(mesh, REPLICATED, dropped))
        if dropped:
            raise RuntimeError(
                f"reshard_obs_to_blocks dropped {dropped} observations: the "
                "per-(source, destination) capacity was underestimated"
            )
        # Gather-only BA reductions: each rank's slot tables ride the same
        # axis-0 split as the bucketed observations.
        slots = None
        if layout.cam_slots is not None and layout.lm_slots is not None:
            slots = layout_slots(mesh, layout)
        out, costs = ba_solve_blocked(mesh, blocked, cfg.ba, slots=slots)
        kf_poses = fetch_global(mesh, REPLICATED, out.poses)
        costs = fetch_global(mesh, REPLICATED, costs)
        metrics.log(
            stage="ba", layout="blocked", reshard_dropped=dropped,
            cost_first=float(costs[0]), cost_last=float(costs[-1]),
            **{k: cstats[k] for k in ("span_cut_after", "obs_imbalance")},
        )

    # Re-anchor every frame on its parent keyframe's optimized pose.
    out_traj = np.empty_like(traj)
    cur = 0
    for f in range(n):
        while cur + 1 < len(kf_idx) and kf_idx[cur + 1] <= f:
            cur += 1
        rel = traj[f] @ inv_kf[cur]
        out_traj[f] = rel @ kf_poses[cur]
    return out_traj


__all__ = ["ring_loop_candidates", "verify_loop_pairs", "distributed_slam"]
