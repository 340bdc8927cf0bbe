"""Landmark-block clustering + the blocked BA layout.

Counterpart of the JAX package's ``ba/cluster.py``. The replicated-landmark
layout (``parallel/sharded.py::ba_step_sharded``) sums whole ``(L, 3·)``
landmark blocks over the ranks in every CG matvec: an O(L) collective
payload an inner iteration. This module builds the north-star layout
instead:

1. **Cluster landmarks into n contiguous blocks**: sequence-contiguous
   first (landmarks ordered by the mean frame index of their
   observations), then a bounded greedy **co-observation refinement** that
   shrinks the camera span of each block while keeping observation counts
   balanced.
2. **Route every observation to its landmark's rank** and localise its
   landmark index, so that every landmark-indexed quantity (V, V⁻¹, bl, dl)
   is rank-local and a CG matvec sums only the ``(C, 6)`` camera vector
   over the ranks.

The host layout (:func:`cluster_landmarks`, :func:`block_ba_problem`,
:func:`unblock_points`, :func:`comm_bytes_per_cg_iter`) is numpy, line for
line the reference's, with its sort orders. :func:`block_ba_problem_device`
computes only an index view on the host and moves the observation payload
with the all-to-all of ``parallel/sharded.py::reshard_obs_to_blocks``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ba.schur import BAProblem, make_reduction_slots
from rgbd_pose_estimation_tpu_torch.parallel.mesh import put_global
from rgbd_pose_estimation_tpu_torch.parallel.sharded import reshard_obs_to_blocks
from rgbd_pose_estimation_tpu_torch.parallel.specs import REPLICATED, SpecLayout


class BlockedLayout(typing.NamedTuple):
    """Bookkeeping to map a blocked solution back to the original problem."""

    lm_perm: np.ndarray  # (n_shards * block_size,) original landmark id, -1 pad
    obs_perm: np.ndarray  # (n_shards * obs_cap,) original obs id, -1 pad
    n_shards: int
    block_size: int  # landmarks per shard (padded)
    obs_cap: int  # observations per shard (padded)
    num_landmarks: int  # original L
    num_observations: int  # original O
    # Reduction tables, one row per shard (host numpy; see
    # ba.schur.make_reduction_slots): (n_shards, C, capC) camera slots and
    # (n_shards, block_size, capL) landmark slots into each shard's local
    # obs rows, sentinel = obs_cap.
    cam_slots: object = None
    lm_slots: object = None


def cluster_landmarks(
    cam_idx: np.ndarray,
    lm_idx: np.ndarray,
    w: np.ndarray,
    num_landmarks: int,
    num_cameras: int,
    n_blocks: int,
    refine_passes: int = 4,
    balance_slack: float = 0.15,
):
    """Assign each landmark to one of ``n_blocks`` co-observation clusters.

    Returns ``(block_of_landmark (L,), stats)``. Sequence-contiguous
    quantile split on observation mass, then greedy boundary refinement
    minimizing the total camera span  Σ_b |{cameras seen by block b}|
    subject to per-block observation counts staying within
    ``(1 ± balance_slack) · O/n``. Built from the sparse (landmark, camera)
    pair list; only the (n_blocks, C) block-camera counts are dense.
    """
    L, C, n = num_landmarks, num_cameras, n_blocks
    valid = np.asarray(w) > 0
    li = np.asarray(lm_idx)[valid].astype(np.int64)
    ci = np.asarray(cam_idx)[valid].astype(np.int64)

    obs_per_lm = np.bincount(li, minlength=L)
    sum_cam = np.bincount(li, weights=ci.astype(np.float64), minlength=L)
    mean_cam = sum_cam / np.maximum(obs_per_lm, 1)
    mean_cam[obs_per_lm == 0] = C  # observation-less landmarks go last
    first_cam = np.full(L, C, np.int64)
    np.minimum.at(first_cam, li, ci)
    order = np.lexsort((first_cam.astype(np.float64), mean_cam))

    # Quantile split on cumulative observation mass → balanced blocks.
    cum = np.cumsum(obs_per_lm[order])
    total = max(int(cum[-1]), 1)
    # Clip both ends: cum can be 0 when leading landmarks have no valid
    # observations (e.g. everything pruned on a tiny problem).
    block_of_slot = np.clip((cum - 1) * n // total, 0, n - 1).astype(np.int64)
    block = np.empty(L, np.int64)
    block[order] = block_of_slot

    # Unique (landmark, camera) pairs with observation counts — the CSR
    # backbone of both the span metric and the refinement.
    ukey, pcnt = np.unique(li * C + ci, return_counts=True)
    pair_lm = ukey // C
    pair_cam = ukey % C

    def blk_cam_of(blk):
        bc = np.zeros((n, C), np.int64)
        np.add.at(bc, (blk[pair_lm], pair_cam), pcnt)
        return bc

    blk_cam = blk_cam_of(block)
    blk_obs = np.bincount(
        block, weights=obs_per_lm.astype(np.float64), minlength=n
    ).astype(np.int64)
    span_before = int((blk_cam > 0).sum())
    ideal = total / n
    lo, hi = ideal * (1 - balance_slack), ideal * (1 + balance_slack)

    # The batched accept can (rarely) overshoot — keep the best assignment
    # seen so the refinement is monotone in the reported span.
    best_block, best_span, best_obs = block.copy(), span_before, blk_obs.copy()

    for _ in range(refine_passes):
        moved = 0
        for d in (1, -1):
            # Span delta of moving landmark l from b to b+d, from the pair
            # list against the CURRENT block-camera counts:
            #   gain = #cams where l's obs are ALL of b's   (cam leaves b)
            #   loss = #cams of l unseen by b+d             (cam enters b+d)
            bsrc = block[pair_lm]
            bdst = np.clip(bsrc + d, 0, n - 1)
            g_pair = blk_cam[bsrc, pair_cam] == pcnt
            l_pair = blk_cam[bdst, pair_cam] == 0
            gain = np.bincount(pair_lm, weights=g_pair.astype(np.float64), minlength=L)
            loss = np.bincount(pair_lm, weights=l_pair.astype(np.float64), minlength=L)
            net = gain - loss
            cand = np.nonzero(
                (net > 0)
                & (obs_per_lm > 0)
                & (block + d >= 0)
                & (block + d < n)
            )[0]
            if cand.size == 0:
                continue
            # Apply best-first under the balance budget. blk_cam is held
            # fixed within the batch (moves sharing a (block, cam) may
            # overestimate their combined gain — heuristic, corrected by
            # the recount below); blk_obs is tracked exactly.
            cand = cand[np.argsort(-net[cand])]
            for l in cand:
                b = block[l]
                o = obs_per_lm[l]
                if blk_obs[b] - o < lo or blk_obs[b + d] + o > hi:
                    continue
                block[l] = b + d
                blk_obs[b] -= o
                blk_obs[b + d] += o
                moved += 1
            blk_cam = blk_cam_of(block)
        span_now = int((blk_cam > 0).sum())
        if span_now < best_span:
            best_block, best_span = block.copy(), span_now
            best_obs = blk_obs.copy()
        if moved == 0:
            break

    block, blk_obs = best_block, best_obs
    span_after = best_span
    stats = {
        "span_cut_before": span_before,
        "span_cut_after": span_after,
        "obs_per_block": blk_obs.tolist(),
        "obs_imbalance": float(blk_obs.max() / max(ideal, 1e-9)),
    }
    return block, stats


def _landmark_permutation(block: np.ndarray, L: int, n: int, points: np.ndarray):
    """Landmarks block-major, original order within a block, each block
    padded to the largest: ``(lm_perm, local_of_lm, block_size, points)``."""
    lm_order = np.lexsort((np.arange(L), block))
    per_block = np.bincount(block, minlength=n)
    Lb = int(per_block.max())
    lm_perm = np.full(n * Lb, -1, np.int64)
    local_of_lm = np.empty(L, np.int64)
    start = 0
    for b in range(n):
        sel = lm_order[start : start + per_block[b]]
        lm_perm[b * Lb : b * Lb + per_block[b]] = sel
        local_of_lm[sel] = np.arange(per_block[b])
        start += per_block[b]
    pts_blocked = np.zeros((n * Lb, 3), points.dtype)
    real = lm_perm >= 0
    pts_blocked[real] = points[lm_perm[real]]
    return lm_perm, local_of_lm, Lb, pts_blocked


def _host(x):
    return None if x is None else (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                                   else np.asarray(x))


def block_ba_problem(
    prob: BAProblem, n_shards: int, pad_obs_to_multiple: int = 8, refine_passes: int = 4
):
    """Re-layout a :class:`BAProblem` for ``ba_step_blocked``.

    Returns ``(blocked_problem, BlockedLayout, stats)`` where the blocked
    problem (on ``prob``'s device) has landmarks permuted into ``n_shards``
    equal blocks (padded with frozen dummy landmarks), observations bucketed
    per block (padded with w=0 rows) and **shard-local** landmark indices.
    """
    cam_idx = _host(prob.cam_idx)
    lm_idx = _host(prob.lm_idx)
    w = _host(prob.w)
    points = _host(prob.points)
    obs = _host(prob.obs)
    obs_z = _host(prob.obs_z)
    L, O, C = points.shape[0], cam_idx.shape[0], int(prob.poses.shape[0])
    n = n_shards

    block, stats = cluster_landmarks(
        cam_idx, lm_idx, w, L, C, n, refine_passes=refine_passes
    )
    lm_perm, local_of_lm, Lb, pts_blocked = _landmark_permutation(block, L, n, points)

    # Observation buckets: every obs goes to its landmark's shard.
    obs_block = block[lm_idx]
    obs_order = np.lexsort((np.arange(O), obs_block))
    per_block_obs = np.bincount(obs_block, minlength=n)
    cap = int(per_block_obs.max())
    cap += (-cap) % pad_obs_to_multiple
    obs_perm = np.full(n * cap, -1, np.int64)
    start = 0
    for b in range(n):
        sel = obs_order[start : start + per_block_obs[b]]
        obs_perm[b * cap : b * cap + per_block_obs[b]] = sel
        start += per_block_obs[b]

    def scatter(src, fill, dtype=None):
        shape = (n * cap,) + src.shape[1:]
        out = np.full(shape, fill, dtype or src.dtype)
        mask = obs_perm >= 0
        out[mask] = src[obs_perm[mask]]
        return out

    cam_b = scatter(cam_idx, 0)
    lm_local = np.zeros(n * cap, np.int32)
    mask = obs_perm >= 0
    lm_local[mask] = local_of_lm[lm_idx[obs_perm[mask]]]
    obs_b = scatter(obs, 0.0)
    w_b = scatter(w, 0.0)
    w_b[~mask] = 0.0
    obs_z_b = None if obs_z is None else scatter(obs_z, 0.0)

    dev = prob.poses.device

    def up(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t if dtype is None else t.to(dtype)).to(dev)

    blocked = BAProblem(
        poses=prob.poses,
        points=up(pts_blocked),
        cam_idx=up(cam_b, torch.int32),
        lm_idx=up(lm_local, torch.int32),
        obs=up(obs_b),
        w=up(w_b),
        obs_z=None if obs_z_b is None else up(obs_z_b),
        # Relative-pose priors are camera-indexed — unaffected by the
        # landmark permutation; carried through verbatim (replicated).
        prior_i=prob.prior_i,
        prior_j=prob.prior_j,
        prior_T_inv=prob.prior_T_inv,
        prior_w=prob.prior_w,
    )
    layout = BlockedLayout(
        lm_perm=lm_perm,
        obs_perm=obs_perm,
        n_shards=n,
        block_size=Lb,
        obs_cap=cap,
        num_landmarks=L,
        num_observations=O,
    )
    stats.update(
        {
            "block_size": Lb,
            "obs_cap": cap,
            "lm_pad_frac": 1.0 - L / (n * Lb),
            "obs_pad_frac": 1.0 - O / (n * cap),
        }
    )
    return blocked, layout, stats


def block_ba_problem_device(
    mesh,
    prob: BAProblem,
    pad_obs_to_multiple: int = 8,
    refine_passes: int = 4,
    obs_cap_override: int = 0,
):
    """The device-side blocked relayout, the production layout switch.

    Same layout contract as :func:`block_ba_problem`, built the all-to-all
    way: the host computes only an **index** view (the clustering from
    ``(cam_idx, lm_idx, w)``, the landmark permutation, each observation's
    destination rank); the observation **payload** (obs, w, obs_z, the
    indices) moves from the frame-ordered split (contiguous axis-0 blocks)
    to the landmark-blocked one on the devices, through
    ``parallel.sharded.reshard_obs_to_blocks``: one ``all_to_all_single`` a
    field, never a host permutation. ``prob`` is identical on every rank.

    The per-(source, destination) capacity is exact from the host index
    view (so ``dropped == 0`` in normal operation), padded to
    ``pad_obs_to_multiple``; ``obs_cap_override`` (tests only) forces a
    smaller one to exercise the overflow accounting.

    Returns ``(blocked_problem of Shards, BlockedLayout, stats, dropped)``,
    ``dropped`` the global count of observations lost to overflow, a device
    scalar the caller must check. The layout's reduction tables are built
    at any inflation (the reference leaves them out when too imbalanced and
    scatters; a gather keeps the sums in a fixed order, a scatter-add on the
    card would not).
    """
    cam_idx = _host(prob.cam_idx)
    lm_idx = _host(prob.lm_idx)
    w = _host(prob.w)
    points = _host(prob.points)
    L, O, C = points.shape[0], cam_idx.shape[0], int(prob.poses.shape[0])
    n = mesh.size

    block, stats = cluster_landmarks(
        cam_idx, lm_idx, w, L, C, n, refine_passes=refine_passes
    )
    lm_perm, local_of_lm, Lb, pts_blocked = _landmark_permutation(block, L, n, points)

    # Source layout: frame-ordered = the natural contiguous axis-0 split.
    # Pad to a multiple of n with w=0 rows, destinations round-robin so no
    # single shard's buckets absorb all padding.
    O_pad = O + ((-O) % n)
    npad = O_pad - O
    dest = np.empty(O_pad, np.int32)
    dest[:O] = block[lm_idx]
    dest[O:] = np.arange(npad) % n

    def _pad_host(x, fill):
        out = np.full((O_pad,) + x.shape[1:], fill, x.dtype)
        out[:O] = x
        return out

    def _pad_device(x):  # payload rows stay on the device
        pad = torch.zeros((npad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])

    # Exact per-(src, dst) counts → capacity (index-only host work).
    per_src = O_pad // n
    src = np.arange(O_pad) // per_src
    cnt = np.zeros((n, n), np.int64)
    np.add.at(cnt, (src, dest), 1)
    cap = int(cnt.max())
    cap += (-cap) % pad_obs_to_multiple
    if obs_cap_override:
        cap = obs_cap_override

    sl = SpecLayout.for_mesh(mesh)
    ospec = sl.observations()
    fields = {
        "cam_idx": _pad_host(cam_idx.astype(np.int32), 0),
        "lm_idx": _pad_host(local_of_lm[lm_idx].astype(np.int32), 0),
        "obs": _pad_device(prob.obs),
        "w": _pad_device(prob.w),
    }
    if prob.obs_z is not None:
        fields["obs_z"] = _pad_device(prob.obs_z)
    fields = {k: put_global(mesh, ospec, v) for k, v in fields.items()}
    out, dropped = reshard_obs_to_blocks(mesh, fields, put_global(mesh, ospec, dest), cap)
    w_dev = out["w"]._replace(local=torch.where(out["valid"].local, out["w"].local, 0.0))

    # Host-side replay of the device slot assignment (index-only): obs o of
    # source s with stable rank r toward shard d lands at global slot
    # d·(n·cap) + s·cap + r, dropped if r ≥ cap. Gives the same obs_perm
    # contract block_ba_problem provides (and the overflow oracle).
    obs_perm = np.full(n * n * cap, -1, np.int64)
    rank = np.empty(O_pad, np.int64)
    for s in range(n):
        order = np.argsort(dest[s * per_src:(s + 1) * per_src], kind="stable")
        d_sorted = dest[s * per_src:(s + 1) * per_src][order]
        starts = np.searchsorted(d_sorted, np.arange(n), side="left")
        r = np.arange(per_src) - starts[d_sorted]
        rank[np.arange(s * per_src, (s + 1) * per_src)[order]] = r
    ok = rank < cap
    slots = dest.astype(np.int64) * (n * cap) + src * cap + rank
    orig = np.arange(O_pad)
    keep = ok & (orig < O)
    obs_perm[slots[keep]] = orig[keep]
    # Device `dropped` counts every overflowing row (pads included).
    dropped_host = int((~ok).sum())

    # Per-shard reduction tables (ba.schur.make_reduction_slots semantics,
    # common cap across shards; pad rows keep index 0 and contribute w=0
    # terms).
    rows = n * cap
    op = obs_perm.reshape(n, rows)
    vr = op >= 0
    lcam = np.zeros((n, rows), np.int64)
    llm = np.zeros((n, rows), np.int64)
    lcam[vr] = cam_idx[op[vr]]
    llm[vr] = local_of_lm[lm_idx[op[vr]]]

    def _shard_slots(ids, nseg):
        per = [make_reduction_slots(ids[s], nseg, max_inflation=None) for s in range(n)]
        capm = max(t.shape[1] for t in per)
        table = np.full((n, nseg, capm), rows, np.int32)
        for s, t in enumerate(per):
            table[s, :, : t.shape[1]] = t
        return table

    cam_slots = _shard_slots(lcam, C)
    lm_slots = _shard_slots(llm, Lb)

    # Non-observation fields become global tensors too (poses/priors
    # replicated, blocked points landmark-split), so the returned problem
    # feeds ba_solve_blocked/ba_step_blocked directly.
    def _rep(x):
        return None if x is None else put_global(mesh, REPLICATED, x)

    blocked = BAProblem(
        poses=_rep(prob.poses),
        points=put_global(mesh, sl.landmarks_blocked(), pts_blocked),
        cam_idx=out["cam_idx"],
        lm_idx=out["lm_idx"],
        obs=out["obs"],
        w=w_dev,
        obs_z=out.get("obs_z"),
        prior_i=_rep(prob.prior_i),
        prior_j=_rep(prob.prior_j),
        prior_T_inv=_rep(prob.prior_T_inv),
        prior_w=_rep(prob.prior_w),
    )
    layout = BlockedLayout(
        lm_perm=lm_perm,
        obs_perm=obs_perm,
        n_shards=n,
        block_size=Lb,
        obs_cap=n * cap,
        num_landmarks=L,
        num_observations=O,
        cam_slots=cam_slots,
        lm_slots=lm_slots,
    )
    stats.update({
        "block_size": Lb,
        "obs_cap": n * cap,
        "lm_pad_frac": 1.0 - L / (n * Lb),
        "obs_pad_frac": 1.0 - O / (n * n * cap),
        "reshard_dropped_host": dropped_host,
    })
    return blocked, layout, stats, dropped


def unblock_points(points_blocked, layout: BlockedLayout) -> np.ndarray:
    """Invert the landmark permutation of :func:`block_ba_problem`."""
    pts = _host(points_blocked)
    out = np.zeros((layout.num_landmarks, 3), pts.dtype)
    real = layout.lm_perm >= 0
    out[layout.lm_perm[real]] = pts[real]
    return out


def comm_bytes_per_cg_iter(
    num_cameras: int, num_landmarks: int, blocked: bool, dtype_bytes: int = 4
) -> int:
    """Collective payload of ONE CG matvec under each layout.

    Replicated layout: ``lm_from_cam`` sums an (L, 3) landmark vector and
    ``cam_from_lm`` a (C, 6) camera vector over the ranks → O(L) per inner
    iteration. Blocked layout: landmark sums are rank-local; only the
    (C, 6) camera vector is reduced → independent of L.
    """
    cam = num_cameras * 6 * dtype_bytes
    if blocked:
        return cam
    return cam + num_landmarks * 3 * dtype_bytes
