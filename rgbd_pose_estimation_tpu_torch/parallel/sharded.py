"""The distributed steps: RANSAC DP, ICP TP, BA, the relayout, the ring.

Counterpart of the JAX package's ``parallel/sharded.py``. Each function
takes a mesh (``parallel/mesh.py``: a process group, one rank a device) and
runs on every rank the *same* numerical body as its single-device twin on
the rank's block of the inputs, with collectives at the reference's
reduction points. So the results are the single-device numbers up to the
order of f32 summation across ranks (on a mesh of one rank, the same
numbers).

Inputs are :class:`~parallel.mesh.Shard` s laid out as the function's specs
say (``parallel/specs.py``), or whole tensors identical on every rank, of
which each rank takes its block, as ``shard_map`` does with an unsharded
array. Split results come back as ``Shard`` s; replicated results (sums,
costs, counts) as tensors, the same on every rank.

The kernels on these paths launch exactly as on one device: K3
(``score_poses_3d3d``) on each rank's hypotheses, K4 (``icp_jtj_jtr``) on
each rank's pixel rows, the fused ICP step through ``icp_track_batch`` on
each rank's candidate pairs. On CUDA tensors none of them runs its plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ba.schur import BAProblem, ba_step, make_reduction_slots
from rgbd_pose_estimation_tpu_torch.icp.dense import icp_track_batch
from rgbd_pose_estimation_tpu_torch.ops.icp_jtj import icp_jtj_jtr
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import score_poses_3d3d
from rgbd_pose_estimation_tpu_torch.parallel.mesh import (
    Mesh,
    Shard,
    _as_tensor,
    _tree_map,
    all_to_all,
    block_of,
    pmax,
    psum,
    put_global,
    ring_shift,
)
from rgbd_pose_estimation_tpu_torch.parallel.specs import ROWS, Spec, SpecLayout
from rgbd_pose_estimation_tpu_torch.utils.config import BAConfig


def local_block(mesh: Mesh, spec: Spec, x):
    """This rank's block of ``x`` under ``spec``: a ``Shard``'s own (its
    layout must be ``spec``), or the block of a whole tensor."""
    if x is None:
        return None
    if isinstance(x, Shard):
        if x.mesh is not mesh or x.spec != spec:
            raise ValueError(f"a tensor laid out {x.spec} on another mesh or layout than {spec}")
        return x.local
    return block_of(_as_tensor(x), spec, mesh.rank, mesh.size).to(mesh.device)


def local_tree(mesh: Mesh, specs, tree):
    """:func:`local_block` over a tuple/NamedTuple/dict."""
    return _tree_map(lambda s, x: local_block(mesh, s, x), specs, tree)


def shard_tree(mesh: Mesh, specs, tree):
    """Wrap each rank-local tensor of ``tree`` as a ``Shard`` of ``specs``."""

    def one(spec, t):
        shape = tuple(t.shape)
        if not spec.replicated:
            shape = shape[: spec.split] + (shape[spec.split] * mesh.size,) + shape[spec.split + 1:]
        return Shard(t, spec, mesh, shape)

    return _tree_map(one, specs, tree)


def problem_specs(mesh: Mesh, prob: BAProblem, blocked: bool) -> BAProblem:
    """The layouts of ``prob`` (whole or sharded) under either layout."""
    return SpecLayout.for_mesh(mesh).ba_problem(
        blocked=blocked, has_obs_z=prob.obs_z is not None, has_prior=prob.prior_i is not None
    )


def score_poses_3d3d_sharded(mesh: Mesh, T, p, q, threshold: float):
    """DP RANSAC scoring: K hypotheses split over every rank (K divisible
    by the mesh size), correspondences replicated. Each rank scores its
    K/n poses with K3; the results stay split along K. Returns
    ``(msac, count)`` ``Shard`` s of ``(K,)``."""
    sl = SpecLayout.for_mesh(mesh)
    msac, count = score_poses_3d3d(
        local_block(mesh, sl.hypotheses(), T),
        local_block(mesh, sl.correspondences(), p),
        local_block(mesh, sl.correspondences(), q),
        threshold,
    )
    return shard_tree(mesh, (sl.hypotheses(),) * 2, (msac, count))


def icp_jtj_sharded(mesh: Mesh, p, q, n, w):
    """TP dense-ICP reduction: each rank accumulates its contiguous block of
    the M pixel rows with K4 (M divisible by the mesh size), then the 6×6,
    the 6 and the two scalars are summed over the ranks in one
    ``all_reduce`` (a 44-float payload). Returns ``(JtJ, Jtr, err_sum,
    weight_sum)``, the same on every rank."""
    spec = SpecLayout.for_mesh(mesh).pixel_rows()
    JtJ, Jtr, err, wsum = icp_jtj_jtr(*(local_block(mesh, spec, x) for x in (p, q, n, w)))
    flat = psum(mesh, torch.cat([JtJ.reshape(36), Jtr, err.reshape(1), wsum.reshape(1)]))
    return flat[:36].reshape(6, 6), flat[36:42], flat[42], flat[43]


def _slot_locals(mesh: Mesh, slots):
    """Each rank's ``(cam_slots, lm_slots)`` from ``(n, segments, cap)``
    tables split on axis 0 (or ``None``)."""
    if slots is None:
        return None, None
    return tuple(None if s is None else local_block(mesh, ROWS, s)[0] for s in slots)


def ba_reduction_slots(mesh: Mesh, prob: BAProblem, blocked: bool = False):
    """Every rank's reduction tables of its own observations
    (``ba.schur.make_reduction_slots``, built at any inflation), padded to
    a common cap with the sentinel and returned as ``(n, segments, cap)``
    ``Shard`` s split on axis 0. One read of the rank's index arrays and
    one MAX ``all_reduce`` of the caps, before the solve."""
    local = local_tree(mesh, problem_specs(mesh, prob, blocked), prob)
    O = local.cam_idx.shape[0]
    tables = [
        make_reduction_slots(idx.cpu().numpy(), int(nseg), max_inflation=None)
        for idx, nseg in ((local.cam_idx, local.poses.shape[0]),
                          (local.lm_idx, local.points.shape[0]))
    ]
    caps = pmax(mesh, torch.tensor([t.shape[1] for t in tables], dtype=torch.int32)
                .to(mesh.device)).cpu().numpy()
    out = []
    for t, cap in zip(tables, caps):
        padded = np.full((1, t.shape[0], int(cap)), O, np.int64)
        padded[0, :, : t.shape[1]] = t
        out.append(torch.from_numpy(padded).to(mesh.device))
    return tuple(shard_tree(mesh, (ROWS, ROWS), tuple(out)))


def layout_slots(mesh: Mesh, layout):
    """A blocked layout's reduction tables (``ba/cluster.py``) on the mesh:
    ``(n, segments, cap)`` ``Shard`` s split on axis 0, as int64, the index
    type of a gather (int32 tables would be converted at every gather)."""
    return tuple(put_global(mesh, ROWS, np.asarray(t, np.int64))
                 for t in (layout.cam_slots, layout.lm_slots))


def ba_step_sharded(mesh: Mesh, prob: BAProblem, cfg: BAConfig, slots=None):
    """Distributed Schur BA step: observations split, states replicated.

    Every camera- and landmark-indexed sum of ``ba_step`` reduces over the
    rank's own observations; an ``all_reduce`` completes it across the
    ranks (an O(L) landmark payload per CG matvec). The observation count
    must divide by the mesh size (pad with w=0 rows). ``slots``: the
    ranks' tables from :func:`ba_reduction_slots`; without them each rank
    reduces through incidence matrices (small problems only). Returns
    ``(problem of Shards, cost)``."""
    specs = problem_specs(mesh, prob, blocked=False)
    cs, ls = _slot_locals(mesh, slots)
    out, cost = ba_step(local_tree(mesh, specs, prob), cfg, cs, ls,
                        psum=lambda x: psum(mesh, x))
    return shard_tree(mesh, specs, out), cost


def _blocked_step(mesh: Mesh, local: BAProblem, cfg: BAConfig, cs, ls):
    return ba_step(local, cfg, cs, ls, psum=lambda x: psum(mesh, x), psum_lm=lambda x: x)


def ba_step_blocked(mesh: Mesh, prob: BAProblem, cfg: BAConfig, slots=None):
    """Landmark-block-split Schur BA step (the north-star layout).

    ``prob`` is laid out by ``ba/cluster.py`` (``block_ba_problem`` or
    ``block_ba_problem_device``): landmarks permuted into ``mesh.size``
    equal blocks, every observation on its landmark's rank with a
    rank-local landmark index. Every landmark-indexed quantity stays local
    (``psum_lm`` is the identity), and the only collective of a CG matvec
    is the ``(C, 6)`` camera vector. ``slots``: ``(cam_slots, lm_slots)``
    tables ``(n, segments, cap)`` split on axis 0 (the layout's, or
    :func:`ba_reduction_slots`)."""
    specs = problem_specs(mesh, prob, blocked=True)
    cs, ls = _slot_locals(mesh, slots)
    out, cost = _blocked_step(mesh, local_tree(mesh, specs, prob), cfg, cs, ls)
    return shard_tree(mesh, specs, out), cost


def ba_solve_blocked(mesh: Mesh, prob: BAProblem, cfg: BAConfig, slots=None):
    """``cfg.outer_iters`` blocked steps (the reference's ``lax.scan`` as a
    Python loop; nothing is read back between steps). Returns
    ``(problem of Shards, (outer_iters,) costs)``."""
    specs = problem_specs(mesh, prob, blocked=True)
    cs, ls = _slot_locals(mesh, slots)
    local, costs = local_tree(mesh, specs, prob), []
    for _ in range(cfg.outer_iters):
        local, cost = _blocked_step(mesh, local, cfg, cs, ls)
        costs.append(cost)
    return shard_tree(mesh, specs, local), torch.stack(costs)


def reshard_obs_to_blocks(mesh: Mesh, fields: dict, dest, cap: int):
    """The all-to-all relayout: frame-ordered → landmark-blocked observations.

    Each rank buckets its block of the observations by destination rank
    (``dest``, from the landmark clustering) into an ``(n, cap, ...)`` send
    buffer: an observation's slot is its stable rank among the rank's
    observations bound for the same destination, and one past ``cap``
    lands in a trash column cut off before the exchange. ONE
    ``all_to_all_single`` a field swaps the buckets, and one more carries
    the valid mask.

    ``fields``: a dict of ``(O, ...)`` tensors split along axis 0 (O
    divisible by the mesh size); ``cap``: the static per-(source,
    destination) capacity. Returns ``(out, dropped)``: a dict of
    ``Shard`` s of ``(n·n·cap, ...)`` split along axis 0 plus ``"valid"``,
    and the GLOBAL count of observations dropped to overflow (one
    ``all_reduce``; callers must check it).
    """
    n = mesh.size
    spec = SpecLayout.for_mesh(mesh).observations()
    loc = {k: local_block(mesh, spec, v) for k, v in fields.items()}
    dst = local_block(mesh, spec, dest).long()
    order = torch.argsort(dst, stable=True)
    dst_sorted = dst[order]
    start = torch.searchsorted(dst_sorted, torch.arange(n, device=dst.device))
    slot_sorted = torch.arange(dst.shape[0], device=dst.device) - start[dst_sorted]
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    slot_c = torch.clamp(slot, max=cap)
    dropped = psum(mesh, torch.sum(slot >= cap).to(torch.int32))

    def to_buckets(x):
        send = torch.zeros((n, cap + 1) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        send[dst, slot_c] = x
        recv = all_to_all(mesh, send[:, :cap])
        return recv.reshape((n * cap,) + tuple(x.shape[1:]))

    out = {k: to_buckets(v) for k, v in loc.items()}
    out["valid"] = to_buckets(torch.ones_like(dst, dtype=torch.int32)) > 0
    return shard_tree(mesh, spec, out), dropped


def icp_verify_sharded(mesh: Mesh, cam, cfg, T_init, src, tgt):
    """DP loop-closure verification: candidate pairs split over the ranks.

    Every leaf of ``T_init``/``src``/``tgt`` (``IcpFrame`` s) carries a
    leading batch axis B, divisible by the mesh size; each rank tracks its
    B/n pairs with ``icp_track_batch`` (the fused ICP step on the card), and
    no collective is made. Returns ``Shard`` s of ``T (B, 4, 4)``, ``stats
    (B, 2)`` and ``valid0 (B,)``, each source frame's valid-normal pixel
    count at the finest level (the denominator of the overlap ratio)."""
    spec = ROWS
    s = local_tree(mesh, spec, src)
    T, stats = icp_track_batch(cam, cfg, local_block(mesh, spec, T_init), s,
                               local_tree(mesh, spec, tgt))
    valid0 = torch.sum(torch.sum(s.normals[0] ** 2, dim=-1) > 0.5, dim=(1, 2)).to(torch.float32)
    return shard_tree(mesh, (spec,) * 3, (T, stats, valid0))


def ring_similarity(mesh: Mesh, desc):
    """All-pairs keyframe similarity through a ring (the communication
    shape of ring attention). ``desc`` is ``(K, D)``, K divisible by the
    mesh size; rank r holds block r and scores a ``(K/n, K/n)`` tile a
    step while the blocks move one rank on (n − 1 ``batch_isend_irecv``
    steps). The tile is a plain matrix product. Returns the ``(K, K)``
    similarity split by rows."""
    spec = SpecLayout.for_mesh(mesh).keyframe_blocks()
    local = local_block(mesh, spec, desc)
    n, r = mesh.size, mesh.rank
    kb = local.shape[0]
    out = torch.zeros((kb, kb * n), dtype=local.dtype, device=local.device)
    blk = local
    for s in range(n):
        src = (r - s) % n
        out[:, src * kb:(src + 1) * kb] = torch.matmul(local, blk.T)
        if s + 1 < n:
            blk = ring_shift(mesh, blk)
    return Shard(out, spec, mesh, (kb * n, kb * n))


__all__ = [
    "local_block", "local_tree", "shard_tree", "problem_specs", "score_poses_3d3d_sharded",
    "icp_jtj_sharded", "ba_reduction_slots", "layout_slots", "ba_step_sharded", "ba_step_blocked",
    "ba_solve_blocked", "reshard_obs_to_blocks", "icp_verify_sharded", "ring_similarity",
]
