"""Build a bundle-adjustment problem from keyframes of a sequence.

Counterpart of the JAX package's ``ba/build.py``. Bridges the front-end
(sparse features + depth) to the Schur BA backend (configuration 5):
keypoints matched between temporally adjacent (and loop-candidate) keyframe
pairs are chained into landmark *tracks* with union-find; each track becomes
one landmark, initialised by back-projecting its first observation with a
valid depth through its keyframe's pose; every observation contributes a
normalized-plane residual row and its measured depth.

Detection runs on ``device`` (``detector="tpu"``) or on the host (``"orb"``,
OpenCV); all keyframe pairs are matched on ``device`` in one batched call
over the pair axis (the reference makes one device call and one read-back a
pair; the matches are the same). The track graph is host numpy and Python,
in the reference's order: the landmark order is the insertion order of the
union-find roots.

With ``mesh`` (a mesh of several processes, ``parallel/mesh.py``) the
per-keyframe work is process-sharded as in the reference: each rank detects
only its contiguous span of keyframes and matches only its span of pairs,
then the fixed-size per-keyframe feature arrays and the match results are
exchanged with ``allgather_hosts`` and summed (each rank's contribution is
zero outside its span), so every rank runs the same union-find on the same
inputs. Keypoint depths are sampled at detection and ride the exchange.
The reference sums the gathered copies on the assumption that the spans do
not overlap (ROADMAP.md queue 3 lists that as its fault); this is ported as
it is.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ba.schur import BAProblem
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_inverse
from rgbd_pose_estimation_tpu_torch.features.frontend import (
    _depth_at,
    _detect,
    match_descriptors,
)
from rgbd_pose_estimation_tpu_torch.parallel.mesh import allgather_hosts, partition_bounds

# Keyframe pairs a batched matching call: its (pairs, M, M, 32) xor bytes
# are ~1 GB at M = 512 on the way through the popcount table.
_MATCH_CHUNK = 32


def _span(n: int, mesh):
    """This rank's contiguous span of ``n`` items, and the rank count."""
    procs = mesh.size if mesh is not None else 1
    pid = mesh.rank if procs > 1 else 0
    bounds = partition_bounds(n, procs)
    return int(bounds[pid]), int(bounds[pid + 1]), procs


class _UnionFind:
    def __init__(self, n):
        self.parent = list(range(n))

    def find(self, a):
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def detect_keyframe_features(
    keyframe_grays,
    keyframe_depths,
    max_features: int = 512,
    detector: str = "orb",
    mesh=None,
    stats=None,
    device="cuda",
):
    """Detect keypoints + sample their depths for every keyframe.

    Returns host ``(uv (K, M, 2) f32, desc (K, M, 32) u8, valid (K, M)
    bool, z (K, M) f32)``. With ``mesh`` each rank detects only its
    contiguous keyframe span (the images are only indexed there, so a lazy
    loader shards the decoding too) and the results are exchanged with two
    all-gathers (an f32 pack and the u8 descriptors). ``stats`` (dict,
    mutated) records this rank's ``detect_calls``, as in the reference.
    """
    K = len(keyframe_grays)
    M = max_features
    lo, hi, procs = _span(K, mesh)
    uv = np.zeros((K, M, 2), np.float32)
    desc = np.zeros((K, M, 32), np.uint8)
    valid = np.zeros((K, M), bool)
    z = np.zeros((K, M), np.float32)
    for k in range(lo, hi):
        u, d, v = _detect(np.asarray(keyframe_grays[k]), M, detector, device)
        uv[k], desc[k], valid[k] = u, d, v
        z[k] = _depth_at(np.asarray(keyframe_depths[k]), u)
    if stats is not None:
        stats["detect_calls"] = hi - lo
    if procs > 1:
        # Disjoint support: every rank's contribution is zero outside its
        # own span, so the sum of the gathered copies is the whole.
        pack = np.concatenate([uv, z[..., None], valid[..., None].astype(np.float32)], axis=-1)
        pack = allgather_hosts(mesh, pack).sum(axis=0)
        uv, z = pack[..., :2], pack[..., 2]
        valid = pack[..., 3] > 0.5
        desc = allgather_hosts(mesh, desc).sum(axis=0, dtype=np.int64).astype(np.uint8)
    return uv, desc, valid, z


def match_keyframe_pairs(
    desc: np.ndarray,  # (K, M, 32) u8
    valid: np.ndarray,  # (K, M) bool
    pairs,  # [(a, b)]
    mesh=None,
    stats=None,
    device="cuda",
):
    """Hamming matching on ``device`` for a list of keyframe pairs.

    Returns host ``(idx_b (P, M) i32, good (P, M) bool)``: per pair, each of
    keyframe a's keypoints' best match in b and the ratio + mutual gate.
    The descriptors go up once; the pairs are matched in batches of
    ``_MATCH_CHUNK`` (one call for up to that many), and read back once.
    With ``mesh`` each rank matches its contiguous span of the pairs and
    the results are exchanged with one all-gather (disjoint support,
    summed). ``stats["match_pairs_local"]`` records this rank's pairs.
    """
    Pn = len(pairs)
    M = desc.shape[1]
    lo_p, hi_p, procs = _span(Pn, mesh)
    if stats is not None:
        stats["match_pairs_local"] = hi_p - lo_p
    idx = np.zeros((Pn, M), np.int32)
    good = np.zeros((Pn, M), bool)
    if hi_p > lo_p:
        d = torch.from_numpy(np.ascontiguousarray(desc)).to(device)
        v = torch.from_numpy(np.ascontiguousarray(valid)).to(device)
        ab = torch.from_numpy(np.asarray(pairs[lo_p:hi_p], np.int64).reshape(-1, 2)).to(device)
        parts_i, parts_g = [], []
        for lo in range(0, hi_p - lo_p, _MATCH_CHUNK):
            a, b = ab[lo : lo + _MATCH_CHUNK, 0], ab[lo : lo + _MATCH_CHUNK, 1]
            ib, g, _ = match_descriptors(d[a], v[a], d[b], v[b])
            parts_i.append(ib)
            parts_g.append(g)
        idx[lo_p:hi_p] = torch.cat(parts_i).cpu().numpy()
        good[lo_p:hi_p] = torch.cat(parts_g).cpu().numpy()
    if procs > 1:
        pack = np.concatenate([idx[..., None], good[..., None].astype(np.int32)], axis=-1)
        pack = allgather_hosts(mesh, pack).sum(axis=0)
        idx, good = pack[..., 0].astype(np.int32), pack[..., 1] > 0
    return idx, good


def build_ba_problem(
    cam: CameraIntrinsics,
    keyframe_grays,  # list of (H, W) float images
    keyframe_depths,  # list of (H, W) float depth maps (meters)
    keyframe_poses,  # (K, 4, 4) world→camera initial estimates
    extra_pairs=(),  # additional (a, b) keyframe index pairs (loop closures)
    max_features: int = 512,
    min_track_len: int = 2,
    pad_to_multiple: int = 8,
    detector: str = "orb",
    mesh=None,
    device="cuda",
):
    """Returns ``(BAProblem on device, info_dict)``; observations padded
    with w=0. ``detector`` selects the front-end (``"orb"`` host OpenCV,
    ``"tpu"`` FAST+BRIEF on ``device``); ``mesh`` (several processes)
    process-shards the detection and matching (see the module docstring).
    The problem is the same on every rank, and the same as without
    ``mesh``."""
    K = len(keyframe_grays)
    info_stats: dict = {}
    uv_all, desc_all, valid_all, z_all = detect_keyframe_features(
        keyframe_grays, keyframe_depths, max_features,
        detector=detector, mesh=mesh, stats=info_stats, device=device,
    )

    pairs = [(i, i + 1) for i in range(K - 1)] + list(extra_pairs)
    idx_all, good_all = match_keyframe_pairs(
        desc_all, valid_all, pairs, mesh=mesh, stats=info_stats, device=device
    )

    uf = _UnionFind(K * max_features)

    def gid(k, i):
        return k * max_features + int(i)

    for pi, (a, b) in enumerate(pairs):
        for i in np.nonzero(good_all[pi])[0]:
            uf.union(gid(a, i), gid(b, idx_all[pi, i]))

    # Group keypoints into tracks, in the order their roots first appear.
    tracks: dict = {}
    for k in range(K):
        for i in np.nonzero(valid_all[k])[0]:
            root = uf.find(gid(k, i))
            tracks.setdefault(root, []).append((k, i))

    poses = np.asarray(keyframe_poses, np.float32)
    inv_poses = se3_inverse(torch.from_numpy(poses.copy())).numpy()

    cam_idx, lm_idx, obs, obs_z, points = [], [], [], [], []
    n_landmark = 0
    for members in tracks.values():
        # One observation per keyframe (guard against self-matches).
        seen = {}
        for k, i in members:
            seen.setdefault(k, i)
        if len(seen) < min_track_len:
            continue
        # Initialise from the first observation that has a valid depth.
        X_w = None
        for k, i in sorted(seen.items()):
            uv = uv_all[k, i]
            zi = float(z_all[k, i])
            if zi > 0:
                xc = np.asarray(
                    [(uv[0] - cam.cx) / cam.fx * zi,
                     (uv[1] - cam.cy) / cam.fy * zi, zi]
                )
                X_w = inv_poses[k, :3, :3] @ xc + inv_poses[k, :3, 3]
                break
        if X_w is None:
            continue
        li = n_landmark
        n_landmark += 1
        points.append(X_w)
        for k, i in sorted(seen.items()):
            uv = uv_all[k, i]
            cam_idx.append(k)
            lm_idx.append(li)
            obs.append(
                [(uv[0] - cam.cx) / cam.fx, (uv[1] - cam.cy) / cam.fy]
            )
            # Measured depth at the keypoint (0 → RGB-only observation).
            obs_z.append(float(z_all[k, i]))

    O = len(cam_idx)
    pad = (-O) % pad_to_multiple if O else pad_to_multiple
    cam_idx = np.asarray(cam_idx + [0] * pad, np.int32)
    lm_idx = np.asarray(lm_idx + [0] * pad, np.int32)
    obs = np.asarray(obs + [[0.0, 0.0]] * pad, np.float32)
    obs_z = np.asarray(obs_z + [0.0] * pad, np.float32)
    w = np.asarray([1.0] * O + [0.0] * pad, np.float32)
    if n_landmark == 0:
        points = [np.zeros(3)]
        n_landmark = 1

    def up(a):
        return torch.from_numpy(a).to(device)

    prob = BAProblem(
        poses=up(poses.copy()),
        points=up(np.stack(points).astype(np.float32)),
        cam_idx=up(cam_idx),
        lm_idx=up(lm_idx),
        obs=up(obs),
        w=up(w),
        obs_z=up(obs_z),
    )
    info = {
        "num_keyframes": K,
        "num_landmarks": n_landmark,
        "num_observations": O,
        "mean_track_len": (O / n_landmark) if n_landmark else 0.0,
        "detector": detector,
        **info_stats,
    }
    return prob, info
