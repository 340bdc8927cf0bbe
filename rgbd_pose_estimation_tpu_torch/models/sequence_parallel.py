"""Sequence-parallel offline odometry: chunked processing + graph stitching.

Counterpart of the JAX package's ``models/sequence_parallel.py``. The
sequence is split into P overlapping chunks; each chunk runs dense ICP
odometry *independently*, in a host thread of its own, and the overlap
frames yield relative-anchor constraints that a small SE(3) pose graph
solves to stitch the chunks into one consistent trajectory.

Across ranks (``mesh=``, a ``parallel/mesh.py`` mesh of several ranks):
each rank tracks only its contiguous share of the chunks, then the
fixed-size per-chunk pose arrays and keyframe flags are exchanged with ONE
``allgather_hosts``, after which every rank runs the same anchor pose graph
on the same inputs. Frames outside a rank's chunks are never read from
``depths``, so a lazy loader (``cli/main.py``) shards the decoding too. On a
mesh of one rank the result is the one of ``mesh=None``, bit for bit.

Math: chunk k stores local poses Q_k(f) (chunk-start camera = chunk world).
A frame f in the overlap of chunks k-1 and k ties their global anchors
A_{k-1}, A_k via  A_k A_{k-1}^-1 = Q_k(f)^-1 Q_{k-1}(f);  every overlap
frame contributes one pose-graph edge, so stitching averages over the
overlap instead of trusting a single frame.

Threads on one card: every chunk launches on the caller's current stream,
so the chunks' kernels run one after another on the card while their host
work (Python, the dispatcher, the launches) overlaps. The tracks are bound by
the host's launches, not by the card, so a stream a chunk would buy little,
and one stream keeps two things simple: the fused ICP step's ticket
(``ops/icp_jtj.py::_ticket``, one a stream) is shared by launches that run
in order, and every tensor is used on the stream it was made on, so the
caching allocator needs no ``record_stream``. A chunk hands back host arrays
only.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_inverse
from rgbd_pose_estimation_tpu_torch.graph.pose_graph import optimize_pose_graph
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry
from rgbd_pose_estimation_tpu_torch.parallel.mesh import allgather_hosts
from rgbd_pose_estimation_tpu_torch.utils.config import (
    IcpConfig,
    KeyframeConfig,
    PoseGraphConfig,
)


def chunk_ranges(n_frames: int, n_chunks: int, overlap: int):
    """[(start, end)] covering [0, n) with ``overlap`` shared frames."""
    base = int(np.ceil(n_frames / n_chunks))
    out = []
    for c in range(n_chunks):
        s = c * base
        e = min(n_frames, s + base + overlap)
        if s >= n_frames:
            break
        out.append((s, e))
    return out


def _run_chunk(cam, icp_cfg, kf_cfg, frames, device):
    odo = DenseOdometry(cam, icp_cfg, kf_cfg, device=device)
    for depth in frames:
        odo.process(depth)
    # Local trajectory (first frame = identity) + the keyframe indices the
    # tracker itself chose, which downstream stages consume.
    return odo.trajectory(), [k.index for k in odo.keyframes]


def _exchange_chunks(mesh, ranges, local, local_results):
    """All-gather the per-chunk odometry results across the ranks.

    Packs each local chunk into a fixed-size ``(max_len, 17)`` f32 row (16
    = the flattened 4x4 pose, 1 = the keyframe flag; the poses are f32 at
    both ends, so their bits ride exactly), exchanges the disjoint-support
    ``(C, max_len, 17)`` arrays with ONE ``allgather_hosts`` and sums the
    ranks' contributions. Returns the full per-chunk ``(poses, kf_indices)``
    list, the same on every rank.
    """
    C = len(ranges)
    max_len = max(e - s for s, e in ranges)
    pack = np.zeros((C, max_len, 17), np.float32)
    for c, res in zip(local, local_results):
        L = ranges[c][1] - ranges[c][0]
        if isinstance(res, tuple):
            poses, kfs = res
            for k in kfs:
                pack[c, k, 16] = 1.0
        else:
            # A poses-only runner: a sentinel in the keyframe channel keeps
            # the None across the exchange (return_keyframes=True must
            # still raise, as on one rank).
            poses = res
            pack[c, :L, 16] = -1.0
        pack[c, :L, :16] = np.asarray(poses, np.float32).reshape(L, 16)
    total = allgather_hosts(mesh, pack).sum(axis=0)
    out = []
    for c, (s, e) in enumerate(ranges):
        L = e - s
        poses = total[c, :L, :16].reshape(L, 4, 4)
        if L and total[c, 0, 16] < 0:
            out.append(poses)  # the owner ran a poses-only runner
        else:
            kfs = [int(k) for k in np.nonzero(total[c, :L, 16] > 0)[0]]
            out.append((poses, kfs))
    return out


def local_chunk_indices(n_chunks: int, n_procs: int, pid: int) -> list:
    """Contiguous chunk→process partition: process ``pid``'s chunk ids.

    Contiguous (not round-robin) so each process's frame window — and hence
    its decode I/O under a lazy loader — is one contiguous span.
    """
    bounds = np.linspace(0, n_chunks, n_procs + 1).round().astype(int)
    return list(range(bounds[pid], bounds[pid + 1]))


def sequence_parallel_odometry(
    cam: CameraIntrinsics,
    depths: Sequence[np.ndarray],
    n_chunks: int = 2,
    overlap: int = 3,
    icp_cfg: IcpConfig = IcpConfig(),
    kf_cfg: KeyframeConfig = KeyframeConfig(),
    pg_cfg: PoseGraphConfig = PoseGraphConfig(),
    chunk_runner: Callable = None,
    parallel: bool = True,
    return_keyframes: bool = False,
    mesh=None,
    stats: Optional[dict] = None,
    device=None,
):
    """Estimate the full trajectory with chunk-parallel odometry on ``device``.

    ``chunk_runner(frames) -> local_poses`` (or ``(local_poses,
    kf_indices)``) defaults to dense ICP odometry on ``device``; inject a
    different tracker for testing. ``parallel`` runs the chunks in one host
    thread each. Returns ``(F, 4, 4)`` float32 host poses (world→camera,
    first frame = identity); with ``return_keyframes=True`` also the sorted
    global frame indices of the keyframes each chunk's tracker chose
    (overlap-frame duplicates dropped). ``stats`` (a dict, mutated in place)
    reports ``local_chunks`` / ``frames_tracked`` of this rank. The anchor
    pose graph runs on ``device``: by default the mesh's device, else the
    CUDA device.

    ``mesh`` (``parallel/mesh.py``): with more than one rank, each rank
    tracks ONLY its contiguous share of the chunks and the per-chunk results
    are exchanged with one all-gather before the stitch, which every rank
    runs alike (module docstring).
    """
    if device is None:
        device = mesh.device if mesh is not None else "cuda"
    device = torch.device(device)
    n = len(depths)
    ranges = chunk_ranges(n, n_chunks, overlap)
    C = len(ranges)
    runner = chunk_runner or (
        lambda frames: _run_chunk(cam, icp_cfg, kf_cfg, frames, device)
    )
    # A rank is a process: the reference's process count is the group's size.
    procs = mesh.size if mesh is not None else 1
    local = local_chunk_indices(C, procs, mesh.rank) if procs > 1 else list(range(C))
    if stats is not None:
        stats["local_chunks"] = len(local)
        stats["frames_tracked"] = sum(ranges[c][1] - ranges[c][0] for c in local)

    # A new thread starts on the device's default stream: hand it the
    # caller's, so that every chunk launches on one stream (module docstring).
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None

    def _run(c):
        s, e = ranges[c]
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            return runner([depths[i] for i in range(s, e)])

    if parallel and len(local) > 1:
        with concurrent.futures.ThreadPoolExecutor(len(local)) as ex:
            results = list(ex.map(_run, local))
    else:
        results = [_run(c) for c in local]
    if procs > 1:
        results = _exchange_chunks(mesh, ranges, local, results)

    # Custom runners may return poses only. Poses are normalized to f32 on
    # every path (the exchange packs f32).
    locals_, kfs_ = zip(*(
        res if isinstance(res, tuple) else (res, None) for res in results
    ))
    locals_ = tuple(np.asarray(ps, np.float32) for ps in locals_)

    def _keyframes(out):
        kf_global = set()
        for c, (s, e) in enumerate(ranges):
            stop = ranges[c + 1][0] if c + 1 < C else n
            if kfs_[c] is None:
                raise ValueError(
                    "return_keyframes=True needs chunk_runner to return "
                    "(poses, keyframe_indices)"
                )
            for k in kfs_[c]:
                f = s + k
                # Each frame's pose is emitted by exactly one chunk; its
                # keyframe decision comes from the same chunk.
                if s <= f < stop:
                    kf_global.add(f)
        return out, sorted(kf_global)

    if C == 1:
        return _keyframes(locals_[0]) if return_keyframes else locals_[0]

    # Anchor pose graph: node c = global pose of chunk c's first frame.
    edges_i, edges_j, T_meas, weights = [], [], [], []
    anchors0 = [np.eye(4, dtype=np.float32)]
    for c in range(1, C):
        s_prev, e_prev = ranges[c - 1]
        s_cur, e_cur = ranges[c]
        ov = range(s_cur, min(e_prev, e_cur))
        rels = []
        for f in ov:
            Q_prev = locals_[c - 1][f - s_prev]
            Q_cur = locals_[c][f - s_cur]
            # A_c A_{c-1}^-1 = Q_c(f)^-1 Q_{c-1}(f)
            M = se3_inverse(torch.from_numpy(Q_cur.copy())).numpy() @ Q_prev
            rels.append(M)
            edges_i.append(c)
            edges_j.append(c - 1)
            T_meas.append(M)
            weights.append(1.0)
        anchors0.append(rels[len(rels) // 2] @ anchors0[-1])

    def ship(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    T_opt, _ = optimize_pose_graph(
        ship(np.stack(anchors0), np.float32),
        ship(edges_i, np.int32),
        ship(edges_j, np.int32),
        ship(np.stack(T_meas), np.float32),
        ship(weights, np.float32),
        pg_cfg,
    )
    anchors = T_opt.cpu().numpy()

    # Emit one pose per frame; frames before the next chunk's start come
    # from the current chunk.
    out = np.empty((n, 4, 4), np.float32)
    for c, (s, e) in enumerate(ranges):
        stop = ranges[c + 1][0] if c + 1 < C else n
        for f in range(s, stop):
            out[f] = locals_[c][f - s] @ anchors[c]
    return _keyframes(out) if return_keyframes else out
