"""Checkpoint/resume: atomic ``.npz`` snapshots.

Counterpart of the JAX package's ``utils/checkpoint.py``, with the same keys
so either package resumes from the other's files: a ``np.savez`` of poses,
keyframe state and edges (and the BA state for a BA run) written through an
atomic rename, so a killed run resumes from the last consistent snapshot.
Keyframe ICP pyramids are not stored: on resume they are rebuilt from the
sequence's depth images on the odometry's device.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def _atomic_savez(path: str, **arrays):
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_odometry_checkpoint(path: str, odo, next_frame: int):
    kf_idx = np.asarray([k.index for k in odo.keyframes], np.int64)
    kf_poses = (
        np.stack([k.pose for k in odo.keyframes])
        if odo.keyframes
        else np.zeros((0, 4, 4), np.float32)
    )
    edges_i = np.asarray([e[0] for e in odo.odom_edges], np.int64)
    edges_j = np.asarray([e[1] for e in odo.odom_edges], np.int64)
    edges_T = (
        np.stack([e[2] for e in odo.odom_edges])
        if odo.odom_edges
        else np.zeros((0, 4, 4), np.float32)
    )
    _atomic_savez(
        path,
        next_frame=np.int64(next_frame),
        poses=np.stack(odo.poses) if odo.poses else np.zeros((0, 4, 4), np.float32),
        kf_idx=kf_idx,
        kf_poses=kf_poses,
        edges_i=edges_i,
        edges_j=edges_j,
        edges_T=edges_T,
        last_rel=odo._last_rel if odo._last_rel is not None else np.eye(4, dtype=np.float32),
    )


def load_odometry_checkpoint(path: str, odo, seq) -> int:
    """Restore odometry state; returns the next frame index to process.

    Keyframe pyramids are rebuilt from the sequence's depth images.
    """
    if not os.path.exists(path):
        return 0
    with np.load(path) as f:
        z = dict(f)
    odo.poses = list(z["poses"])
    for idx, pose in zip(z["kf_idx"], z["kf_poses"]):
        _, _, depth = seq.frame(int(idx))
        frame, ref_w = odo._make_frame(odo._to_device(np.asarray(depth, np.float32)), None)
        odo._new_keyframe(int(idx), pose, frame, ref_w)
    odo.odom_edges = [
        (int(i), int(j), T)
        for i, j, T in zip(z["edges_i"], z["edges_j"], z["edges_T"])
    ]
    odo._last_rel = z["last_rel"]
    return int(z["next_frame"])


def save_ba_checkpoint(path: str, **state):
    """BA iteration snapshot: poses, landmarks, iteration counter, ..."""
    _atomic_savez(path, **state)


def load_ba_checkpoint(path: str):
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        return dict(f)
