"""TUM-format trajectory I/O and timestamp association.

Counterpart of the JAX package's ``eval/traj_io.py``: the TUM RGB-D benchmark
file format ("timestamp tx ty tz qx qy qz qw", camera→world convention), so
the standard evaluation tooling applies to the output unchanged, and the
benchmark's ``associate.py`` semantics (greedy nearest-timestamp matching
under a max difference). The pose arithmetic runs in float32 on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.lie import (
    quat_to_rotmat,
    rotmat_to_quat,
    rt_to_matrix,
    se3_inverse,
)


def write_tum_trajectory(path, timestamps, poses_wc):
    """Write world→camera poses as TUM camera→world lines."""
    poses_wc = torch.from_numpy(np.array(poses_wc, np.float32))
    T_cw = se3_inverse(poses_wc)
    q = rotmat_to_quat(T_cw[..., :3, :3]).numpy()  # (F, 4) w,x,y,z
    t = T_cw[..., :3, 3].numpy()
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, ti, qi in zip(np.asarray(timestamps), t, q):
            f.write(
                f"{ts:.6f} {ti[0]:.6f} {ti[1]:.6f} {ti[2]:.6f} "
                f"{qi[1]:.6f} {qi[2]:.6f} {qi[3]:.6f} {qi[0]:.6f}\n"
            )


def read_tum_trajectory(path):
    """Read a TUM trajectory file → ``(timestamps, poses_wc)``."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    arr = np.asarray(rows, np.float64)
    ts = arr[:, 0]
    t = torch.from_numpy(arr[:, 1:4].astype(np.float32))
    # File stores qx qy qz qw; our convention is (w, x, y, z).
    q = torch.from_numpy(
        np.stack([arr[:, 7], arr[:, 4], arr[:, 5], arr[:, 6]], axis=-1).astype(np.float32)
    )
    T_cw = rt_to_matrix(quat_to_rotmat(q), t)
    return ts, se3_inverse(T_cw).numpy()


def associate_timestamps(ts_a, ts_b, max_difference: float = 0.02):
    """Greedy closest-timestamp association (TUM ``associate.py`` semantics).

    Returns two index arrays (into a and b) of equal length, sorted by time.
    """
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    candidates = [
        (abs(a - b), i, j)
        for i, a in enumerate(ts_a)
        for j, b in enumerate(ts_b)
        if abs(a - b) < max_difference
    ]
    candidates.sort()
    used_a, used_b, pairs = set(), set(), []
    for _, i, j in candidates:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j))
    pairs.sort()
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ia, ib = zip(*pairs)
    return np.asarray(ia), np.asarray(ib)
