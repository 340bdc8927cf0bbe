"""TUM RGB-D dataset loading: association, decode, synthetic fixture writer.

Counterpart of the JAX package's ``data/tum.py``: ``rgb.txt``/``depth.txt``
timestamp association (greedy nearest match, the benchmark's
``associate.py`` behaviour), 16-bit PNG depth divided by 5000 to metres,
optional ``groundtruth.txt`` poses. Frames leave this module as float32
numpy on the host.

Decoding goes through ``data/native_loader.py`` (libpng, or the standard
library codec of ``data/png.py`` where that cannot be built).
``write_synthetic_tum`` renders the analytic scene with the port's
``data/synthetic.py`` and encodes with ``data/png.py``, so it needs neither
OpenCV nor JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.data import native_loader, png
from rgbd_pose_estimation_tpu_torch.eval.traj_io import (
    associate_timestamps,
    read_tum_trajectory,
    write_tum_trajectory,
)


def _read_file_list(path):
    ts, files = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ts.append(float(parts[0]))
            files.append(parts[1])
    return np.asarray(ts), files


class TumSequence:
    """An associated TUM RGB-D sequence on disk."""

    def __init__(self, root: str, max_difference: float = 0.02):
        self.root = root
        rgb_ts, rgb_files = _read_file_list(os.path.join(root, "rgb.txt"))
        dep_ts, dep_files = _read_file_list(os.path.join(root, "depth.txt"))
        ia, ib = associate_timestamps(rgb_ts, dep_ts, max_difference)
        self.timestamps = rgb_ts[ia]
        self.rgb_files = [rgb_files[i] for i in ia]
        self.depth_files = [dep_files[i] for i in ib]
        self.depth_scale = 1.0 / 5000.0
        gt_path = os.path.join(root, "groundtruth.txt")
        if os.path.exists(gt_path):
            self.gt_timestamps, self.gt_poses = read_tum_trajectory(gt_path)
        else:
            self.gt_timestamps, self.gt_poses = None, None

    def __len__(self):
        return len(self.timestamps)

    def frame(self, i: int):
        """Returns ``(timestamp, gray float32 (H,W) in [0,1], depth float32
        meters)``; invalid depth is 0."""
        gray = native_loader.decode_gray8(os.path.join(self.root, self.rgb_files[i]))
        gray = gray.astype(np.float32) / 255.0
        depth_raw = native_loader.decode_depth16(os.path.join(self.root, self.depth_files[i]))
        depth = depth_raw.astype(np.float32) * self.depth_scale
        return float(self.timestamps[i]), gray, depth

    def groundtruth_aligned(self):
        """Ground-truth poses (world→camera) matched to frame timestamps.

        Returns ``(frame_indices, poses)`` for frames with GT within 20ms.
        """
        if self.gt_timestamps is None:
            return np.zeros(0, np.int64), np.zeros((0, 4, 4), np.float32)
        ia, ib = associate_timestamps(self.timestamps, self.gt_timestamps)
        return ia, self.gt_poses[ib]


def quantize_gray8(intensity: torch.Tensor) -> np.ndarray:
    """Intensity in [0, 1] → uint8 as the writers store it (× 255, clipped,
    truncated)."""
    return torch.clamp(intensity * 255.0, 0, 255).to(torch.uint8).cpu().numpy()


def quantize_depth16(depth: torch.Tensor) -> np.ndarray:
    """Depth in metres → TUM's uint16 units (× 5000, clipped, truncated)."""
    return torch.clamp(depth * 5000.0, 0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)


def render_synthetic(cam, n_frames, motion_scale, seed, device="cuda"):
    """The analytic scene's sequence as the synthetic writers render it:
    ``synthetic_sequence`` from a ``torch.Generator`` seeded with ``seed`` on
    ``device``."""
    from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return synthetic_sequence(cam, gen, n_frames, motion_scale, device=device)


def write_synthetic_tum(
    root: str,
    n_frames: int = 20,
    size=(160, 120),
    motion_scale: float = 0.01,
    seed: int = 0,
    device="cuda",
):
    """Render the analytic scene into a TUM-format dataset directory.

    Returns the CameraIntrinsics used. PNG depth is 16-bit / 5000, intensity
    is replicated to 8-bit RGB — the format of real TUM data. The trajectory
    is drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the JAX package's writer draws from ``jax.random``: the two render
    different sequences).
    """
    w, h = size
    cam = CameraIntrinsics(w * 1.0, w * 1.0, w / 2 - 0.5, h / 2 - 0.5, w, h)
    poses, depths, intensities = render_synthetic(cam, n_frames, motion_scale, seed, device)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    ts = 1000.0 + np.arange(n_frames) / 30.0
    rgb_lines, depth_lines = [], []
    for i in range(n_frames):
        name = f"{ts[i]:.6f}.png"
        gray8 = quantize_gray8(intensities[i])
        png.write_png(os.path.join(root, "rgb", name), np.repeat(gray8[..., None], 3, axis=-1))
        png.write_png(os.path.join(root, "depth", name), quantize_depth16(depths[i]))
        rgb_lines.append(f"{ts[i]:.6f} rgb/{name}")
        depth_lines.append(f"{ts[i]:.6f} depth/{name}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# ts filename\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# ts filename\n" + "\n".join(depth_lines) + "\n")
    write_tum_trajectory(os.path.join(root, "groundtruth.txt"), ts, poses.cpu().numpy())
    # Record the render camera so that a reader can use it exactly.
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy} {cam.width} {cam.height}\n")
    return cam
