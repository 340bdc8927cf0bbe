"""ICL-NUIM dataset loading (Handa et al. 2014), both public layouts.

Counterpart of the JAX package's ``data/icl_nuim.py`` (configuration 5 names
"TUM + ICL-NUIM"). The layout is detected:

1. **TUM-compatible release** (``rgb.txt``/``depth.txt``/16-bit PNG depth at
   1/5000): read through :class:`~.tum.TumSequence`.
2. **Raw POV-Ray release**: per-frame ``scene_XX_NNN.depth`` text files of
   **Euclidean ray lengths** (not planar z), same-stem ``.png`` colour and a
   ``*.gt.freiburg`` ground truth (TUM format, timestamp = frame number).
   Ray lengths become planar depth via
   ``z = r / ||((u-cx)/fx, (v-cy)/fy, 1)||``.

Intrinsics: the TUM-compatible release documents fx=481.20 fy=480.0
cx=319.50 cy=239.50. The raw POV-Ray camera has fy = -480: its frames are
stored y-flipped against the ground truth, so the raw reader defaults to the
negative-fy model and un-flips each frame on load, publishing the
positive-fy camera. A shipped ``intrinsics.txt`` always wins; fy < 0 there
requests the flip, fy > 0 reads frames as they are (the synthetic writer's
case).
"""

from __future__ import annotations

import os
import re

import numpy as np

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.data import native_loader, png
from rgbd_pose_estimation_tpu_torch.data.tum import (
    TumSequence,
    quantize_gray8,
    render_synthetic,
)
from rgbd_pose_estimation_tpu_torch.eval.traj_io import (
    associate_timestamps,
    read_tum_trajectory,
    write_tum_trajectory,
)


def icl_nuim_intrinsics(
    width: int = 640, height: int = 480, raw: bool = False
) -> CameraIntrinsics:
    """The published ICL-NUIM pinhole model (``raw=True``: the raw render
    camera, whose fy is negative because its frames are stored y-flipped)."""
    s = width / 640.0
    fy = -480.0 if raw else 480.0
    return CameraIntrinsics(
        481.20 * s, fy * s, 319.50 * s, 239.50 * s, width, height
    )


def euclidean_ray_to_planar_depth(ray_len: np.ndarray, cam: CameraIntrinsics):
    """ICL ``.depth`` Euclidean ray lengths (H, W) → planar z depth: the
    ray length over the norm of the pixel's ray at unit z."""
    h, w = ray_len.shape
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    norm = np.sqrt(x * x + y * y + 1.0).astype(np.float32)
    return (ray_len.astype(np.float32) / norm).astype(np.float32)


def _read_cam_file(root: str) -> CameraIntrinsics | None:
    """``intrinsics.txt`` (fx fy cx cy w h) when the sequence ships one: the
    ray→planar conversion is only right with the camera that rendered it."""
    path = os.path.join(root, "intrinsics.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        vals = [float(x) for x in f.read().split()]
    return CameraIntrinsics(*vals[:4], int(vals[4]), int(vals[5]))


def _frame_number(path: str) -> int:
    m = re.search(r"(\d+)\.(?:depth|png)$", os.path.basename(path))
    return int(m.group(1)) if m else -1


def is_raw_icl_dir(root: str) -> bool:
    """True when ``root`` holds the raw POV-Ray layout (``*.depth`` files)."""
    try:
        return any(f.endswith(".depth") for f in os.listdir(root))
    except OSError:
        return False


class IclNuimSequence:
    """An ICL-NUIM sequence on disk, either layout, with the surface of
    :class:`TumSequence` (``__len__``, ``frame(i) -> (ts, gray, depth)``,
    ``groundtruth_aligned()``)."""

    def __init__(self, root: str, cam: CameraIntrinsics | None = None):
        self.root = root
        self._raw = is_raw_icl_dir(root)
        self.cam = (
            cam
            or _read_cam_file(root)
            or icl_nuim_intrinsics(raw=self._raw)
        )
        # fy < 0 marks y-flipped storage (the public raw release): frames
        # are un-flipped on load and the published camera has positive fy.
        self._vflip = self.cam.fy < 0
        if self._vflip:
            self.cam = CameraIntrinsics(
                self.cam.fx, -self.cam.fy, self.cam.cx, self.cam.cy,
                self.cam.width, self.cam.height,
            )
        if self._raw:
            self._init_raw(root)
        else:
            self._tum = TumSequence(root)
            self.timestamps = self._tum.timestamps

    def _init_raw(self, root: str):
        depth_files = sorted(
            (os.path.join(root, f) for f in os.listdir(root) if f.endswith(".depth")),
            key=_frame_number,
        )
        if not depth_files:
            raise FileNotFoundError(f"no .depth files under {root}")
        self.depth_files = depth_files
        self.rgb_files = [p[: -len(".depth")] + ".png" for p in depth_files]
        # Raw ICL ground truth uses the frame number as the timestamp.
        self.timestamps = np.asarray([float(_frame_number(p)) for p in depth_files])
        gt = [
            os.path.join(root, f)
            for f in os.listdir(root)
            if f.endswith(".gt.freiburg") or f == "groundtruth.txt"
        ]
        if gt:
            self.gt_timestamps, self.gt_poses = read_tum_trajectory(gt[0])
        else:
            self.gt_timestamps, self.gt_poses = None, None

    def __len__(self):
        return len(self.timestamps)

    def frame(self, i: int):
        """``(timestamp, gray float32 (H,W) in [0,1], planar depth meters)``."""
        if not self._raw:
            return self._tum.frame(i)
        ray = np.loadtxt(self.depth_files[i], dtype=np.float32)
        if ray.ndim == 1:  # single-line stream variant of the raw release
            ray = ray.reshape(self.cam.height, self.cam.width)
        elif ray.shape != (self.cam.height, self.cam.width):
            raise ValueError(
                f"{self.depth_files[i]}: shape {ray.shape} does not match "
                f"camera {(self.cam.height, self.cam.width)}; ship an "
                "intrinsics.txt or pass cam= explicitly"
            )
        if self._vflip:
            # cy is the exact image centre, so ray→planar commutes with the
            # flip: un-flip first.
            ray = ray[::-1]
        depth = euclidean_ray_to_planar_depth(ray, self.cam)
        depth[~np.isfinite(depth)] = 0.0
        depth[depth < 0] = 0.0
        depth = np.ascontiguousarray(depth)
        if os.path.exists(self.rgb_files[i]):
            gray = native_loader.decode_gray8(self.rgb_files[i]).astype(np.float32) / 255.0
            if self._vflip:
                gray = np.ascontiguousarray(gray[::-1])
        else:  # depth-only raw dumps exist; flat intensity
            gray = np.zeros_like(depth)
        return float(self.timestamps[i]), gray, depth

    def groundtruth_aligned(self):
        if not self._raw:
            return self._tum.groundtruth_aligned()
        if self.gt_timestamps is None:
            return np.zeros(0, np.int64), np.zeros((0, 4, 4), np.float32)
        ia, ib = associate_timestamps(
            self.timestamps, self.gt_timestamps, max_difference=0.5
        )
        return ia, self.gt_poses[ib]


def open_sequence(root: str, cam: CameraIntrinsics | None = None):
    """A dataset directory as TUM or ICL-NUIM: the raw ICL layout gives an
    :class:`IclNuimSequence`, anything with ``rgb.txt`` a
    :class:`TumSequence` (for ICL's TUM-compatible release pass
    ``cam=icl_nuim_intrinsics()`` downstream)."""
    if is_raw_icl_dir(root):
        return IclNuimSequence(root, cam)
    return TumSequence(root)


def write_synthetic_icl(
    root: str,
    n_frames: int = 8,
    size=(160, 120),
    motion_scale: float = 0.01,
    seed: int = 0,
    device="cuda",
):
    """Render the analytic scene into a *raw* ICL-format directory:
    ``scene_00_N.depth`` (Euclidean ray lengths, text, as ``np.savetxt``
    writes them with ``%.6f``), ``.png`` colour and ``scene_00.gt.freiburg``.
    The trajectory as in :func:`~.tum.write_synthetic_tum`. Returns the
    CameraIntrinsics used."""
    w, h = size
    cam = CameraIntrinsics(w * 1.0, w * 1.0, w / 2 - 0.5, h / 2 - 0.5, w, h)
    poses, depths, intensities = render_synthetic(cam, n_frames, motion_scale, seed, device)
    os.makedirs(root, exist_ok=True)
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    ray_norm = np.sqrt(
        ((u - cam.cx) / cam.fx) ** 2 + ((v - cam.cy) / cam.fy) ** 2 + 1.0
    )
    ts = np.arange(n_frames, dtype=np.float64)
    for i in range(n_frames):
        z = depths[i].cpu().numpy().astype(np.float32)
        np.savetxt(os.path.join(root, f"scene_00_{i}.depth"), z * ray_norm, fmt="%.6f")
        gray8 = quantize_gray8(intensities[i])
        png.write_png(os.path.join(root, f"scene_00_{i}.png"), np.repeat(gray8[..., None], 3, axis=-1))
    write_tum_trajectory(os.path.join(root, "scene_00.gt.freiburg"), ts, poses.cpu().numpy())
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy} {cam.width} {cam.height}\n")
    return cam
