"""Dense RGB-D odometry over a sequence (configuration 3, ``configs/config3_*.yaml``).

Counterpart of the JAX package's ``models/odometry.py``. The host loop is the
*only* loop: everything per frame is one ``icp_track`` call (pyramid build
included) that never reads a value back. Tracks frame-to-keyframe: each new
frame is registered against the current keyframe, and a new keyframe is
spawned when the association overlap drops (or a max interval passes), which
bounds drift accumulation compared to strict frame-to-frame chaining. Emits
per-frame JSONL metrics and keeps the keyframe list + odometry edges that the
pose graph (config 4) consumes.

Two ingestion modes:

- :meth:`DenseOdometry.process` — synchronous, returns the frame's pose
  immediately (one device→host fetch per frame).
- :meth:`DenseOdometry.process_stream` — pipelined: frame i+1's track is
  dispatched *before* frame i's result is fetched, so the host never waits
  for the device while it has a frame to enqueue. Identical math; the only
  semantic difference is that keyframe adoption lags (the decision for frame
  i lands while i+1 is already in flight against the previous keyframe — both
  tracks are geometrically valid, drift behavior is unchanged in practice).

On a CUDA device nothing in either mode waits for the stream except where a
result is read: frames go up through pinned memory by non-blocking copies,
and every track's ``(T, stats)`` and its frame's association mass come down
into a pinned host buffer by a non-blocking copy with an event recorded
behind it; the result is read only after that event.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.data.geometry import (
    downsample_depth,
    downsample_intensity,
)
from rgbd_pose_estimation_tpu_torch.icp.dense import icp_track, make_icp_frame
from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig, KeyframeConfig
from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger


def _inv_se3_np(T: np.ndarray) -> np.ndarray:
    """Host-side rigid-transform inverse — a 4×4 is not worth a device trip."""
    R = T[:3, :3]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


@dataclasses.dataclass
class Keyframe:
    index: int  # frame index in the sequence
    pose: np.ndarray  # world→camera (4, 4)
    frame: object  # IcpFrame pyramid (device tensors)
    descriptor: Optional[np.ndarray] = None  # loop-closure descriptor
    # Association mass of perfect self-overlap (device scalar, fetched
    # lazily on first use so keyframe creation costs no extra round-trip).
    ref_weight: object = None

    def ref_weight_value(self) -> float:
        if self.ref_weight is None:
            # Directly-constructed keyframes (tests, pose-graph code) carry
            # no association mass; treat as "no reference" rather than crash.
            return 0.0
        if not isinstance(self.ref_weight, float):
            self.ref_weight = float(self.ref_weight)
        return self.ref_weight


def _as_tensor(a) -> torch.Tensor:
    """A host array → a CPU tensor of the same element type (floats other
    than float32 become float32)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating) and a.dtype != np.float32:
        a = a.astype(np.float32)
    if not a.flags.writeable:
        a = a.copy()  # a tensor cannot wrap read-only memory
    return torch.from_numpy(np.ascontiguousarray(a))


class DenseOdometry:
    """Frame-to-keyframe dense ICP odometry with keyframe management."""

    def __init__(
        self,
        cam: CameraIntrinsics,
        icp_cfg: IcpConfig = IcpConfig(),
        kf_cfg: KeyframeConfig = KeyframeConfig(),
        metrics: Optional[MetricsLogger] = None,
        depth_scale: float = 1.0 / 5000.0,
        device=torch.device("cuda"),
    ):
        # Tracking runs at cam/downscale resolution (IcpConfig.downscale);
        # self.cam is the TRACKING camera — loop-closure ICP and overlap
        # bookkeeping stay consistent with the stored pyramids.
        self.cam_full = cam
        ds = icp_cfg.downscale
        if ds < 1 or (ds & (ds - 1)) != 0:
            raise ValueError("downscale must be a power of 2")
        self.cam = cam.scaled(1.0 / ds) if ds > 1 else cam
        self.icp_cfg = icp_cfg
        self.kf_cfg = kf_cfg
        self.metrics = metrics or MetricsLogger()
        self.depth_scale = depth_scale
        self.device = torch.device(device)
        self.poses: List[np.ndarray] = []  # world→camera per frame
        self.keyframes: List[Keyframe] = []
        self.odom_edges: List[tuple] = []  # (kf_i, kf_j, T_ij) relative
        self._kf_pose_inv = None  # camera→world of current keyframe
        self._last_rel = None  # last frame's pose relative to keyframe (host)

    # --- internals ------------------------------------------------------

    def _make_frame(self, d: torch.Tensor, intensity: Optional[torch.Tensor]):
        """Depth on the device → (pyramid, association mass of the frame
        against itself), all on the device."""
        if not d.dtype.is_floating_point:
            # Raw sensor units shipped as-is (uint16 halves the H2D bytes);
            # convert to meters here, on the device. PyTorch implements few
            # operations for uint16, so its bits go through int16 → int32.
            if d.dtype == torch.uint16:
                d = d.view(torch.int16).to(torch.int32) & 0xFFFF
            d = d.to(torch.float32) * self.depth_scale
        for _ in range(self.icp_cfg.downscale.bit_length() - 1):
            d = downsample_depth(d)
            if intensity is not None:
                intensity = downsample_intensity(intensity)
        frame = make_icp_frame(self.cam, d, self.icp_cfg, intensity)
        n0 = frame.normals[0]
        ref_w = torch.sum(torch.sum(n0 * n0, dim=-1) > 0.5).to(torch.float32)
        return frame, ref_w

    def _to_device(self, depth) -> torch.Tensor:
        expect = (self.cam_full.height, self.cam_full.width)
        if tuple(depth.shape[-2:]) != expect:
            raise ValueError(
                f"frame shape {tuple(depth.shape[-2:])} does not match the "
                f"camera ({expect}); pass the matching CameraIntrinsics"
            )
        if isinstance(depth, torch.Tensor) and depth.device == self.device:
            return depth  # already shipped (e.g. by process_stream's batching)
        return self._ship(_as_tensor(depth))

    def _ship(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor → the device. On a CUDA device through pinned memory
        and without blocking: a copy from pageable memory would wait for
        every track already enqueued."""
        if self.device.type == "cuda" and not t.is_cuda:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _bootstrap(self, i, frame, ref_w, t0):
        pose = np.eye(4, dtype=np.float32)
        self._new_keyframe(i, pose, frame, ref_w)
        self.poses.append(pose)
        self.metrics.log(frame=i, ms=(time.perf_counter() - t0) * 1e3, keyframe=True)
        return pose

    def _dispatch(self, frame, ref_w, kf, T_init):
        """Enqueue one track and the copy of its result (with the frame's
        association mass) to the host. Returns the in-flight record; ``T``
        stays on the device so that the next frame can start from it without
        a synchronisation."""
        T, stats = icp_track(self.cam, self.icp_cfg, T_init, frame, kf.frame)
        packed = torch.cat([T.reshape(16), stats, ref_w.reshape(1)])
        ready = None
        if self.device.type == "cuda":
            host = torch.empty(19, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host = packed
        return {"kf": kf, "frame": frame, "T": T, "host": host, "ready": ready}

    def _resolve(self, i, rec, t0, pipelined=False):
        """Fetch a dispatched track, update poses/keyframes, return pose.

        ``pipelined`` marks stream-mode records whose wall-clock spans the
        ingestion and dispatch of later frames — the flag is logged so the
        ms column is not compared against :meth:`process` timings.
        """
        if rec["ready"] is not None:
            rec["ready"].synchronize()  # the copy, and nothing else
        out = rec["host"].numpy()
        T_rel_np, wsum, ref_w = out[:16].reshape(4, 4).copy(), float(out[17]), float(out[18])
        kf = rec["kf"]

        # World pose: x_w = kf_pose^-1 · T_rel · x_cam → pose = (·)^-1.
        kf_pose_inv = (
            self._kf_pose_inv
            if kf is self.keyframes[-1]
            else _inv_se3_np(np.asarray(kf.pose, np.float32))
        )
        pose = _inv_se3_np(kf_pose_inv @ T_rel_np)
        self.poses.append(pose)
        self._last_rel = T_rel_np

        overlap = wsum / max(kf.ref_weight_value(), 1e-6)
        is_kf = (
            overlap < self.kf_cfg.min_inlier_ratio
            or (i - kf.index) >= self.kf_cfg.max_interval
        )
        if is_kf and len(self.keyframes) < self.kf_cfg.max_keyframes:
            self.odom_edges.append((kf.index, i, T_rel_np))
            self._new_keyframe(i, pose, rec["frame"], ref_w)
        self.metrics.log(
            frame=i,
            ms=(time.perf_counter() - t0) * 1e3,
            overlap=overlap,
            keyframe=bool(is_kf),
            **({"pipelined": True} if pipelined else {}),
        )
        return pose

    def _new_keyframe(self, i, pose, frame, ref_w):
        self.keyframes.append(Keyframe(i, pose, frame, None, ref_w))
        self._kf_pose_inv = _inv_se3_np(np.asarray(pose, dtype=np.float32))
        self._last_rel = np.eye(4, dtype=np.float32)

    # --- synchronous API --------------------------------------------------

    def process(
        self,
        depth,
        frame_index: Optional[int] = None,
        intensity=None,
    ):
        """Ingest the next depth frame; returns its world→camera pose.

        ``depth`` is (H, W): float meters, or integer sensor units (uint16
        too) that ``depth_scale`` turns into meters on the device. Pass
        ``intensity`` (H, W float in [0,1]) when
        ``IcpConfig.photometric_weight > 0`` to add the DVO-style intensity
        residual — required on geometry-degenerate (flat, textured) scenes.
        """
        t0 = time.perf_counter()
        i = frame_index if frame_index is not None else len(self.poses)
        use_photo = (
            self.icp_cfg.photometric_weight > 0 and intensity is not None
        )
        frame, ref_w = self._make_frame(
            self._to_device(depth),
            self._to_device(intensity) if use_photo else None,
        )
        if not self.keyframes:
            return self._bootstrap(i, frame, ref_w, t0)
        kf = self.keyframes[-1]
        rec = self._dispatch(frame, ref_w, kf, self._ship(torch.from_numpy(self._last_rel)))
        return self._resolve(i, rec, t0)

    # --- pipelined streaming API ----------------------------------------

    def process_stream(
        self,
        depths,
        start_index: int = 0,
        h2d_batch: int = 1,
        pipeline_depth: int = 2,
    ):
        """Track an iterable of depth frames, pipelined; yields (i, pose).

        Dispatches frame i+1's track before fetching frame i's result.
        ``T_init`` for the in-flight frame chains from the *device-resident*
        previous result (no sync on the critical path); after a keyframe
        switch it falls back to the host value exactly like :meth:`process`.

        ``h2d_batch > 1`` stacks that many host frames (in pinned memory on
        a CUDA device) into ONE host→device transfer and hands the tracker
        device-side slices. Tracking math and keyframe decisions are
        unchanged; only ingestion granularity differs (adds ≤h2d_batch
        frames of latency).

        ``pipeline_depth`` frames stay in flight before the oldest result
        is read, and every dispatched result starts its device→host copy
        at once. Keyframe adoption lags ≤pipeline_depth frames (all
        in-flight tracks remain geometrically valid against the previous
        keyframe; drift behavior unchanged).
        """
        if h2d_batch > 1:
            depths = self._batch_h2d(depths, h2d_batch)

        pending = collections.deque()  # (i, rec, t0) in flight
        last = None  # (kf, device T_rel of most recent dispatch)
        depth_cap = max(1, pipeline_depth)
        use_photo = self.icp_cfg.photometric_weight > 0
        for k, item in enumerate(depths):
            # Items may be bare depth maps or (depth, intensity) pairs.
            depth, intensity = (
                item if isinstance(item, tuple) else (item, None)
            )
            i = start_index + k
            t0 = time.perf_counter()
            frame, ref_w = self._make_frame(
                self._to_device(depth),
                self._to_device(intensity)
                if (use_photo and intensity is not None)
                else None,
            )
            if not self.keyframes:
                yield i, self._bootstrap(i, frame, ref_w, t0)
                continue
            kf = self.keyframes[-1]
            if last is not None and last[0] is kf:
                T_init = last[1]  # device tensor: zero-sync chaining
            else:
                T_init = self._ship(torch.from_numpy(self._last_rel))
            rec = self._dispatch(frame, ref_w, kf, T_init)
            pending.append((i, rec, t0))
            last = (kf, rec["T"])
            while len(pending) > depth_cap:
                pi, prec, pt0 = pending.popleft()
                yield pi, self._resolve(pi, prec, pt0, pipelined=True)
        while pending:
            pi, prec, pt0 = pending.popleft()
            yield pi, self._resolve(pi, prec, pt0, pipelined=True)

    def _on_device(self, item) -> bool:
        first = item[0] if isinstance(item, tuple) else item
        return isinstance(first, torch.Tensor) and first.device == self.device

    def _batch_h2d(self, items, batch: int):
        """Re-yield frames (or (depth, intensity) pairs) after stacked H2D.

        Groups ``batch`` host arrays, ships each group as one stacked
        transfer, then yields per-frame device slices (slicing a resident
        tensor costs no host round-trip).
        """

        def stacked(arrays):
            return self._ship(torch.stack([_as_tensor(a) for a in arrays]))

        def ship(group):
            if isinstance(group[0], tuple):
                yield from zip(stacked([g[0] for g in group]), stacked([g[1] for g in group]))
            else:
                yield from stacked(group)

        group = []
        for item in items:
            if self._on_device(item):
                # Already device-resident: pass it on, after the host
                # frames that came before it.
                yield from group
                group = []
                yield item
                continue
            group.append(item)
            if len(group) == batch:
                yield from ship(group)
                group = []
        if group:
            yield from ship(group)

    def trajectory(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))
