"""Flagship sparse model: RGB-D frame-pair pose estimation (configurations 1
and 2, ``configs/config1_*.yaml`` and ``configs/config2_*.yaml``).

Counterpart of the JAX package's ``models/frame_pair.py``:

  detect/describe: host OpenCV ORB (``detector="orb"``, the default) or
  FAST+BRIEF on the device (``detector="tpu"``, features/tpu_detect.py);
  descriptor matching on the device; the host's depth lookup and quality
  sort; then, on the device, PROSAC sampling → batched minimal solves → the
  MSAC scoring kernels → argmin → weighted refit (ransac/engine.py).

Two modes: "3d3d" (both frames' depth; Kabsch/Horn hypotheses) and "2d3d"
(depth only in frame A; P3P hypotheses, GN polish). The correspondence set
is padded to ``max_corr``, so every pair has the same shapes.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.features.frontend import matched_2d3d, matched_3d3d
from rgbd_pose_estimation_tpu_torch.ransac.engine import (
    _estimate_2d3d_from_samples,
    _estimate_from_samples,
    estimate_pose_2d3d,
    estimate_pose_2d3d_adaptive,
    estimate_pose_3d3d,
    estimate_pose_3d3d_adaptive,
    pad_correspondences_3d3d,
    pad_points_obs_2d3d,
)
from rgbd_pose_estimation_tpu_torch.utils.config import RansacConfig


class FramePairEstimate(typing.NamedTuple):
    pose: np.ndarray  # (4, 4) frame A → frame B camera transform
    num_inliers: int
    num_matches: int
    num_hypotheses: int
    valid: bool


@dataclasses.dataclass
class FramePairEstimator:
    """Reusable sparse frame-pair pose estimator on ``device``."""

    cam: CameraIntrinsics
    cfg: RansacConfig = RansacConfig()
    mode: str = "3d3d"  # or "2d3d"
    max_features: int = 512
    max_corr: int = 512
    detector: str = "orb"  # "orb" (host OpenCV) or "tpu" (FAST+BRIEF on the device)
    adaptive: bool = False  # two-round probe/escalate schedule (engine.py):
    # per-frame hypothesis work adapts to the inlier ratio; num_hypotheses
    # in the result reports what was actually scored (the metrics field).
    device: str = "cuda"

    def estimate(self, gray_a, depth_a, gray_b, depth_b=None, generator=None,
                 samples=None) -> FramePairEstimate:
        """Estimate the pose taking frame-A camera points to frame B.

        ``generator`` is a ``torch.Generator`` on ``device`` (by default a
        new one seeded 0, as the reference takes ``jax.random.key(0)``).
        ``samples``, the ``(K, m)`` minimal-set indices into the padded
        ``max_corr`` rows, replaces the sampler (another sampler's draws);
        it is refused by the adaptive schedule, which draws twice.
        """
        if samples is not None and self.adaptive:
            raise ValueError("the adaptive schedule draws its own samples")
        if generator is None and samples is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        if self.mode == "3d3d":
            if depth_b is None:
                raise ValueError("3d3d mode needs depth for both frames")
            p, q = matched_3d3d(
                self.cam, gray_a, depth_a, gray_b, depth_b, self.max_features,
                detector=self.detector, device=self.device,
            )
            n = min(len(p), self.max_corr)
            # Static shape: truncate to max_corr and pad with the engine's
            # rigid-inconsistent sentinels (never inliers, never a model).
            p_pad, q_pad = pad_correspondences_3d3d(*self._ship(p[:n], q[:n]), self.max_corr)
            if samples is not None:
                res = _estimate_from_samples(self._indices(samples), p_pad, q_pad, self.cfg)
            else:
                est = estimate_pose_3d3d_adaptive if self.adaptive else estimate_pose_3d3d
                res = est(generator, p_pad, q_pad, self.cfg)
        else:
            pts, obs = matched_2d3d(
                self.cam, gray_a, depth_a, gray_b, self.max_features,
                detector=self.detector, device=self.device,
            )
            n = min(len(pts), self.max_corr)
            pts_pad, obs_pad = pad_points_obs_2d3d(*self._ship(pts[:n], obs[:n]), self.max_corr)
            if samples is not None:
                res = _estimate_2d3d_from_samples(self._indices(samples), pts_pad, obs_pad, self.cfg)
            else:
                est = estimate_pose_2d3d_adaptive if self.adaptive else estimate_pose_2d3d
                res = est(generator, pts_pad, obs_pad, self.cfg)
        # One read-back: the pose, the inlier count and the validity flag.
        packed = torch.cat([res.pose.reshape(16), res.num_inliers.reshape(1),
                            res.valid.to(res.pose.dtype).reshape(1)]).cpu().numpy()
        return FramePairEstimate(
            pose=packed[:16].reshape(4, 4),
            num_inliers=int(packed[16]),
            num_matches=n,
            num_hypotheses=int(res.num_hypotheses),
            valid=bool(packed[17]) and n >= self.cfg.min_inliers,
        )

    def _ship(self, a, b):
        """Two host arrays of the same rows → the device in one copy."""
        ab = torch.from_numpy(np.concatenate([a, b], axis=1)).to(self.device)
        return ab[:, : a.shape[1]].contiguous(), ab[:, a.shape[1] :].contiguous()

    def _indices(self, samples) -> torch.Tensor:
        if not isinstance(samples, torch.Tensor):
            samples = torch.from_numpy(np.array(samples))
        return samples.to(self.device)
