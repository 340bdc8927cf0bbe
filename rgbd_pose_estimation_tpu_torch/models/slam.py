"""Unified keyframe SLAM model: odometry → loop closure → pose graph.

Counterpart of the JAX package's ``models/slam.py`` (configurations 3 → 4
as one API): dense frame-to-keyframe tracking while frames stream in, then
an offline backend pass — ICP-verified loop closures and SE(3) pose-graph
optimization — producing the final trajectory. Every stage is the
already-tested component; this class is composition and bookkeeping.

The backend's bundle-adjustment branch (``optimize(bundle_adjust=True)``)
needs ``ba/``, which the port does not have yet: it raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.graph.pose_graph import optimize_trajectory
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry
from rgbd_pose_estimation_tpu_torch.utils.config import PipelineConfig
from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger


class Slam:
    """Streaming front-end + offline backend keyframe SLAM on ``device``."""

    def __init__(
        self,
        cam: CameraIntrinsics,
        cfg: PipelineConfig = PipelineConfig(),
        metrics: Optional[MetricsLogger] = None,
        keep_images: bool = True,
        device="cuda",
    ):
        self.cam = cam
        self.cfg = cfg
        self.odo = DenseOdometry(cam, cfg.icp, cfg.keyframe, metrics, device=device)
        self.keep_images = keep_images
        self._grays: List[np.ndarray] = []
        self._depths: List[np.ndarray] = []

    # --- streaming front-end -------------------------------------------
    def track(self, depth: np.ndarray, gray: Optional[np.ndarray] = None):
        """Ingest the next frame; returns its current world→camera pose."""
        if self.keep_images:
            self._grays.append(gray)
            self._depths.append(depth)
        return self.odo.process(depth)

    # --- offline backend ----------------------------------------------
    def optimize(self, bundle_adjust: bool = False):
        """Run the backend; returns the optimized full trajectory.

        ``bundle_adjust`` would additionally refine keyframe poses with
        feature-based Schur BA (it requires gray images to have been kept);
        until ``ba/`` is ported it raises ``NotImplementedError``.
        """
        traj = optimize_trajectory(self.odo, self.cfg.pose_graph)
        if not bundle_adjust:
            return traj
        if not self.keep_images or any(g is None for g in self._grays):
            raise ValueError("bundle_adjust=True requires gray images in track()")
        raise NotImplementedError(
            "bundle_adjust=True needs ba/, which is not ported yet "
            "(ROADMAP.md queue 1 item 5)"
        )

    @property
    def trajectory(self) -> np.ndarray:
        return self.odo.trajectory()
