"""Unified keyframe SLAM model: odometry → loop closure → pose graph → BA.

Counterpart of the JAX package's ``models/slam.py`` (configurations 3 → 5
as one API): dense frame-to-keyframe tracking while frames stream in, then
an offline backend pass — ICP-verified loop closures, SE(3) pose-graph
optimization, and optionally feature-based bundle adjustment — producing
the final trajectory. Every stage is the already-tested component; this
class is composition and bookkeeping.

The BA branch builds the problem once, reads its index arrays once for the
reduction tables (``ba/schur.py::reduction_slots``), runs
``cfg.ba.outer_iters`` steps without reading anything back, and reads the
refined keyframe poses once. With ``mesh=`` (``parallel/mesh.py``) the
steps are ``parallel/sharded.py::ba_step_sharded``: each rank holds its
block of the observations, the poses and landmarks replicated.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ba.build import build_ba_problem
from rgbd_pose_estimation_tpu_torch.ba.schur import (
    ba_step,
    prune_observations,
    reduction_slots,
    with_odometry_priors,
)
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.graph.pose_graph import _inverse_np, optimize_trajectory
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry
from rgbd_pose_estimation_tpu_torch.parallel.mesh import REPLICATED, fetch_global, put_global_tree
from rgbd_pose_estimation_tpu_torch.parallel.sharded import (
    ba_reduction_slots,
    ba_step_sharded,
    local_tree,
    problem_specs,
    shard_tree,
)
from rgbd_pose_estimation_tpu_torch.utils.config import BAConfig, PipelineConfig
from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger


def refine_keyframes(prob, cfg: BAConfig, mesh=None):
    """The BA schedule of :meth:`Slam.optimize` on a built keyframe problem.

    The initialisation is already good (odometry + pose graph): contaminated
    tracks are pruned against it before BA moves anything, and the
    odometry's relative motion is fused as priors, so that a weak feature
    problem refines poses instead of replacing them. Then half the steps,
    another prune, the other half. Returns ``(problem as first solved,
    problem solved, (steps,) costs)``, all on the device; nothing is read
    back and the reduction tables are built once. With ``mesh`` the
    observations are split over its ranks (the two problems are then
    ``BAProblem`` s of ``Shard`` s) and the steps are ``ba_step_sharded``.
    """
    prob = prune_observations(prob, cfg.huber_delta * 3.0, cfg.depth_weight)
    if cfg.prior_weight > 0:
        prob = with_odometry_priors(prob, cfg.prior_weight)
    if mesh is None:
        cam_slots, lm_slots = reduction_slots(prob)

        def step(p):
            return ba_step(p, cfg, cam_slots=cam_slots, lm_slots=lm_slots)

        def prune(p):
            return prune_observations(p, cfg.huber_delta * 3.0, cfg.depth_weight)
    else:
        specs = problem_specs(mesh, prob, blocked=False)
        prob = put_global_tree(mesh, specs, prob)
        slots = ba_reduction_slots(mesh, prob)

        def step(p):
            return ba_step_sharded(mesh, p, cfg, slots)

        def prune(p):  # per observation: on each rank's own block
            pruned = prune_observations(local_tree(mesh, specs, p), cfg.huber_delta * 3.0,
                                        cfg.depth_weight)
            return shard_tree(mesh, specs, pruned)
    start, costs = prob, []

    def steps(p, n):
        for _ in range(n):
            p, cost = step(p)
            costs.append(cost)
        return p

    half = max(1, cfg.outer_iters // 2)
    prob = steps(prob, half)
    prob = prune(prob)
    prob = steps(prob, cfg.outer_iters - half)
    return start, prob, torch.stack(costs)


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
        # The last BA run's state, for evaluation (device tensors, not read
        # back): the pose-graph trajectory it started from, the problem as
        # solved (pruned, with priors) before and after, the cost before
        # each step, the build's info.
        self.ba_report: Optional[dict] = None

    # --- streaming front-end -------------------------------------------
    def track(self, depth: np.ndarray, gray: Optional[np.ndarray] = None):
        """Ingest the next frame; returns its current world→camera pose."""
        if self.keep_images:
            self._grays.append(gray)
            self._depths.append(depth)
        return self.odo.process(depth)

    # --- offline backend ----------------------------------------------
    def optimize(self, bundle_adjust: bool = False, mesh=None):
        """Run the backend; returns the optimized full trajectory.

        ``bundle_adjust`` additionally refines keyframe poses with feature-
        based Schur BA (requires gray images to have been kept); ``mesh``
        (``parallel/mesh.py``) splits the BA step's observations over its
        ranks (``ba_step_sharded``). Every rank builds the same problem.
        """
        traj = optimize_trajectory(self.odo, self.cfg.pose_graph)
        if not bundle_adjust:
            return traj
        if not self.keep_images or any(g is None for g in self._grays):
            raise ValueError("bundle_adjust=True requires gray images in track()")

        kf_idx = [k.index for k in self.odo.keyframes]
        kf_poses_pg = np.stack([traj[i] for i in kf_idx])
        # BA features run at full input resolution (self.cam is the
        # constructor camera; only the odometry tracks downscaled).
        prob, info = build_ba_problem(
            self.cam,
            [self._grays[i] for i in kf_idx],
            [self._depths[i] for i in kf_idx],
            kf_poses_pg,
            # Observations pad to a multiple of the mesh size too (the
            # reference's max(8, size), equal for every power of two).
            pad_to_multiple=math.lcm(8, mesh.size if mesh is not None else 1),
            max_features=self.cfg.frontend.max_features,
            detector=self.cfg.frontend.detector,
            device=self.odo.device,
        )
        start, prob, costs = refine_keyframes(prob, self.cfg.ba, mesh)
        self.ba_report = {
            "pose_graph_trajectory": traj, "problem": start, "solved": prob,
            "costs": costs, "info": info,
        }

        # Re-anchor all frames on the BA-refined keyframe poses: each
        # frame keeps its transform relative to its parent keyframe.
        T_opt = fetch_global(mesh, REPLICATED, prob.poses)
        kf_inv = _inverse_np(kf_poses_pg)
        out = np.empty_like(traj)
        cur = 0
        for f in range(len(traj)):
            while cur + 1 < len(kf_idx) and kf_idx[cur + 1] <= f:
                cur += 1
            out[f] = traj[f] @ kf_inv[cur] @ T_opt[cur]
        return out

    @property
    def trajectory(self) -> np.ndarray:
        return self.odo.trajectory()
