"""One distributed backend step on an n-rank mesh, at tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``.
Call :func:`dryrun_multichip` on every rank of a launched group of
``n_devices`` ranks (or in one process for ``n_devices=1``, which starts a
group of one).
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ba.cluster import block_ba_problem
from rgbd_pose_estimation_tpu_torch.ba.schur import make_synthetic_ba_problem, with_odometry_priors
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence
from rgbd_pose_estimation_tpu_torch.models.distributed_slam import distributed_slam
from rgbd_pose_estimation_tpu_torch.parallel.mesh import fetch_global, make_mesh
from rgbd_pose_estimation_tpu_torch.parallel.sharded import (
    ba_solve_blocked,
    ba_step_sharded,
    icp_jtj_sharded,
    reshard_obs_to_blocks,
    ring_similarity,
    score_poses_3d3d_sharded,
)
from rgbd_pose_estimation_tpu_torch.parallel.specs import REPLICATED, ROWS
from rgbd_pose_estimation_tpu_torch.utils.config import BAConfig, IcpConfig, MeshConfig, PipelineConfig


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run ONE full distributed backend step on an ``n_devices`` mesh.

    DP-split RANSAC hypothesis scoring (K3), the TP-split dense-ICP normal
    equations (K4 and an ``all_reduce``), the ring all-pairs keyframe
    similarity, a Schur BA step with observations split over the ``(host,
    chip)`` mesh, the landmark-blocked solve with odometry priors, and the
    all-to-all observation relayout, each once on tiny shapes, then the
    configuration-5 pipeline end to end on a 6-frame 64x48 rendered
    sequence (``models/distributed_slam.py``: sequence-parallel odometry,
    ring candidates, split verification, pose graph, blocked BA); raises if
    an output is malformed. The data come from fixed seeds, the same on
    every rank. BA's features come from the FAST+BRIEF detector on the
    device (the reference takes the config's host ORB, which needs OpenCV).
    """
    hosts = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(MeshConfig(hosts=hosts, chips_per_host=n_devices // hosts), device=device)
    dev = mesh.device

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    f32 = dict(dtype=torch.float32, device=dev)

    # DP: RANSAC hypothesis scoring split over all ranks.
    K = 64 * n_devices
    T = se3_exp(torch.randn((K, 6), generator=gen(0), **f32) * 0.3)
    p = torch.randn((128, 3), generator=gen(1), **f32)
    q = torch.randn((128, 3), generator=gen(2), **f32)
    msac, _ = score_poses_3d3d_sharded(mesh, T, p, q, 0.05)
    _check(msac.shape == (K,) and msac.local.shape == (64,), f"msac {msac.shape}")

    # TP: dense-ICP normal equations, pixel rows split + all_reduce.
    m = 8 * 128 * n_devices
    pts = torch.randn((m, 3), generator=gen(3), **f32)
    nrm = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
    JtJ, _, _, _ = icp_jtj_sharded(mesh, pts, pts + 0.01, nrm, torch.ones(m, **f32))
    _check(JtJ.shape == (6, 6), f"JtJ {tuple(JtJ.shape)}")

    # CP-analogue: ring all-pairs keyframe similarity.
    desc = torch.randn((8 * n_devices, 16), generator=gen(4), **f32)
    sim = ring_similarity(mesh, desc)
    _check(sim.shape == (8 * n_devices, 8 * n_devices), f"similarity {sim.shape}")

    # Full BA step: observations split over the 2D mesh, states summed.
    obs_per_point = max(2, n_devices // 2)
    prob, _, _ = make_synthetic_ba_problem(
        gen(5), num_cameras=6, num_points=64, obs_per_point=obs_per_point, device=dev
    )
    O = prob.cam_idx.shape[0]
    pad = (-O) % n_devices
    if pad:
        def zeros(x):
            return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                                             device=dev)])

        prob = prob._replace(cam_idx=zeros(prob.cam_idx), lm_idx=zeros(prob.lm_idx),
                             obs=zeros(prob.obs), w=zeros(prob.w), obs_z=zeros(prob.obs_z))
    out, cost = ba_step_sharded(mesh, prob, BAConfig(cg_iters=5))
    poses = fetch_global(mesh, REPLICATED, out.poses)
    _check(bool((poses == poses).all()) and abs(float(cost)) < float("inf"), "BA step not finite")

    # North-star BA layout: landmark blocks rank-local (O(C) collectives
    # per CG matvec), with relative-pose odometry priors fused in.
    prob_p = with_odometry_priors(prob, 100.0)
    blocked, layout, _ = block_ba_problem(prob_p, n_devices)
    out_b, _ = ba_solve_blocked(mesh, blocked, BAConfig(outer_iters=2, cg_iters=5))
    poses_b = fetch_global(mesh, REPLICATED, out_b.poses)
    _check(bool(torch.isfinite(torch.from_numpy(poses_b)).all()), "blocked solve not finite")

    # The all-to-all relayout: frame-ordered → landmark-blocked.
    block_of_lm = torch.zeros(layout.num_landmarks, dtype=torch.int32)
    real = torch.from_numpy(layout.lm_perm >= 0)
    block_of_lm[torch.from_numpy(layout.lm_perm)[real]] = (
        torch.arange(n_devices * layout.block_size)[real] // layout.block_size
    ).to(torch.int32)
    dest = block_of_lm.to(dev)[prob.lm_idx.long()]
    fields = {"cam_idx": prob.cam_idx, "lm_idx": prob.lm_idx, "w": prob.w}
    resharded, dropped = reshard_obs_to_blocks(mesh, fields, dest, layout.obs_cap)
    _check(int(dropped) == 0, f"relayout dropped {int(dropped)}")
    valid = fetch_global(mesh, ROWS, resharded["valid"])
    _check(int(valid.sum()) == int((prob.w >= 0).sum()), f"relayout kept {int(valid.sum())} of {O}")

    # Configuration 5 end to end on a tiny rendered sequence, on this mesh.
    cam = CameraIntrinsics(64.0, 64.0, 31.5, 23.5, 64, 48)
    _, depths, intens = synthetic_sequence(cam, gen(7), 6, 0.008, device=dev)
    cfg = PipelineConfig(icp=IcpConfig(levels=2, iters_per_level=(3, 4)),
                         ba=BAConfig(outer_iters=2, cg_iters=5))
    traj = distributed_slam(cam, [d.cpu().numpy() for d in depths], [g.cpu().numpy() for g in intens],
                            mesh, cfg, n_chunks=2, kf_stride=2, detector="tpu")
    _check(traj.shape == (6, 4, 4) and bool(np.isfinite(traj).all()), f"trajectory {traj.shape}")
