"""Command-line entry points of the PyTorch port.

Counterpart of the JAX package's ``cli/main.py``, with its commands, flags,
names and defaults:

  python -m rgbd_pose_estimation_tpu_torch.cli.main pair  --dataset D --a 0 --b 3
  python -m rgbd_pose_estimation_tpu_torch.cli.main odom  --dataset D --out traj.txt
                                                          [--pose-graph]  (config 4)
  python -m rgbd_pose_estimation_tpu_torch.cli.main ba    --dataset D --out traj.txt
                                                          [--mesh-devices N] (config 5)
  python -m rgbd_pose_estimation_tpu_torch.cli.main slam  --dataset D --out traj.txt
                                                          [--mesh-devices N] (config 5,
                                                          one command)
  python -m rgbd_pose_estimation_tpu_torch.cli.main eval  --est traj.txt --gt gt.txt
  python -m rgbd_pose_estimation_tpu_torch.cli.main synth --out D           (fixture)

``--dataset`` is a TUM RGB-D directory (rgb.txt/depth.txt[/groundtruth.txt])
or a raw ICL-NUIM one. Every command runs on the CUDA device, and raises
``RuntimeError`` at once where there is none; ``--cpu`` runs it on the CPU,
and so does ``--cpu-devices N``, which also caps a mesh at N devices.

``ba`` and ``slam`` run on a mesh of devices, one rank a device
(``parallel/mesh.py``):

- ``--mesh-devices N`` (a ``(1, N)`` mesh) or a config whose ``mesh`` spans
  more than one device, in a process that runs in no group of ranks: the
  command starts N ranks of itself (``parallel/spawn.py``; gloo ranks with
  ``--cpu``, one CUDA card a rank otherwise, and ``ValueError`` before any
  rank starts where there are fewer cards). Rank 0's output is the
  command's, rank 0 writes the files, and a failing rank fails the command
  with its error;
- across processes, as in the reference: start one process a device with
  ``--coordinator host:port --num-processes N --process-id i``;
- otherwise on one device (``slam`` on a mesh of one rank, ``ba`` without
  one).

On a mesh, ``ba``'s build is rank-sharded and its solve runs in the
``--ba-layout`` (``blocked``: landmark blocks rank-local after one
all-to-all relayout; ``replicated``: observations split). ``slam`` is
``models/distributed_slam.py`` (sequence-parallel odometry, ring loop
candidates, split verification, the pose graph, blocked BA) over frames
decoded on demand, each rank decoding only the frames its stages touch.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import logging
import math
import os
import sys
import time

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ba.build import build_ba_problem
from rgbd_pose_estimation_tpu_torch.ba.cluster import block_ba_problem_device, unblock_points
from rgbd_pose_estimation_tpu_torch.ba.schur import (
    BAProblem,
    ba_step,
    reduction_slots,
    reprojection_rmse,
    with_odometry_priors,
)
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.data.icl_nuim import icl_nuim_intrinsics, open_sequence
from rgbd_pose_estimation_tpu_torch.data.prefetch import sequence_prefetcher
from rgbd_pose_estimation_tpu_torch.data.tum import write_synthetic_tum
from rgbd_pose_estimation_tpu_torch.eval.ate import ate_rmse, rpe
from rgbd_pose_estimation_tpu_torch.eval.traj_io import (
    associate_timestamps,
    read_tum_trajectory,
    write_tum_trajectory,
)
from rgbd_pose_estimation_tpu_torch.graph.pose_graph import _inverse_np, optimize_trajectory
from rgbd_pose_estimation_tpu_torch.models.distributed_slam import distributed_slam
from rgbd_pose_estimation_tpu_torch.models.frame_pair import FramePairEstimator
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry
from rgbd_pose_estimation_tpu_torch.parallel import spawn
from rgbd_pose_estimation_tpu_torch.parallel.mesh import (
    REPLICATED,
    check_config_consistency,
    distributed_init,
    fetch_global,
    gather_global,
    launch_shape,
    put_global_tree,
    runtime_mesh,
)
from rgbd_pose_estimation_tpu_torch.parallel.sharded import (
    ba_reduction_slots,
    ba_step_blocked,
    ba_step_sharded,
    layout_slots,
    problem_specs,
)
from rgbd_pose_estimation_tpu_torch.utils.checkpoint import (
    load_ba_checkpoint,
    load_odometry_checkpoint,
    save_ba_checkpoint,
    save_odometry_checkpoint,
)
from rgbd_pose_estimation_tpu_torch.utils.config import PipelineConfig, load_yaml_config
from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger
from rgbd_pose_estimation_tpu_torch.utils.timing import trace_context

_ODOM_CKPT_EVERY = 50  # frames between two odometry checkpoints


def _common(p: argparse.ArgumentParser):
    p.add_argument("--config", help="YAML config (configs/*.yaml)")
    p.add_argument("--metrics", help="JSONL metrics output path")
    p.add_argument("--trace-dir", help="torch.profiler trace output dir")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="CPU device count (implies --cpu; caps a mesh of "
                   "gloo ranks at this many devices)")
    p.add_argument("--log-level", default="INFO")


def build_parser():
    ap = argparse.ArgumentParser(prog="tpu-rgbd")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pair = sub.add_parser("pair", help="frame-pair sparse pose (configs 1-2)")
    pair.add_argument("--dataset", required=True)
    pair.add_argument("--a", type=int, default=0)
    pair.add_argument("--b", type=int, default=1)
    pair.add_argument("--mode", choices=["3d3d", "2d3d"], default="3d3d")
    pair.add_argument("--detector", choices=["orb", "tpu"], default="orb",
                      help="orb = host OpenCV; tpu = on-device FAST+BRIEF")
    pair.add_argument("--intrinsics", default="tum_default",
                      choices=["tum_default", "tum_fr1", "icl_nuim", "from_dataset"])
    pair.add_argument("--adaptive", action="store_true",
                      help="two-round adaptive RANSAC schedule")
    _common(pair)

    odom = sub.add_parser("odom", help="dense ICP odometry (config 3)")
    odom.add_argument("--dataset", required=True)
    odom.add_argument("--out", required=True, help="TUM trajectory output")
    odom.add_argument("--max-frames", type=int, default=0)
    odom.add_argument("--intrinsics", default="tum_default",
                      choices=["tum_default", "tum_fr1", "icl_nuim", "from_dataset"])
    odom.add_argument("--pose-graph", action="store_true",
                      help="optimize keyframe pose graph at the end (config 4)")
    odom.add_argument("--pipeline-depth", type=int, default=2,
                      help="tracks kept in flight before fetching results "
                      "(hides the device round-trip; keyframe adoption "
                      "lags <= this many frames)")
    odom.add_argument("--resume", action="store_true",
                      help="resume from checkpoint next to --out")
    _common(odom)

    ba = sub.add_parser("ba", help="bundle adjustment over keyframes (config 5)")
    ba.add_argument("--dataset", required=True)
    ba.add_argument("--out", required=True, help="TUM trajectory output")
    ba.add_argument("--max-frames", type=int, default=0)
    ba.add_argument("--intrinsics", default="tum_default",
                    choices=["tum_default", "tum_fr1", "icl_nuim", "from_dataset"])
    ba.add_argument("--mesh-devices", type=int, default=1,
                    help="shard BA over this many devices (1 = single; more: "
                    "the command starts one rank a device)")
    ba.add_argument("--ba-layout", choices=["blocked", "replicated"],
                    default="blocked",
                    help="distributed landmark layout (used on a mesh only)")
    ba.add_argument("--kf-interval", type=int, default=0,
                    help="override keyframe max_interval")
    ba.add_argument("--detector", choices=["orb", "tpu"], default=None,
                    help="BA feature detector (default: config frontend)")
    ba.add_argument("--checkpoint", help="BA checkpoint path (enables resume)")
    ba.add_argument("--resume", action="store_true")
    ba.add_argument("--fail-at-iter", type=int, default=-1,
                    help="TEST ONLY: raise after this BA iteration")
    # Multi-process launch (one process a device).
    ba.add_argument("--coordinator", help="host:port of process 0")
    ba.add_argument("--num-processes", type=int, default=1)
    ba.add_argument("--process-id", type=int, default=0)
    _common(ba)

    slam = sub.add_parser(
        "slam", help="end-to-end distributed SLAM (config 5 in one command)"
    )
    slam.add_argument("--dataset", required=True)
    slam.add_argument("--out", required=True, help="TUM trajectory output")
    slam.add_argument("--max-frames", type=int, default=0)
    slam.add_argument("--intrinsics", default="tum_default",
                      choices=["tum_default", "tum_fr1", "icl_nuim", "from_dataset"])
    slam.add_argument("--mesh-devices", type=int, default=1,
                      help="devices for ring candidates + blocked BA")
    slam.add_argument("--chunks", type=int, default=2,
                      help="sequence-parallel odometry chunks")
    slam.add_argument("--no-ba", action="store_true",
                      help="skip the bundle-adjustment stage")
    slam.add_argument("--detector", choices=["orb", "tpu"], default=None,
                      help="BA feature detector (default: config frontend)")
    slam.add_argument("--coordinator", help="host:port of process 0")
    slam.add_argument("--num-processes", type=int, default=1)
    slam.add_argument("--process-id", type=int, default=0)
    _common(slam)

    ev = sub.add_parser("eval", help="ATE/RPE vs ground truth")
    ev.add_argument("--est", required=True)
    ev.add_argument("--gt", required=True)
    _common(ev)

    synth = sub.add_parser("synth", help="write a synthetic TUM-format dataset")
    synth.add_argument("--out", required=True)
    synth.add_argument("--frames", type=int, default=30)
    synth.add_argument("--width", type=int, default=320)
    synth.add_argument("--height", type=int, default=240)
    synth.add_argument("--motion", type=float, default=0.01)
    _common(synth)
    return ap


def _setup(args):
    """Logging, the device and the config: ``(PipelineConfig, device)``.
    The CUDA device unless ``--cpu`` or ``--cpu-devices``; without one,
    raise."""
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), 20))
    if args.cpu or args.cpu_devices > 0:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is False); "
            "pass --cpu to run on the CPU"
        )
    cfg = load_yaml_config(args.config) if args.config else PipelineConfig()
    return cfg, device


def _intrinsics(name, cam_from_dataset=None):
    if name == "tum_fr1":
        return CameraIntrinsics.tum_fr1()
    if name == "icl_nuim":
        return icl_nuim_intrinsics()
    if name == "from_dataset" and cam_from_dataset is not None:
        return cam_from_dataset
    return CameraIntrinsics.tum_default()


def _dataset_cam(root):
    """Synthetic fixture datasets store their intrinsics in intrinsics.txt."""
    path = os.path.join(root, "intrinsics.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        vals = [float(x) for x in f.read().split()]
    return CameraIntrinsics(*vals[:4], int(vals[4]), int(vals[5]))


def _centers(T):
    return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])


def cmd_pair(args):
    cfg, device = _setup(args)
    metrics = MetricsLogger(args.metrics)
    seq = open_sequence(args.dataset)
    cam = _intrinsics(args.intrinsics, _dataset_cam(args.dataset))
    t0 = time.perf_counter()
    _, ga, da = seq.frame(args.a)
    _, gb, db = seq.frame(args.b)
    t_load = time.perf_counter()
    est = FramePairEstimator(cam, cfg.ransac, mode=args.mode, detector=args.detector,
                             adaptive=args.adaptive, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    out = est.estimate(ga, da, gb, db if args.mode == "3d3d" else None, generator=generator)
    t_est = time.perf_counter()
    # The per-frame record the report pipeline aggregates: hypotheses
    # actually scored (the hypotheses/s column), inliers, matches, ms.
    metrics.log(
        frame=args.b,
        ms=(t_est - t_load) * 1e3,
        ms_load=(t_load - t0) * 1e3,
        hypotheses=out.num_hypotheses,
        inliers=out.num_inliers,
        matches=out.num_matches,
        valid=out.valid,
    )
    metrics.close()
    print(json.dumps({
        "pose": out.pose.tolist(),
        "valid": out.valid,
        "num_matches": out.num_matches,
        "num_inliers": out.num_inliers,
        "num_hypotheses": out.num_hypotheses,
        "ms_estimate": (t_est - t_load) * 1e3,
    }))
    return 0 if out.valid else 1


def cmd_odom(args):
    cfg, device = _setup(args)
    seq = open_sequence(args.dataset)
    cam = _intrinsics(args.intrinsics, _dataset_cam(args.dataset))
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    metrics = MetricsLogger(args.metrics)
    odo = DenseOdometry(cam, cfg.icp, cfg.keyframe, metrics,
                        depth_scale=getattr(seq, "depth_scale", 1.0 / 5000.0), device=device)

    start = 0
    ckpt_path = args.out + ".ckpt.npz"
    if args.resume:
        start = load_odometry_checkpoint(ckpt_path, odo, seq)
        print(f"resumed at frame {start}", file=sys.stderr)

    with trace_context(args.trace_dir):
        loader = sequence_prefetcher(seq, start, n - start, device_depth=True, device=device)
        depths = (depth for _, _, depth in loader)
        # A checkpoint is a barrier of the pipeline: the frames after it are
        # dispatched once it is written, from the state it holds, so that a
        # run resumed from it tracks them as this run does. (Frames still in
        # flight at a checkpoint were dispatched against the keyframe of
        # their time, which the checkpoint does not hold.)
        seg = start
        while seg < n:
            end = min(n, (seg // _ODOM_CKPT_EVERY + 1) * _ODOM_CKPT_EVERY)
            for _ in odo.process_stream(itertools.islice(depths, end - seg), start_index=seg,
                                        pipeline_depth=args.pipeline_depth):
                pass
            if end % _ODOM_CKPT_EVERY == 0:
                save_odometry_checkpoint(ckpt_path, odo, end)
            seg = end
    poses = np.stack(odo.poses)
    write_tum_trajectory(args.out, seq.timestamps[:n], poses)

    if args.pose_graph:
        poses = optimize_trajectory(odo, cfg.pose_graph)
        write_tum_trajectory(args.out, seq.timestamps[:n], poses)

    # When the dataset ships ground truth, the run's metrics carry the ATE.
    try:
        gt_idx, gt_poses = seq.groundtruth_aligned()
    except Exception:
        gt_idx = np.zeros(0, np.int64)
    keep = gt_idx < len(poses) if len(gt_idx) else np.zeros(0, bool)
    if keep.sum() >= 3:
        ate = ate_rmse(_centers(poses[gt_idx[keep]]), _centers(gt_poses[keep]))
        metrics.log(ate_rmse=float(ate))

    print(json.dumps(metrics.summary()))
    metrics.close()
    return 0


def _as_ranks(args, cfg, device):
    """Run the command as the ranks of its mesh when it asks for more than
    one device (``--mesh-devices``, a config mesh) and runs in no group of
    ranks (``parallel/spawn.py``): rank 0's exit code. None otherwise."""
    if args.num_processes > 1 or spawn.group_running():
        return None
    shape = spawn.command_mesh_shape(args.mesh_devices, cfg.mesh)
    world = shape[0] * shape[1]
    if world == 1:
        return None
    spawn.check_devices(world, device, args.cpu_devices or None)
    return spawn.run_ranks("rgbd_pose_estimation_tpu_torch.cli.main:main", (args.argv,),
                           world, shape, device)[0]


def _metrics_path(args):
    """The ``--metrics`` path; None on the ranks other than 0 of a group the
    command started, which share its arguments."""
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    return None if launch_shape() is not None and rank > 0 else args.metrics


def cmd_ba(args):
    """Config 5's BA command: dense odometry gives the keyframes and their
    poses, then the keyframe feature problem is built and solved step by
    step (a checkpoint after each step with ``--checkpoint``), and the
    trajectory is re-anchored on the refined keyframe poses.

    Under a multi-process launch the build (detection and matching), the
    relayout and the solve are process-sharded, while the initialising
    dense odometry runs replicated on every process, so that the
    multi-process trajectory compares with the single-process one. The
    checkpoint holds global (unblocked) points, written by process 0 from a
    fetch every process makes, so that a run may resume in another layout.
    """
    cfg, device = _setup(args)
    rc = _as_ranks(args, cfg, device)
    if rc is not None:
        return rc
    distributed_init(args.coordinator, args.num_processes, args.process_id, device)
    metrics = MetricsLogger(_metrics_path(args))

    seq = open_sequence(args.dataset)
    cam = _intrinsics(args.intrinsics, _dataset_cam(args.dataset))
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)

    # Front-end: dense odometry provides keyframes + initial poses.
    kf_cfg = cfg.keyframe
    if args.kf_interval > 0:
        kf_cfg = dataclasses.replace(kf_cfg, max_interval=args.kf_interval)
    odo = DenseOdometry(cam, cfg.icp, kf_cfg, device=device)
    grays, depths = [], []
    for i in range(n):
        _, gray, depth = seq.frame(i)
        grays.append(gray)
        depths.append(depth)
        odo.process(depth, frame_index=i)
    kf_idx = [k.index for k in odo.keyframes]
    kf_poses = np.stack([k.pose for k in odo.keyframes])

    # The mesh of the launch, built before the problem so that the
    # detect/match front-end can be process-sharded.
    mesh = None
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        mesh = runtime_mesh(cfg.mesh, args.mesh_devices, device=device)
        if not check_config_consistency(mesh, cfg):
            raise RuntimeError(
                "the config hash differs across the processes: divergent configs "
                "would deadlock a collective"
            )

    prob, info = build_ba_problem(
        cam,
        [grays[i] for i in kf_idx],
        [depths[i] for i in kf_idx],
        kf_poses,
        # A multiple of the mesh size too (the reference's max(8, devices),
        # equal for every power of two).
        pad_to_multiple=math.lcm(8, mesh.size if mesh is not None else 1),
        max_features=cfg.frontend.max_features,
        detector=args.detector or cfg.frontend.detector,
        mesh=mesh,
        device=device,
    )
    metrics.log(stage="ba_build", **{
        k: info[k] for k in
        ("num_landmarks", "num_observations", "detector", "detect_calls",
         "match_pairs_local") if k in info
    })
    rmse0 = float(reprojection_rmse(prob))
    if cfg.ba.prior_weight > 0:
        # Priors measured at the odometry poses, BEFORE any resume, so that
        # interrupted and fresh runs share the same prior measurements.
        prob = with_odometry_priors(prob, cfg.ba.prior_weight)

    start_iter = 0
    if args.resume and args.checkpoint:
        state = load_ba_checkpoint(args.checkpoint)
        if state is not None:
            prob = prob._replace(
                poses=torch.from_numpy(state["poses"]).to(device),
                points=torch.from_numpy(state["points"]).to(device),
            )
            start_iter = int(state["iter"])
            print(f"resumed BA at iteration {start_iter}", file=sys.stderr)

    # The layout. "blocked" (default on a mesh): landmark blocks rank-local,
    # the observations moved frame-ordered → landmark-blocked by one
    # all-to-all, overflow counted; a CG matvec then sums only the (C, 6)
    # camera vector over the ranks. "replicated": observations split,
    # landmarks on every rank.
    blocked = mesh is not None and args.ba_layout == "blocked"
    layout = None
    if blocked:
        prob, layout, cstats, dropped = block_ba_problem_device(mesh, prob)
        slots = layout_slots(mesh, layout)
        dropped = int(fetch_global(mesh, REPLICATED, dropped))
        if dropped:
            raise RuntimeError(
                f"reshard_obs_to_blocks dropped {dropped} observations: the "
                "per-(source, destination) capacity was underestimated"
            )
        metrics.log(ba_layout="blocked", reshard_dropped=dropped, **{
            k: cstats[k] for k in
            ("span_cut_before", "span_cut_after", "obs_imbalance",
             "block_size", "obs_cap") if k in cstats
        })
    elif mesh is not None:
        prob = put_global_tree(mesh, problem_specs(mesh, prob, blocked=False), prob)
        slots = ba_reduction_slots(mesh, prob)
        metrics.log(ba_layout="replicated")
    else:
        slots = reduction_slots(prob)  # the reduction tables, built once
    specs = None if mesh is None else problem_specs(mesh, prob, blocked)

    def global_points(p):
        pts = fetch_global(mesh, specs.points if mesh is not None else REPLICATED, p.points)
        return unblock_points(pts, layout) if blocked else pts

    rank0 = mesh is None or mesh.rank == 0
    costs = []
    for it in range(start_iter, cfg.ba.outer_iters):
        t0 = time.perf_counter()
        if blocked:
            prob, cost = ba_step_blocked(mesh, prob, cfg.ba, slots)
        elif mesh is not None:
            prob, cost = ba_step_sharded(mesh, prob, cfg.ba, slots)
        else:
            prob, cost = ba_step(prob, cfg.ba, *slots)
        cost = float(cost)
        costs.append(cost)
        metrics.log(ba_iter=it, cost=cost, ms=(time.perf_counter() - t0) * 1e3)
        if args.checkpoint:
            # Fetched on EVERY process (a gather of split points is a
            # collective); only process 0 writes.
            ck_poses = fetch_global(mesh, REPLICATED, prob.poses)
            ck_points = global_points(prob)
            if rank0:
                save_ba_checkpoint(args.checkpoint, poses=ck_poses, points=ck_points,
                                   iter=np.int64(it + 1))
        if args.fail_at_iter == it:
            raise RuntimeError(f"fault injection: failing after BA iteration {it}")
    if mesh is not None:
        # The whole problem back on every process for the report.
        points = torch.from_numpy(global_points(prob)).to(device)
        prob = BAProblem(*(None if x is None else gather_global(x) for x in prob))
        prob = prob._replace(points=points)
    if blocked:
        # The observations stay bucketed (a permutation of the originals
        # plus w=0 pads; the RMSE does not depend on their order), but their
        # landmark indices are rank-local: back to global ones.
        real = layout.obs_perm >= 0
        shard = np.arange(layout.n_shards).repeat(layout.obs_cap)
        gl = layout.lm_perm[shard * layout.block_size + prob.lm_idx.cpu().numpy()]
        gl[~real] = 0
        prob = prob._replace(lm_idx=torch.from_numpy(gl.astype(np.int32)).to(device))
    rmse1 = float(reprojection_rmse(prob))
    metrics.log(reproj_rmse_after=rmse1)
    metrics.close()

    # Re-anchor the full trajectory on the optimized keyframe poses.
    T_opt = prob.poses.cpu().numpy()
    kf_inv = _inverse_np(kf_poses)
    out_poses = []
    cur = 0
    for f, pose in enumerate(odo.poses):
        while cur + 1 < len(kf_idx) and kf_idx[cur + 1] <= f:
            cur += 1
        out_poses.append(pose @ kf_inv[cur] @ T_opt[cur])
    if rank0:
        write_tum_trajectory(args.out, seq.timestamps[:n], np.stack(out_poses))
    print(json.dumps({
        **info,
        "reproj_rmse_before": rmse0,
        "reproj_rmse_after": rmse1,
        "costs": costs,
        "mesh_devices": args.mesh_devices,
    }))
    return 0


class _LazyFrames:
    """Decode-on-demand, bounded-memory view of a dataset sequence.

    On a mesh each rank tracks only its own chunks
    (``models/sequence_parallel.py``), so decoding every frame on every rank
    would waste the I/O the chunk split saves. This view decodes a frame the
    first time its gray or its depth is indexed and keeps it in a bounded
    LRU cache: each stage reads the frames in one pass (the chunks' tracking,
    then the keyframes' pyramids and BA builds), and an unbounded cache would
    hold ~1 GB of 640x480 frames by the end of a 573-frame run. ``decoded``
    counts the DISTINCT frames this rank ever decoded (the sharded-I/O
    observable; a decode again after eviction does not count);
    ``peak_cached`` is the cache's high-water mark.
    """

    def __init__(self, seq, n: int, max_cached: int = 64):
        self._seq = seq
        self._n = n
        self._max = max(int(max_cached), 1)
        self._cache: dict = {}  # insertion-ordered: LRU by re-insertion
        self._decoded: set = set()
        self.peak_cached = 0
        self.grays = _LazyView(self, 0)
        self.depths = _LazyView(self, 1)

    def __len__(self):
        return self._n

    @property
    def decoded(self) -> int:
        return len(self._decoded)

    def _get(self, i: int):
        if not isinstance(i, (int, np.integer)):
            raise TypeError(f"_LazyFrames supports integer indexing only, got {type(i)}")
        if i < 0:  # a list's semantics
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        i = int(i)
        if i in self._cache:
            val = self._cache.pop(i)  # refresh its LRU position
            self._cache[i] = val
            return val
        _, gray, depth = self._seq.frame(i)
        self._decoded.add(i)
        while len(self._cache) >= self._max:
            self._cache.pop(next(iter(self._cache)))
        self._cache[i] = (gray, depth)
        self.peak_cached = max(self.peak_cached, len(self._cache))
        return self._cache[i]


class _LazyView:
    def __init__(self, store: _LazyFrames, slot: int):
        self._store = store
        self._slot = slot

    def __len__(self):
        return len(self._store)

    def __getitem__(self, i: int):
        return self._store._get(i)[self._slot]

    def __iter__(self):
        # Explicit, so that iterating decodes frame by frame by choice, not
        # through the legacy __getitem__ protocol.
        for i in range(len(self)):
            yield self[i]


def cmd_slam(args):
    """Config 5 as ONE command: sequence-parallel odometry, ring loop
    candidates, split verification, the pose graph, blocked sharded BA
    (``models/distributed_slam.py``) on the launch's mesh; a mesh of one
    rank in a single process."""
    cfg, device = _setup(args)
    rc = _as_ranks(args, cfg, device)
    if rc is not None:
        return rc
    distributed_init(args.coordinator, args.num_processes, args.process_id, device)
    own_group = not torch.distributed.is_initialized()  # runtime_mesh starts one of one rank
    try:
        return _slam(args, cfg, device)
    finally:
        if own_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _slam(args, cfg, device):
    metrics = MetricsLogger(_metrics_path(args))
    seq = open_sequence(args.dataset)
    cam = _intrinsics(args.intrinsics, _dataset_cam(args.dataset))
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    frames = _LazyFrames(seq, n)

    # The mesh of the launch: the group's ranks, or one rank in one process.
    mesh = runtime_mesh(cfg.mesh, args.mesh_devices, device=device)
    if not check_config_consistency(mesh, cfg):
        raise RuntimeError(
            "the config hash differs across the processes: divergent configs "
            "would deadlock a collective"
        )
    traj = distributed_slam(
        cam, frames.depths, frames.grays, mesh, cfg,
        n_chunks=args.chunks, bundle_adjust=not args.no_ba, metrics=metrics,
        detector=args.detector,
    )
    # Decoding is split with the chunks: this rank decoded only its own
    # chunks' frames and the keyframes its stages touch.
    metrics.log(stage="io", frames_decoded=frames.decoded, frames_total=n,
                peak_cached=frames.peak_cached)
    if mesh.rank == 0:
        write_tum_trajectory(args.out, seq.timestamps[:n], traj)

    out = {"frames": n, "mesh_devices": args.mesh_devices, "chunks": args.chunks}
    try:
        gt_idx, gt_poses = seq.groundtruth_aligned()
        keep = gt_idx < n
        if keep.sum() >= 3:
            out["ate_rmse"] = float(ate_rmse(_centers(traj[gt_idx[keep]]), _centers(gt_poses[keep])))
            metrics.log(ate_rmse=out["ate_rmse"])
    except Exception:
        pass  # no ground truth
    metrics.close()
    print(json.dumps(out))
    return 0


def cmd_eval(args):
    _setup(args)
    ts_e, est = read_tum_trajectory(args.est)
    ts_g, gt = read_tum_trajectory(args.gt)
    ia, ib = associate_timestamps(ts_e, ts_g)
    est, gt = est[ia], gt[ib]
    out = {"ate_rmse": ate_rmse(_centers(est), _centers(gt)),
           "num_poses": int(len(ia)), **rpe(est, gt)}
    print(json.dumps(out))
    return 0


def cmd_synth(args):
    """Render the analytic scene into a TUM directory, with its camera in
    ``intrinsics.txt`` (``--intrinsics from_dataset`` reads it)."""
    _, device = _setup(args)
    write_synthetic_tum(
        args.out, n_frames=args.frames, size=(args.width, args.height),
        motion_scale=args.motion, device=device,
    )
    print(json.dumps({"out": args.out, "frames": args.frames}))
    return 0


def main(argv=None):
    argv = [str(a) for a in (sys.argv[1:] if argv is None else argv)]
    args = build_parser().parse_args(argv)
    args.argv = argv  # what the ranks a command starts run again
    return {"pair": cmd_pair, "odom": cmd_odom, "eval": cmd_eval,
            "synth": cmd_synth, "ba": cmd_ba, "slam": cmd_slam}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
