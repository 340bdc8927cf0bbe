"""Multi-device scaling-efficiency harness (north star: ≥80% at 2+ hosts).

Counterpart of the JAX package's ``eval/scaling.py``. Two modes
(``--mode``):

- ``step``: throughput of the distributed STEPS (DP RANSAC scoring through
  K3, the replicated-landmark and the landmark-blocked BA step) at mesh
  sizes 1, 2, 4, ...;
- ``slam``: weak-scaling frames/s of the whole configuration-5 pipeline,
  ``distributed_slam`` end to end (sequence-parallel odometry, ring
  candidates, split loop verification, pose graph, blocked BA), with chunks
  a device held constant.

Both report efficiency against linear scaling from the smallest size.

A mesh is a group of ranks, one a device (``parallel/mesh.py``). Size 1
runs in this process (a group of one rank); each larger size runs in ranks
that the harness starts for it (``parallel/spawn.py``), on the CUDA cards by
default, as gloo ranks on the CPU with ``--cpu``. So the default sweep is 1
.. the visible cards, and ``--cpu`` sweeps up to ``--devices`` (8 by
default). Under a group already launched (one process a device,
``distributed_init``) the one size measured is the group's, on every rank.

    python -m rgbd_pose_estimation_tpu_torch.eval.scaling [--mode slam] [--cpu --devices 4]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from rgbd_pose_estimation_tpu_torch.parallel import spawn

_SIZES = (1, 2, 4, 8, 16, 32)
_MODULE = "rgbd_pose_estimation_tpu_torch.eval.scaling"  # what the ranks import, also under -m


def _device(use_cpu_mesh: bool) -> str:
    return "cpu" if use_cpu_mesh else "cuda"


def _max_devices(max_devices, use_cpu_mesh: bool) -> int:
    if max_devices is not None:
        return int(max_devices)
    return 8 if use_cpu_mesh else torch.cuda.device_count()


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _start_together(mesh) -> None:
    """Every rank's work queued so far done, then one barrier: the ranks
    start a timed loop together."""
    _sync(mesh)
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


def _sweep(target: str, sizes, device, args: tuple) -> dict:
    """``target(device, *args)`` at each mesh size: in this process at size
    1, in ranks started for it above (rank 0's result), or on the launched
    group's ranks at its one size. Returns ``{size: result}``."""
    fn = globals()[target]
    if spawn.group_running():
        return {dist.get_world_size(): fn(device, *args)}
    results = {}
    for n in sizes:
        if n == 1:
            own_group = not dist.is_initialized()
            try:
                results[n] = fn(device, *args)
            finally:
                if own_group and dist.is_initialized():
                    dist.destroy_process_group()
        else:
            spawn.check_devices(n, device)
            results[n] = spawn.run_ranks(f"{_MODULE}:{target}", (device,) + args, n, (1, n),
                                         device)[0]
    return results


def _step_rates(device, hyp_per_device: int, points_per_device: int, iters: int) -> dict:
    """One size of the step mode, on this rank's mesh (every rank calls it)."""
    from rgbd_pose_estimation_tpu_torch.ba.cluster import block_ba_problem
    from rgbd_pose_estimation_tpu_torch.ba.schur import make_synthetic_ba_problem
    from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
    from rgbd_pose_estimation_tpu_torch.parallel.mesh import (
        REPLICATED,
        put_global,
        put_global_tree,
        runtime_mesh,
    )
    from rgbd_pose_estimation_tpu_torch.parallel.sharded import (
        ba_reduction_slots,
        ba_step_blocked,
        ba_step_sharded,
        problem_specs,
        score_poses_3d3d_sharded,
    )
    from rgbd_pose_estimation_tpu_torch.parallel.specs import ROWS
    from rgbd_pose_estimation_tpu_torch.utils.config import BAConfig

    mesh = runtime_mesh(device=device)
    n, dev = mesh.size, mesh.device

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def timed(fn):
        fn()  # warm-up
        _start_together(mesh)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        _sync(mesh)
        return out, (time.perf_counter() - t0) / iters

    # Weak scaling: hypotheses and observations a device stay constant.
    K = hyp_per_device * n
    f32 = dict(dtype=torch.float32, device=dev)
    T = put_global(mesh, ROWS, se3_exp(torch.randn((K, 6), generator=gen(0), **f32) * 0.3))
    p = put_global(mesh, REPLICATED, torch.randn((1024, 3), generator=gen(1), **f32))
    q = put_global(mesh, REPLICATED, torch.randn((1024, 3), generator=gen(2), **f32))
    _, dt_score = timed(lambda: score_poses_3d3d_sharded(mesh, T, p, q, 0.05))

    prob, _, _ = make_synthetic_ba_problem(gen(3), num_cameras=16, num_points=points_per_device * n,
                                           obs_per_point=4, device=dev)
    O = prob.cam_idx.shape[0]
    pad = (-O) % n
    if pad:
        def zeros(x):
            return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)])

        prob = prob._replace(cam_idx=zeros(prob.cam_idx), lm_idx=zeros(prob.lm_idx),
                             obs=zeros(prob.obs), w=zeros(prob.w), obs_z=zeros(prob.obs_z))
    O = prob.cam_idx.shape[0]
    cfg = BAConfig(cg_iters=10)
    rep = put_global_tree(mesh, problem_specs(mesh, prob, blocked=False), prob)
    slots = ba_reduction_slots(mesh, rep)
    _, dt_ba = timed(lambda: ba_step_sharded(mesh, rep, cfg, slots))

    # The landmark-blocked layout, the north-star BA split.
    blocked, _, _ = block_ba_problem(prob, n)
    blocked = put_global_tree(mesh, problem_specs(mesh, blocked, blocked=True), blocked)
    slots_b = ba_reduction_slots(mesh, blocked, blocked=True)
    _, dt_bab = timed(lambda: ba_step_blocked(mesh, blocked, cfg, slots_b))
    return {"score_hyp_per_s": K / dt_score, "ba_obs_per_s": O / dt_ba,
            "ba_blocked_obs_per_s": O / dt_bab}


def run(max_devices=None, use_cpu_mesh: bool = False, hyp_per_device: int = 4096,
        points_per_device: int = 512, iters: int = 5) -> dict:
    """The step mode at mesh sizes 1, 2, 4, ... up to ``max_devices`` (by
    default the visible CUDA cards, or 8 gloo ranks with
    ``use_cpu_mesh``)."""
    sizes = [n for n in _SIZES if n <= _max_devices(max_devices, use_cpu_mesh)]
    results = _sweep("_step_rates", sizes, _device(use_cpu_mesh),
                     (hyp_per_device, points_per_device, iters))
    sizes = sorted(results)
    base, n0 = results[sizes[0]], sizes[0]
    report = {"mesh_sizes": sizes, "results": results, "efficiency": {}}
    for n in sizes:
        report["efficiency"][n] = {
            "score": results[n]["score_hyp_per_s"] / (base["score_hyp_per_s"] * n / n0),
            "ba": results[n]["ba_obs_per_s"] / (base["ba_obs_per_s"] * n / n0),
            "ba_blocked": results[n]["ba_blocked_obs_per_s"] / (base["ba_blocked_obs_per_s"] * n / n0),
        }
    return report


def _slam_rate(device, frames_per_chunk: int, width: int, height: int, motion: float,
               bundle_adjust: bool, detector) -> dict:
    """One size of the slam mode, on this rank's mesh (every rank calls it)."""
    from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
    from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence
    from rgbd_pose_estimation_tpu_torch.models.distributed_slam import distributed_slam
    from rgbd_pose_estimation_tpu_torch.parallel.mesh import runtime_mesh
    from rgbd_pose_estimation_tpu_torch.utils.config import PipelineConfig
    from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger

    mesh = runtime_mesh(device=device)
    n = mesh.size
    cam = CameraIntrinsics(0.9 * width, 0.9 * width, width / 2 - 0.5, height / 2 - 0.5,
                           width, height)
    cfg = PipelineConfig()
    F = frames_per_chunk * n
    _, depths, grays = synthetic_sequence(
        cam, torch.Generator(device=mesh.device).manual_seed(0), F, motion_scale=motion,
        device=mesh.device)
    depths = [d.cpu().numpy() for d in depths]
    grays = [g.cpu().numpy() for g in grays]

    def one_run():
        return distributed_slam(cam, depths, grays, mesh, cfg, n_chunks=n,
                                bundle_adjust=bundle_adjust, metrics=MetricsLogger(),
                                detector=detector)

    one_run()  # warm-up
    _start_together(mesh)
    t0 = time.perf_counter()
    traj = one_run()
    dt = time.perf_counter() - t0
    if not np.isfinite(traj).all():
        raise RuntimeError("distributed_slam returned a trajectory that is not finite")
    return {"frames": F, "seconds": dt, "frames_per_s": F / dt}


def run_slam(max_devices=None, use_cpu_mesh: bool = False, frames_per_chunk: int = 8,
             width: int = 160, height: int = 120, motion: float = 0.01,
             bundle_adjust: bool = True, detector=None) -> dict:
    """Weak-scaling frames/s of the whole configuration-5 pipeline.

    Renders a synthetic handheld sequence of ``frames_per_chunk × n``
    frames at mesh size n (chunks a device constant: weak scaling) and times
    ``distributed_slam`` end to end, every stage, the host's too, after one
    warm-up run. ``detector`` is BA's front-end (``None``: the config's,
    host ORB; ``"tpu"``: FAST+BRIEF on the device)."""
    sizes = [n for n in _SIZES if n <= _max_devices(max_devices, use_cpu_mesh)]
    results = _sweep("_slam_rate", sizes, _device(use_cpu_mesh),
                     (frames_per_chunk, width, height, motion, bundle_adjust, detector))
    sizes = sorted(results)
    base, n0 = results[sizes[0]], sizes[0]
    report = {"mode": "slam", "mesh_sizes": sizes, "results": results, "efficiency": {}}
    for n in sizes:
        # Weak scaling: linear scaling keeps frames/s a device constant.
        report["efficiency"][n] = results[n]["frames_per_s"] / (base["frames_per_s"] * n / n0)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m rgbd_pose_estimation_tpu_torch.eval.scaling")
    ap.add_argument("--devices", type=int, default=None,
                    help="largest mesh size (default: the visible CUDA cards; 8 with --cpu)")
    ap.add_argument("--real", action="store_true",
                    help="real devices: the CUDA cards (the default)")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--mode", choices=["step", "slam"], default="step")
    ap.add_argument("--frames-per-chunk", type=int, default=8)
    ap.add_argument("--detector", choices=["orb", "tpu"], default=None,
                    help="slam mode: BA's feature detector (default: the config's)")
    args = ap.parse_args(argv)
    if args.mode == "slam":
        out = run_slam(args.devices, use_cpu_mesh=args.cpu, frames_per_chunk=args.frames_per_chunk,
                       detector=args.detector)
    else:
        out = run(args.devices, use_cpu_mesh=args.cpu)
    print(json.dumps(out, indent=2, default=str))
    return out


if __name__ == "__main__":
    main()
