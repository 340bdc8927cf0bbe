"""Rank processes of the port's multi-rank tests (torch and the port only:
no rank imports JAX).

    python tests/_torch_ranks.py <suite> <workdir> <rank> <world>

Each rank joins one gloo group over a ``FileStore`` in ``workdir`` (so that
test workers never share a port), runs every case of ``suite`` inside it,
and writes its results to ``workdir/rank<r>.pt``. The parent test writes
the inputs to ``workdir/inputs.pt`` first and calls :func:`launch`, which
starts the ranks and returns their results; it may do other work between
:func:`start` and :func:`finish`.
"""

import os
import pathlib
import subprocess
import sys
import time
import traceback

_REPO = pathlib.Path(__file__).resolve().parents[1]


def start(suite: str, workdir, world: int):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return [
        subprocess.Popen(
            [sys.executable, __file__, suite, str(workdir), str(r), str(world)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for r in range(world)
    ]


def finish(procs, workdir, timeout: float = 120.0):
    """Wait for every rank; raise with its output where one failed."""
    import torch

    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"rank {r} exited {rc}:\n{out[-3000:]}\n{err[-6000:]}")
    return [torch.load(pathlib.Path(workdir) / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def launch(suite: str, workdir, world: int, timeout: float = 120.0):
    return finish(start(suite, workdir, world), workdir, timeout)


# ---------------------------------------------------------------------------
# Suites (run in the rank processes)
# ---------------------------------------------------------------------------


def _parallel(workdir: pathlib.Path, rank: int, world: int) -> dict:
    """Every sharded function of ``parallel/`` on a (1, world) gloo mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rgbd_pose_estimation_tpu_torch.ba import cluster
    from rgbd_pose_estimation_tpu_torch.ba.schur import BAProblem
    from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame
    from rgbd_pose_estimation_tpu_torch.parallel import mesh as M
    from rgbd_pose_estimation_tpu_torch.parallel import sharded as S
    from rgbd_pose_estimation_tpu_torch.parallel.dryrun import dryrun_multichip
    from rgbd_pose_estimation_tpu_torch.parallel.specs import REPLICATED, ROWS
    from rgbd_pose_estimation_tpu_torch.utils.config import BAConfig, IcpConfig, MeshConfig

    dist.init_process_group("gloo", store=dist.FileStore(str(workdir / "store"), world),
                            rank=rank, world_size=world)
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = M.runtime_mesh(device="cpu")
    res = {"shape": mesh.shape, "rank": mesh.rank}

    def fetch(x):
        return M.fetch_global(mesh, x.spec, x)

    # K3's DP split; a rerun is bit-equal.
    msac, count = S.score_poses_3d3d_sharded(mesh, inp["T"], inp["p"], inp["q"], 0.05)
    again = S.score_poses_3d3d_sharded(mesh, inp["T"], inp["p"], inp["q"], 0.05)[0]
    res["score"] = (fetch(msac), fetch(count), torch.equal(msac.local, again.local),
                    tuple(msac.local.shape))

    # K4's TP split.
    res["icp"] = [t.numpy() for t in S.icp_jtj_sharded(mesh, *inp["icp"])]

    # The replicated-landmark BA step, with and without the ranks' tables.
    prob = BAProblem(**{k: None if v is None else torch.from_numpy(v)
                        for k, v in inp["ba"].items()})
    cfg = BAConfig(cg_iters=15)
    slots = S.ba_reduction_slots(mesh, prob)
    step = {}
    for name, sl in (("slots", slots), ("incidence", None)):
        out, cost = S.ba_step_sharded(mesh, prob, cfg, sl)
        step[name] = (fetch(out.poses), fetch(out.points), float(cost))
    out2, cost2 = S.ba_step_sharded(mesh, prob, cfg, slots)
    step["rerun_equal"] = bool(np.array_equal(fetch(out2.poses), step["slots"][0])
                               and float(cost2) == step["slots"][2])
    res["ba_step"] = step

    # The landmark-blocked solve: the host layout and the device relayout.
    solve_cfg = BAConfig(outer_iters=3, cg_iters=15)
    host_blocked, host_layout, _ = cluster.block_ba_problem(prob, world)
    out_h, costs_h = S.ba_solve_blocked(
        mesh, host_blocked, solve_cfg, S.ba_reduction_slots(mesh, host_blocked, blocked=True))
    res["blocked_host"] = (fetch(out_h.poses), cluster.unblock_points(fetch(out_h.points),
                                                                     host_layout), costs_h.numpy())
    mesh.reset_comm()
    dev_blocked, layout, stats, dropped = cluster.block_ba_problem_device(mesh, prob)
    to_all = {k: list(v) for k, v in mesh.comm.items()}
    fields = {k: fetch(getattr(dev_blocked, k)) for k in ("cam_idx", "lm_idx", "obs", "w", "obs_z")}
    dev_slots = S.layout_slots(mesh, layout)
    out_d, costs_d = S.ba_solve_blocked(mesh, dev_blocked, solve_cfg, dev_slots)
    out_d2, costs_d2 = S.ba_solve_blocked(mesh, dev_blocked, solve_cfg, dev_slots)
    res["blocked_device"] = {
        "layout": layout, "stats": stats, "dropped": int(dropped), "fields": fields,
        "comm": to_all, "points_local": tuple(dev_blocked.points.local.shape),
        "poses": fetch(out_d.poses),
        "points": cluster.unblock_points(fetch(out_d.points), layout),
        "costs": costs_d.numpy(),
        "rerun_equal": bool(torch.equal(out_d.poses.local, out_d2.poses.local)
                            and torch.equal(costs_d, costs_d2)),
    }
    over = cluster.block_ba_problem_device(mesh, prob, obs_cap_override=16)
    res["overflow"] = (int(over[3]), over[2]["reshard_dropped_host"],
                       fetch(over[0].w), over[1].obs_perm)

    # Bytes one CG iteration reduces: a step of c + 1 iterations against c.
    def reduced(step_fn, iters):
        mesh.reset_comm()
        step_fn(BAConfig(cg_iters=iters))
        return mesh.comm["all_reduce"][1]

    res["cg_bytes"] = {
        "blocked": reduced(lambda c: S.ba_step_blocked(mesh, dev_blocked, c, dev_slots), 5)
        - reduced(lambda c: S.ba_step_blocked(mesh, dev_blocked, c, dev_slots), 4),
        "replicated": reduced(lambda c: S.ba_step_sharded(mesh, prob, c, slots), 5)
        - reduced(lambda c: S.ba_step_sharded(mesh, prob, c, slots), 4),
        "C": int(prob.poses.shape[0]), "L": int(prob.points.shape[0]),
        "Lb": int(layout.block_size),
    }

    # The ring and the DP loop-closure verification.
    res["ring"] = fetch(S.ring_similarity(mesh, inp["desc"]))
    cam = inp["cam"]
    icp_cfg = IcpConfig(**inp["icp_cfg"])
    src = IcpFrame(*(tuple(torch.from_numpy(a) for a in leaves) for leaves in inp["src"]))
    tgt = IcpFrame(*(tuple(torch.from_numpy(a) for a in leaves) for leaves in inp["tgt"]))
    T_v, stats_v, valid0 = S.icp_verify_sharded(mesh, cam, icp_cfg, inp["T_init"], src, tgt)
    res["verify"] = (fetch(T_v), fetch(stats_v), fetch(valid0), tuple(T_v.local.shape))

    # Start-up checks, global tensors, host exchange.
    res["consistent"] = M.check_config_consistency(mesh, cfg)
    res["divergent"] = M.check_config_consistency(mesh, BAConfig(cg_iters=15 + (rank == 1)))
    g = M.put_global(mesh, ROWS, np.arange(world * 6, dtype=np.float32).reshape(world * 3, 2))
    rows = M.put_process_rows(mesh, ROWS, {"a": np.full((2, 3), rank, np.int32)})
    res["global"] = (tuple(g.local.shape), M.fetch_global(mesh, ROWS, g),
                     M.fetch_global(mesh, ROWS, rows["a"]), rows["a"].shape,
                     M.allgather_hosts(mesh, np.array([rank, 10 * rank], np.int64)),
                     M.allgather_hosts(mesh, np.array([rank == 1, True])),
                     M.fetch_global(mesh, REPLICATED, M.put_global(mesh, REPLICATED, np.eye(2))))
    try:
        M.runtime_mesh(MeshConfig(hosts=2, chips_per_host=2), device="cpu")
        res["bad_config"] = None
    except ValueError as e:
        res["bad_config"] = str(e)
    dryrun_multichip(world, device="cpu")
    res["dryrun"] = True
    return res


def _cli(workdir: pathlib.Path, rank: int, world: int) -> dict:
    """``main(argv)`` of ``ba`` in this rank's process: the blocked and the
    replicated layouts, a run cut by ``--fail-at-iter`` and its resume; then
    ``slam`` across the processes."""
    import contextlib
    import io
    import json

    from rgbd_pose_estimation_tpu_torch.cli.main import main

    argv = json.loads((workdir / "argv.json").read_text())
    launch = ["--coordinator", f"file://{workdir / 'store'}",
              "--num-processes", str(world), "--process-id", str(rank)]
    base = argv["ba"] + launch
    res = {"seconds": {}}  # wall seconds of each command

    def run(*extra):
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = main(base + list(extra))
        finally:
            res["seconds"][pathlib.Path(extra[1]).stem] = time.perf_counter() - t0
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1])

    res["blocked"] = run("--out", str(workdir / "blocked.txt"),
                         "--metrics", str(workdir / f"blocked{rank}.jsonl"))
    res["replicated"] = run("--out", str(workdir / "replicated.txt"), "--ba-layout", "replicated")
    ck = str(workdir / "ba.ckpt.npz")
    try:
        run("--out", str(workdir / "cut.txt"), "--checkpoint", ck, "--fail-at-iter", "3")
        res["fault"] = None
    except RuntimeError as e:
        res["fault"] = str(e)
    res["resumed"] = run("--out", str(workdir / "resumed.txt"), "--checkpoint", ck, "--resume")
    base = argv["slam"] + launch
    res["slam"] = run("--out", str(workdir / "slam_ranks.txt"),
                      "--metrics", str(workdir / f"slam_ranks{rank}.jsonl"))
    return res


def _dslam(workdir: pathlib.Path, rank: int, world: int) -> dict:
    """``models/distributed_slam.py`` and the ``mesh=`` path of
    ``models/sequence_parallel.py`` on a (1, world) gloo mesh: the pipeline
    without BA (its candidates and verified pairs recorded), with BA, the
    verification under a finest source stride of 4, and the sequence-parallel
    odometry with the default and a poses-only chunk runner."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from rgbd_pose_estimation_tpu_torch.models import distributed_slam as ds
    from rgbd_pose_estimation_tpu_torch.models.sequence_parallel import sequence_parallel_odometry
    from rgbd_pose_estimation_tpu_torch.parallel import mesh as M
    from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig, PipelineConfig
    from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger

    dist.init_process_group("gloo", store=dist.FileStore(str(workdir / "store"), world),
                            rank=rank, world_size=world)
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = M.runtime_mesh(device="cpu")
    cam, depths, grays = inp["cam"], inp["depths"], inp["grays"]
    cfg = PipelineConfig(icp=IcpConfig(**inp["icp_cfg"]), ba=inp["ba_cfg"],
                         frontend=inp["frontend"])
    res = {}

    # The pipeline without BA, its ring candidates and verified pairs kept.
    seen = {}
    ring, verify = ds.ring_loop_candidates, ds.verify_loop_pairs

    def ring_kept(*a, **kw):
        seen["pairs"] = ring(*a, **kw)
        return seen["pairs"]

    def verify_kept(mesh_, cam_, icp_cfg, pairs, kf_poses, frame_of, **kw):
        seen["verify_in"] = (pairs, kf_poses, frame_of)
        seen["verified"] = verify(mesh_, cam_, icp_cfg, pairs, kf_poses, frame_of, **kw)
        return seen["verified"]

    ds.ring_loop_candidates, ds.verify_loop_pairs = ring_kept, verify_kept
    try:
        metrics = MetricsLogger()
        res["traj"] = ds.distributed_slam(cam, depths, grays, mesh, cfg, n_chunks=2,
                                          kf_stride=1, bundle_adjust=False, metrics=metrics)
    finally:
        ds.ring_loop_candidates, ds.verify_loop_pairs = ring, verify
    res["records"] = metrics.records
    res["pairs"], res["verified"] = seen["pairs"], seen["verified"]
    pairs, kf_poses, frame_of = seen["verify_in"]

    # The reference's overlap ratio under a finest source stride of 4.
    strided = dataclasses.replace(cfg.icp, **inp["stride"])
    res["verified_stride4"] = ds.verify_loop_pairs(mesh, cam, strided, pairs, kf_poses, frame_of)
    metrics = MetricsLogger()
    ds.distributed_slam(cam, depths, grays, mesh, dataclasses.replace(cfg, icp=strided), n_chunks=2,
                        kf_stride=1, bundle_adjust=False, metrics=metrics)
    res["records_stride4"] = metrics.records

    # The whole pipeline with blocked BA.
    metrics = MetricsLogger()
    res["traj_ba"] = ds.distributed_slam(cam, depths, grays, mesh, cfg, n_chunks=2, kf_stride=2,
                                         detector="tpu", metrics=metrics)
    res["records_ba"] = metrics.records

    # Sequence-parallel odometry: the default runner, and a poses-only one.
    stats = {}
    sp_kw = dict(n_chunks=3, overlap=2, icp_cfg=cfg.icp, kf_cfg=cfg.keyframe, return_keyframes=True)
    res["sp"] = sequence_parallel_odometry(cam, depths, mesh=mesh, stats=stats, **sp_kw) + (stats,)

    def poses_only(frames):
        return np.stack([np.diag([1.0, 1.0, 1.0, 1.0 + f]) for f in frames]).astype(np.float32)

    kw = dict(n_chunks=3, overlap=2, chunk_runner=poses_only, mesh=mesh)
    res["poses_only"] = sequence_parallel_odometry(None, list(range(7)), **kw)
    try:
        sequence_parallel_odometry(None, list(range(7)), return_keyframes=True, **kw)
        res["poses_only_keyframes"] = None
    except ValueError as e:
        res["poses_only_keyframes"] = str(e)

    # The same calls on one rank: a mesh of this rank alone (a group of one
    # of the world's ranks), rank 0 the pipeline, rank 1 the odometry.
    alone = [dist.new_group([r]) for r in range(world)][rank]
    one = M.Mesh(alone, (1, 1), mesh.axis_names, mesh.device)
    if rank == 0:
        res["one"] = {
            "traj": ds.distributed_slam(cam, depths, grays, one, cfg, n_chunks=2, kf_stride=1,
                                        bundle_adjust=False),
            "traj_ba": ds.distributed_slam(cam, depths, grays, one, cfg, n_chunks=2, kf_stride=2,
                                           detector="tpu"),
        }
    else:
        stats = {}
        res["one"] = {"sp": sequence_parallel_odometry(cam, depths, mesh=None, stats=stats,
                                                       device="cpu", **sp_kw) + (stats,),
                      "poses_only": sequence_parallel_odometry(None, list(range(7)), n_chunks=3,
                                                               overlap=2, chunk_runner=poses_only,
                                                               device="cpu")}
    return res


_SUITES = {"parallel": _parallel, "cli": _cli, "dslam": _dslam}


if __name__ == "__main__":
    sys.path.insert(0, str(_REPO))
    import torch

    torch.set_num_threads(1)
    suite, workdir, rank, world = sys.argv[1], pathlib.Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    try:
        result = _SUITES[suite](workdir, rank, world)
        torch.save(result, workdir / f"rank{rank}.pt")
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    if "jax" in sys.modules:
        print("a rank imported jax", file=sys.stderr)
        sys.exit(2)
