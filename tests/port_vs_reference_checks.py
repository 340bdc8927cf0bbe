"""One-off checks of the port against the JAX package, on the CPU; not
collected by pytest. Each prints one JSON line.

    python tests/port_vs_reference_checks.py ba [WIDTH HEIGHT]
    python tests/port_vs_reference_checks.py odom-resume
    python tests/port_vs_reference_checks.py dslam [FRAMES WIDTH HEIGHT]
    python tests/port_vs_reference_checks.py tools [WIDTH HEIGHT]

``ba``: both packages' ``Slam.optimize(bundle_adjust=True)`` over one
64-frame TUM directory that the port's ``data/tum.py`` writes (640x480 by
default; config 4's ICP and pose graph, a keyframe at least every 4th frame,
config 5's BA with the on-device detector): the ATE with the pose graph
alone and with BA, and the refined keyframe poses of the two packages.

``odom-resume``: each package's ``odom`` command over a 56-frame 80x60
directory with config 3, once through and as ``--max-frames 50`` then
``--resume``. The reference's resume raises a TypeError (its checkpoint
loader calls ``_make_frame`` with one argument); it is run here with that
call given ``intensity=None``, as the port's loader does.

``dslam``: both packages' ``distributed_slam(bundle_adjust=True,
detector="tpu")`` over one TUM directory that the port writes (32 frames at
160x120 by default; config 4's ICP and pose graph, a keyframe at least every
4th frame, config 5's BA): the port as its ``slam`` command runs it on a
(1, 2) config mesh, two gloo ranks the command starts itself; the JAX
package on a 2-device virtual mesh over the frames that command decodes,
its eager ``shard_map`` stages jitted (the same functions). The largest
trajectory difference and each package's ATE.

``tools``: the full tables of the two ICP experiments
(``tools/reassoc_exp.py``: ``reassoc_every`` 1, 2, 3 on seed 5;
``tools/photometric_exp.py``: weights 0, 0.1, 0.5 on seeds 5, 6, 7; 10
frames, config 3's stride, 22 steps a track) at 160x120 by default, with
the camera of the experiments (fx = 525 at 640x480) scaled to the frames.
The hard-mode sequences are the JAX package's, from its draws of each seed:
the reference's loop (jitted ``make_icp_frame``, ``icp_track``) and the
port's (``ate_rows``) run on the reference's frames, and the port's loop
also on its own render of the same draws. Per setting: the largest
difference of the camera centres and each ATE.
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import sys
import tempfile

_REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_REPO))

# Two virtual CPU devices for the reference's mesh (the dslam check).
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera  # noqa: E402
from rgbd_pose_estimation_tpu.utils import config as jconfig  # noqa: E402
from rgbd_pose_estimation_tpu_torch.data import tum  # noqa: E402
from rgbd_pose_estimation_tpu_torch.eval.ate import ate_rmse  # noqa: E402
from rgbd_pose_estimation_tpu_torch.utils import config  # noqa: E402

CONFIGS = _REPO / "configs"


def _centers(T):
    return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])


def _slam_config(pkg):
    c4 = pkg.load_yaml_config(CONFIGS / "config4_pose_graph.yaml")
    c5 = pkg.load_yaml_config(CONFIGS / "config5_distributed_ba.yaml")
    return pkg.PipelineConfig(icp=c4.icp, pose_graph=c4.pose_graph,
                              keyframe=pkg.KeyframeConfig(max_interval=4), ba=c5.ba,
                              frontend=dataclasses.replace(c5.frontend, detector="tpu"))


def check_ba(root, size=(640, 480)):
    from rgbd_pose_estimation_tpu.models.slam import Slam as JSlam
    from rgbd_pose_estimation_tpu_torch.models.slam import Slam

    cam = tum.write_synthetic_tum(root, n_frames=64, size=size, motion_scale=0.008, seed=61,
                                  device="cpu")
    seq = tum.TumSequence(root)
    frames = [seq.frame(i) for i in range(len(seq))]
    _, gt = seq.groundtruth_aligned()
    out = {"size": list(size)}
    for name, slam in (("port", Slam(cam, _slam_config(config), device="cpu")),
                       ("reference", JSlam(JCamera(cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                                                   cam.height), _slam_config(jconfig)))):
        for _, gray, depth in frames:
            slam.track(depth, gray=gray)
        pose_graph = np.asarray(slam.optimize())
        with_ba = np.asarray(slam.optimize(bundle_adjust=True))
        kf = [k.index for k in slam.odo.keyframes]
        out[name] = {"keyframes": kf, "ate_pose_graph_m": ate_rmse(_centers(pose_graph), _centers(gt)),
                     "ate_ba_m": ate_rmse(_centers(with_ba), _centers(gt)),
                     "ba_moved_keyframes_by": float(np.abs(with_ba[kf] - pose_graph[kf]).max()),
                     "keyframes_from_truth_after_ba": float(np.abs(with_ba[kf] - gt[kf]).max())}
        out[name]["_poses"] = (kf, pose_graph, with_ba)
    (kf, pg, ba), (kf_r, pg_r, ba_r) = out["port"].pop("_poses"), out["reference"].pop("_poses")
    if kf == kf_r:
        out["port_vs_reference"] = {"pose_graph_keyframes": float(np.abs(pg[kf] - pg_r[kf]).max()),
                                    "refined_keyframes": float(np.abs(ba[kf] - ba_r[kf]).max())}
    return out


def check_odom_resume(root):
    from rgbd_pose_estimation_tpu.cli.main import main as jmain
    from rgbd_pose_estimation_tpu.utils import checkpoint as jcheckpoint
    from rgbd_pose_estimation_tpu_torch.cli.main import main
    from rgbd_pose_estimation_tpu_torch.eval.traj_io import read_tum_trajectory

    load = jcheckpoint.load_odometry_checkpoint

    def load_with_intensity_none(path, odo, seq):
        make_frame = odo._make_frame
        odo._make_frame = lambda depth, intensity=None: make_frame(depth, intensity)
        return load(path, odo, seq)

    jcheckpoint.load_odometry_checkpoint = load_with_intensity_none
    d = str(pathlib.Path(root) / "synth")
    with contextlib.redirect_stdout(io.StringIO()):
        main(["synth", "--out", d, "--frames", "56", "--width", "80", "--height", "60", "--cpu"])
    out = {}
    for name, run in (("port", main), ("reference", jmain)):
        common = ["--dataset", d, "--config", str(CONFIGS / "config3_dense_icp_odometry.yaml"),
                  "--intrinsics", "from_dataset", "--cpu"]
        full, resumed = (str(pathlib.Path(root) / f"{name}_{k}.txt") for k in ("full", "resumed"))
        with contextlib.redirect_stdout(io.StringIO()):
            run(["odom", "--out", full, *common])
            run(["odom", "--out", resumed, "--max-frames", "50", *common])
            run(["odom", "--out", resumed, "--resume", *common])
        a, b = read_tum_trajectory(full)[1], read_tum_trajectory(resumed)[1]
        per_frame = np.abs(a - b).reshape(len(a), -1).max(axis=1)
        out[name] = {"max_abs_diff": float(per_frame.max()),
                     "first_differing_frame": int(np.argmax(per_frame > 0)) if per_frame.max() > 0 else None}
    return out


def check_dslam(root, frames=32, size=(160, 120)):
    from rgbd_pose_estimation_tpu.core import lie as jlie
    from rgbd_pose_estimation_tpu.icp import dense as jdense
    from rgbd_pose_estimation_tpu.models import distributed_slam as jds
    from rgbd_pose_estimation_tpu.parallel import sharded as jsharded
    from rgbd_pose_estimation_tpu.parallel.mesh import make_mesh as jmake_mesh
    from rgbd_pose_estimation_tpu_torch.cli.main import main
    from rgbd_pose_estimation_tpu_torch.eval.traj_io import read_tum_trajectory

    root = pathlib.Path(root)
    cam = tum.write_synthetic_tum(root / "synth", n_frames=frames, size=size, motion_scale=0.008,
                                  seed=61, device="cpu")
    cfg = _slam_config(config)
    yaml = root / "dslam.yaml"
    yaml.write_text(
        f"icp:\n  levels: {cfg.icp.levels}\n  iters_per_level: {list(cfg.icp.iters_per_level)}\n"
        f"pose_graph:\n  iters: {cfg.pose_graph.iters}\n  damping: {cfg.pose_graph.damping}\n"
        f"  odom_sigma: {cfg.pose_graph.odom_sigma}\n  loop_sigma: {cfg.pose_graph.loop_sigma}\n"
        f"keyframe:\n  max_interval: {cfg.keyframe.max_interval}\n"
        f"ba:\n  outer_iters: {cfg.ba.outer_iters}\n  cg_iters: {cfg.ba.cg_iters}\n"
        f"  damping: {cfg.ba.damping}\n  huber_delta: {cfg.ba.huber_delta}\n"
        "mesh:\n  hosts: 1\n  chips_per_host: 2\n"
        f"frontend:\n  detector: tpu\n  max_features: {cfg.frontend.max_features}\n")
    if config.load_yaml_config(yaml) != dataclasses.replace(cfg, mesh=config.MeshConfig(chips_per_host=2)):
        raise AssertionError("the written config is not the check's")
    out_path = root / "port.txt"
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = main(["slam", "--dataset", str(root / "synth"), "--config", str(yaml), "--intrinsics",
                   "from_dataset", "--out", str(out_path), "--cpu"])
    port_run = json.loads(printed.getvalue().strip().splitlines()[-1])
    if rc != 0:
        raise AssertionError(f"slam exited {rc}")
    port = read_tum_trajectory(str(out_path))[1]

    seq = tum.TumSequence(str(root / "synth"))
    decoded = [seq.frame(i) for i in range(len(seq))]
    _, gt = seq.groundtruth_aligned()
    jcam = JCamera(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
    jmesh = jmake_mesh(jconfig.MeshConfig(hosts=1, chips_per_host=2))
    jds.icp_verify_sharded = jax.jit(jsharded.icp_verify_sharded, static_argnums=(0, 1, 2))
    jds.ring_similarity = jax.jit(jsharded.ring_similarity, static_argnums=0)
    jds.make_icp_frame = jax.jit(jdense.make_icp_frame, static_argnums=(0, 2))
    jds.se3_inverse = jax.jit(jlie.se3_inverse)
    ref = np.asarray(jds.distributed_slam(jcam, [d for _, _, d in decoded], [g for _, g, _ in decoded],
                                          jmesh, _slam_config(jconfig), n_chunks=2, detector="tpu"))
    # The TUM file holds the port's poses at 6-7 digits.
    return {"frames": frames, "size": list(size), "port_mesh": "2 gloo ranks (slam, config mesh 1 x 2)",
            "reference_mesh": "2 virtual CPU devices",
            "max_abs_diff_trajectory": float(np.abs(port - ref).max()),
            "ate_port_m": ate_rmse(_centers(port), _centers(gt)),
            "ate_port_printed_m": port_run.get("ate_rmse"),
            "ate_reference_m": ate_rmse(_centers(ref), _centers(gt))}


def _reference_hard_sequence(jcam, seed, frames):
    """The JAX package's hard-mode sequence of ``key(seed)``, and its draws in
    the port's form (the pattern of tests/test_torch_synthetic.py)."""
    from rgbd_pose_estimation_tpu.data import synthetic as jsyn

    key = jax.random.key(seed)
    render = jax.jit(jsyn.synthetic_sequence_hard, static_argnums=(0, 2))
    ref = [np.asarray(a) for a in render(jcam, key, frames)]
    k_traj, k_deg = jax.random.split(key)
    deltas = np.asarray(jax.random.normal(k_traj, (frames, 6)))
    noise, seeds = [], []
    for k in jax.random.split(k_deg, frames):
        k1, k2 = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k1, (jcam.height, jcam.width))))
        seeds.append(int(jax.random.randint(k2, (), 0, 1 << 30)))
    draws = {"deltas": torch.from_numpy(deltas), "noise": torch.from_numpy(np.stack(noise)),
             "dropout_seeds": torch.tensor(seeds, dtype=torch.int32)}
    return ref, draws


def check_tools(size=(160, 120), frames=10):
    import jax.numpy as jnp

    from rgbd_pose_estimation_tpu.eval.ate import ate_rmse as jax_ate_rmse
    from rgbd_pose_estimation_tpu.icp import dense as jdense
    from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
    from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence_hard
    from rgbd_pose_estimation_tpu_torch.tools import photometric_exp, reassoc_exp

    w, h = size
    f = 525.0 * w / 640
    cam = CameraIntrinsics(f, f, w / 2 - 0.5, h / 2 - 0.5, w, h)
    jcam = JCamera(cam.fx, cam.fy, cam.cx, cam.cy, w, h)
    make_frame = jax.jit(jdense.make_icp_frame, static_argnums=(0, 2))

    def reference_centres(cfg, depths, intensities):
        photo = cfg.photometric_weight > 0
        fr = [make_frame(jcam, jnp.asarray(depths[i]), cfg, jnp.asarray(intensities[i]) if photo else None)
              for i in range(frames)]
        T_acc = [np.eye(4)]
        for i in range(1, frames):
            T, _ = jdense.icp_track(jcam, cfg, jnp.eye(4), fr[i], fr[i - 1])
            T_acc.append(T_acc[-1] @ np.asarray(T))
        return np.stack(T_acc)[:, :3, 3]

    def compare(cfgs, seed):
        (poses, depths, intens, _), draws = _reference_hard_sequence(jcam, seed, frames)
        own = synthetic_sequence_hard(cam, None, frames, device="cpu", **draws)
        gt = reassoc_exp.true_centres(torch.from_numpy(poses))
        port = reassoc_exp.ate_rows(cam, torch.from_numpy(poses), torch.from_numpy(depths), cfgs,
                                    torch.from_numpy(intens))
        port_own = reassoc_exp.ate_rows(cam, own[0], own[1], cfgs, own[2])
        rows = []
        for cfg, row, row_own in zip(cfgs, port, port_own):
            ref = reference_centres(config_from_jax(cfg), depths, intens)
            rows.append({"seed": seed, "reassoc_every": cfg.reassoc_every,
                         "photometric_weight": cfg.photometric_weight,
                         "max_centre_diff_m": float(np.abs(row["centres"] - ref).max()),
                         "ate_port_m": row["ate_m"], "ate_reference_m": float(jax_ate_rmse(ref, gt)),
                         "ate_port_own_render_m": row_own["ate_m"]})
        return rows

    def config_from_jax(cfg):
        return jconfig.IcpConfig(**dataclasses.asdict(cfg))

    out = {"size": list(size), "frames": frames, "fx": f}
    out["reassoc_exp"] = compare(reassoc_exp.configs(), reassoc_exp.SEED)
    out["photometric_exp"] = [r for seed in photometric_exp.SEEDS
                              for r in compare(photometric_exp.configs(), seed)]
    every = out["reassoc_exp"] + out["photometric_exp"]
    out["max_centre_diff_m"] = max(r["max_centre_diff_m"] for r in every)
    out["max_ate_diff_m"] = max(abs(r["ate_port_m"] - r["ate_reference_m"]) for r in every)
    return out


if __name__ == "__main__":
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        if sys.argv[1] == "ba":
            size = tuple(int(x) for x in sys.argv[2:4]) or (640, 480)
            print(json.dumps(check_ba(tmp, size)))
        elif sys.argv[1] == "odom-resume":
            print(json.dumps(check_odom_resume(tmp)))
        elif sys.argv[1] == "tools":
            size = tuple(int(x) for x in sys.argv[2:4]) or (160, 120)
            print(json.dumps(check_tools(size)))
        elif sys.argv[1] == "dslam":
            n, w, h = (int(x) for x in sys.argv[2:5]) if len(sys.argv) > 2 else (32, 160, 120)
            print(json.dumps(check_dslam(tmp, n, (w, h))))
        else:
            raise SystemExit(__doc__)
