"""cli/main.py of the PyTorch port, on the CPU (``--cpu``), in process.

Every command goes through ``main(argv)`` over 80x60 directories that the
port's ``synth`` writes, with the on-device detector (``--detector tpu``:
host ORB finds no keypoint at 80x60). ``eval`` and ``synth`` are held
against the JAX package's ``main``; ``pair`` and ``odom`` against the port's
own ``FramePairEstimator`` and ``DenseOdometry`` on the same frames (those
classes are held against the JAX package's in their own files); ``odom
--resume`` and ``ba --fail-at-iter`` then ``--resume`` against one
uninterrupted run; ``slam`` against a direct ``distributed_slam`` call. A
mesh of several devices makes ``ba`` and ``slam`` start their ranks
(``parallel/spawn.py``; here the call that starts them is recorded, the
ranks run in ``test_torch_cli_ranks.py``), a mesh larger than the devices
raises ``ValueError`` before any rank starts, and every command raises
``RuntimeError`` where there is no CUDA device and neither ``--cpu`` nor
``--cpu-devices`` is given.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import contextlib
import io
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.cli import main as jcli
from rgbd_pose_estimation_tpu.data import synthetic as jsyn
from rgbd_pose_estimation_tpu_torch.cli.main import _dataset_cam, main
from rgbd_pose_estimation_tpu_torch.data.icl_nuim import open_sequence
from rgbd_pose_estimation_tpu_torch.data.prefetch import sequence_prefetcher
from rgbd_pose_estimation_tpu_torch.data.tum import render_synthetic
from rgbd_pose_estimation_tpu_torch.eval.ate import ate_rmse
from rgbd_pose_estimation_tpu_torch.eval.traj_io import read_tum_trajectory, write_tum_trajectory
from rgbd_pose_estimation_tpu_torch.graph.pose_graph import optimize_trajectory
from rgbd_pose_estimation_tpu_torch.models.distributed_slam import distributed_slam
from rgbd_pose_estimation_tpu_torch.models.frame_pair import FramePairEstimator
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry
from rgbd_pose_estimation_tpu_torch.parallel import spawn
from rgbd_pose_estimation_tpu_torch.parallel.mesh import make_mesh
from rgbd_pose_estimation_tpu_torch.utils.config import PipelineConfig, load_yaml_config
from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger

_CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
C1, C2, C3, C5 = (str(_CONFIGS / name) for name in (
    "config1_synthetic_ao_pair.yaml", "config2_ransac_pnp_pair.yaml",
    "config3_dense_icp_odometry.yaml", "config5_distributed_ba.yaml"))
FRAMES, W, H, MOTION = 56, 80, 60, 0.01  # > 50: odom checkpoints after frame 49


def _run(cli_main, *argv):
    """``(exit code, stdout)`` of one in-process command."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(list(argv))
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's ``synth`` directory, config 5 on one device, and one
    uninterrupted config-3 ``odom`` run over all its frames."""
    root = tmp_path_factory.mktemp("cli")
    d = str(root / "synth")
    rc, out = _run(main, "synth", "--out", d, "--frames", str(FRAMES), "--width", str(W),
                   "--height", str(H), "--motion", str(MOTION), "--cpu")
    assert rc == 0 and json.loads(out) == {"out": d, "frames": FRAMES}
    # Config 5's BA and front-end sections on a 1 x 1 mesh.
    c5 = root / "config5_one_device.yaml"
    c5.write_text(pathlib.Path(C5).read_text()
                  .replace("hosts: 2", "hosts: 1").replace("chips_per_host: 4", "chips_per_host: 1"))
    full = str(root / "odom_full.txt")
    rc, out = _run(main, "odom", "--dataset", d, "--out", full, "--config", C3,
                   "--intrinsics", "from_dataset", "--cpu")
    assert rc == 0 and json.loads(out)["num_frames"] == FRAMES
    return {"dir": d, "c5": str(c5), "odom_full": full}


def test_synth_writes_the_reference_files(data, tmp_path, monkeypatch):
    """The reference's ``synth``, handed the port's render in place of its
    own (the two packages draw the trajectory from different random
    streams, jax.random and torch), writes the same ``intrinsics.txt`` and
    ``groundtruth.txt`` as the port's."""
    render = render_synthetic(_dataset_cam(data["dir"]), FRAMES, MOTION, 0, device="cpu")
    monkeypatch.setattr(jsyn, "synthetic_sequence",
                        lambda cam, key, n, motion: tuple(jnp.asarray(x.numpy()) for x in render))
    ref = tmp_path / "ref"
    rc, _ = _run(jcli.main, "synth", "--out", str(ref), "--frames", str(FRAMES), "--width", str(W),
                 "--height", str(H), "--motion", str(MOTION), "--cpu")
    assert rc == 0
    d = pathlib.Path(data["dir"])
    for name in ("intrinsics.txt", "groundtruth.txt", "rgb.txt", "depth.txt"):
        assert (d / name).read_bytes() == (ref / name).read_bytes(), name
    assert len(open_sequence(data["dir"])) == FRAMES


def test_eval_json_equals_reference(data):
    args = ("eval", "--est", data["odom_full"], "--gt", str(pathlib.Path(data["dir"]) / "groundtruth.txt"),
            "--cpu")
    rc, out = _run(main, *args)
    rc_ref, out_ref = _run(jcli.main, *args)
    own, ref = json.loads(out), json.loads(out_ref)
    assert rc == rc_ref == 0 and own.keys() == ref.keys()
    assert own["num_poses"] == ref["num_poses"] == FRAMES
    for k in ("ate_rmse", "trans_rmse", "rot_rmse"):
        assert abs(own[k] - ref[k]) <= 1e-6, (k, own[k], ref[k])


@pytest.mark.parametrize("mode,config", [("3d3d", C1), ("2d3d", C2)], ids=["3d3d", "2d3d"])
def test_pair_equals_frame_pair_estimator(data, mode, config):
    rc, out = _run(main, "pair", "--dataset", data["dir"], "--mode", mode, "--config", config,
                   "--detector", "tpu", "--intrinsics", "from_dataset", "--cpu")
    got = json.loads(out)
    seq = open_sequence(data["dir"])
    (_, ga, da), (_, gb, db) = seq.frame(0), seq.frame(1)
    est = FramePairEstimator(_dataset_cam(data["dir"]), load_yaml_config(config).ransac, mode=mode,
                             detector="tpu", device="cpu")
    res = est.estimate(ga, da, gb, db if mode == "3d3d" else None,
                       generator=torch.Generator().manual_seed(0))
    assert np.array_equal(np.asarray(got["pose"], np.float32), res.pose)
    assert (got["valid"], got["num_matches"], got["num_inliers"], got["num_hypotheses"]) == (
        res.valid, res.num_matches, res.num_inliers, res.num_hypotheses)
    assert rc == (0 if res.valid else 1)


def test_odom_with_pose_graph_equals_dense_odometry(data, tmp_path):
    """``odom --max-frames 40 --pose-graph`` against ``DenseOdometry``'s
    pipelined server and ``optimize_trajectory`` over the same 40 frames,
    and the ATE the run logs against the one computed here."""
    n = 40
    out_path, metrics = str(tmp_path / "t.txt"), str(tmp_path / "m.jsonl")
    rc, out = _run(main, "odom", "--dataset", data["dir"], "--out", out_path, "--config", C3,
                   "--intrinsics", "from_dataset", "--max-frames", str(n), "--pose-graph",
                   "--metrics", metrics, "--cpu")
    assert rc == 0 and json.loads(out)["num_frames"] == n
    cfg = load_yaml_config(C3)
    seq = open_sequence(data["dir"])
    odo = DenseOdometry(_dataset_cam(data["dir"]), cfg.icp, cfg.keyframe,
                        depth_scale=seq.depth_scale, device="cpu")
    depths = (d for _, _, d in sequence_prefetcher(seq, 0, n, device_depth=True, device="cpu"))
    for _ in odo.process_stream(depths, pipeline_depth=2):
        pass
    expect = optimize_trajectory(odo, cfg.pose_graph)
    ts, got = read_tum_trajectory(out_path)
    assert np.array_equal(ts, seq.timestamps[:n])
    # The TUM file holds a translation and a quaternion at 6-7 digits.
    np.testing.assert_allclose(got, expect, atol=2e-6)

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    _, gt = seq.groundtruth_aligned()
    logged = [json.loads(line) for line in open(metrics)]
    ate = [r["ate_rmse"] for r in logged if "ate_rmse" in r]
    assert ate == [ate_rmse(centers(expect), centers(gt[:n]))]
    assert ate[0] < 0.01


def test_odom_resume_across_the_checkpoint_equals_one_run(data, tmp_path):
    """``odom --max-frames 50`` writes a checkpoint after frame 49;
    ``--resume`` over all frames then gives the uninterrupted trajectory,
    bit for bit (same device, same operations)."""
    out_path = str(tmp_path / "t.txt")
    common = ("--dataset", data["dir"], "--out", out_path, "--config", C3,
              "--intrinsics", "from_dataset", "--cpu")
    assert _run(main, "odom", *common, "--max-frames", "50")[0] == 0
    assert pathlib.Path(out_path + ".ckpt.npz").exists()
    assert _run(main, "odom", *common, "--resume")[0] == 0
    _, resumed = read_tum_trajectory(out_path)
    _, full = read_tum_trajectory(data["odom_full"])
    assert resumed.shape == full.shape == (FRAMES, 4, 4)
    assert np.abs(resumed - full).max() <= 1e-6
    assert np.array_equal(resumed, full)


def test_ba_fault_injection_then_resume_equals_one_run(data, tmp_path):
    """``ba --checkpoint P --fail-at-iter 4`` raises after step 4 with the
    checkpoint at iteration 5; ``--resume`` runs steps 5-9 from it and gives
    the costs and trajectory of one uninterrupted run."""
    common = ("--dataset", data["dir"], "--config", data["c5"], "--intrinsics", "from_dataset",
              "--detector", "tpu", "--max-frames", "16", "--kf-interval", "4", "--cpu")
    full = str(tmp_path / "full.txt")
    rc, out = _run(main, "ba", *common, "--out", full, "--checkpoint", str(tmp_path / "full.npz"))
    one_run = json.loads(out)
    assert rc == 0 and len(one_run["costs"]) == 10 and one_run["num_keyframes"] == 4
    assert one_run["costs"][-1] < one_run["costs"][0]
    assert one_run["reproj_rmse_after"] < one_run["reproj_rmse_before"]

    ckpt, resumed = str(tmp_path / "ba.npz"), str(tmp_path / "resumed.txt")
    with pytest.raises(RuntimeError, match="fault injection: failing after BA iteration 4"):
        _run(main, "ba", *common, "--out", resumed, "--checkpoint", ckpt, "--fail-at-iter", "4")
    with np.load(ckpt) as z:
        assert int(z["iter"]) == 5
    rc, out = _run(main, "ba", *common, "--out", resumed, "--checkpoint", ckpt, "--resume")
    again = json.loads(out)
    assert rc == 0
    assert np.abs(np.asarray(again["costs"]) - one_run["costs"][5:]).max() <= 1e-6
    assert again["reproj_rmse_after"] == one_run["reproj_rmse_after"]
    (_, a), (_, b) = read_tum_trajectory(resumed), read_tum_trajectory(full)
    assert np.abs(a - b).max() <= 1e-6


def test_ba_with_a_coordinator_and_one_process_is_the_one_process_ba(data, tmp_path):
    """``--coordinator`` without ``--num-processes > 1`` starts no group, as
    in the reference: the run is the one-process ``ba``, bit for bit."""
    common = ("--dataset", data["dir"], "--config", data["c5"], "--intrinsics", "from_dataset",
              "--detector", "tpu", "--max-frames", "8", "--kf-interval", "4", "--cpu")
    plain, coord = str(tmp_path / "plain.txt"), str(tmp_path / "coord.txt")
    rc, out = _run(main, "ba", *common, "--out", plain)
    rc2, out2 = _run(main, "ba", *common, "--out", coord, "--coordinator", "localhost:1234",
                     "--process-id", "0")
    assert rc == rc2 == 0 and json.loads(out) == json.loads(out2)
    assert not torch.distributed.is_initialized()
    (_, a), (_, b) = read_tum_trajectory(plain), read_tum_trajectory(coord)
    assert np.array_equal(a, b)


def test_slam_equals_a_direct_distributed_slam_call(data, tmp_path):
    """``slam`` in one process (a mesh of one rank) against
    ``distributed_slam`` on the same decoded frames, bit for bit; it writes
    the trajectory, logs the decoding and the ATE, and leaves no group."""
    out_path, metrics = str(tmp_path / "t.txt"), str(tmp_path / "m.jsonl")
    n = 12
    rc, out = _run(main, "slam", "--dataset", data["dir"], "--out", out_path, "--max-frames", str(n),
                   "--intrinsics", "from_dataset", "--detector", "tpu", "--metrics", metrics, "--cpu")
    got = json.loads(out)
    assert rc == 0 and (got["frames"], got["mesh_devices"], got["chunks"]) == (n, 1, 2)
    assert not torch.distributed.is_initialized()
    seq = open_sequence(data["dir"])
    frames = [seq.frame(i) for i in range(n)]
    mesh = make_mesh(device="cpu")
    try:
        expect = distributed_slam(_dataset_cam(data["dir"]), [d for _, _, d in frames],
                                  [g for _, g, _ in frames], mesh, PipelineConfig(),
                                  detector="tpu", metrics=MetricsLogger())
    finally:
        torch.distributed.destroy_process_group()
    # The same file as the direct call's trajectory written by the same writer.
    write_tum_trajectory(str(tmp_path / "direct.txt"), seq.timestamps[:n], expect)
    assert pathlib.Path(out_path).read_bytes() == (tmp_path / "direct.txt").read_bytes()
    _, gt = seq.groundtruth_aligned()

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    assert got["ate_rmse"] == ate_rmse(centers(expect), centers(gt[:n])) < 0.01
    logged = [json.loads(line) for line in open(metrics)]
    io_stage = next(r for r in logged if r.get("stage") == "io")
    assert io_stage["frames_decoded"] == io_stage["frames_total"] == n
    assert [r["stage"] for r in logged if "stage" in r] == [
        "odometry", "keyframes", "loops", "pose_graph", "ba_build", "ba", "io"]


@pytest.fixture
def started(monkeypatch):
    """Records the ranks a command would start, and starts none."""
    calls = []

    def run_ranks(target, args, world, shape, device):
        calls.append((target, args, world, tuple(shape), str(device)))
        return [0] * world

    monkeypatch.setattr(spawn, "run_ranks", run_ranks)
    return calls


@pytest.mark.parametrize("argv,world,shape", [
    (["ba", "--dataset", "D", "--out", "t.txt", "--mesh-devices", "2"], 2, (1, 2)),
    (["ba", "--dataset", "D", "--out", "t.txt", "--config", C5], 8, (2, 4)),  # its mesh: 2 x 4
    (["slam", "--dataset", "D", "--out", "t.txt", "--mesh-devices", "4", "--cpu-devices", "4"], 4, (1, 4)),
    (["slam", "--dataset", "D", "--out", "t.txt", "--config", C5, "--mesh-devices", "2"], 2, (1, 2)),
], ids=["mesh-devices", "config5-mesh", "slam-cpu-devices", "slam-mesh-devices-over-config"])
def test_a_mesh_of_several_devices_starts_one_rank_a_device(argv, world, shape, started):
    """``ba`` and ``slam`` asking for a mesh of n > 1 devices in a process
    that runs in no group start n ranks of the same command, gloo ranks on
    the CPU, with the reference's single-process mesh shape: ``(1, n)`` for
    ``--mesh-devices``, the config's otherwise. Rank 0's exit code is the
    command's."""
    assert main(argv + ["--cpu"]) == 0
    assert started == [("rgbd_pose_estimation_tpu_torch.cli.main:main", (argv + ["--cpu"],), world,
                        shape, "cpu")]
    assert not torch.distributed.is_initialized()


def test_cpu_devices_imply_the_cpu(data, monkeypatch):
    """``--cpu-devices N`` runs a command on the CPU, as in the reference,
    where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run(main, "eval", "--est", data["odom_full"], "--gt",
                   str(pathlib.Path(data["dir"]) / "groundtruth.txt"), "--cpu-devices", "2")
    assert rc == 0 and json.loads(out)["num_poses"] == FRAMES


@pytest.mark.parametrize("argv", [
    ["slam", "--dataset", "D", "--out", "t.txt", "--cpu-devices", "1", "--mesh-devices", "2"],
    ["ba", "--dataset", "D", "--out", "t.txt", "--cpu-devices", "4", "--config", C5],
], ids=["slam", "ba-config5-mesh"])
def test_a_mesh_beyond_the_cpu_devices_raises_before_any_rank(argv, started):
    """``--cpu-devices N`` caps the mesh at N devices: a larger one raises
    ``ValueError`` (as JAX fails on a mesh larger than its devices) before
    any rank starts."""
    with pytest.raises(ValueError, match="devices on [14] CPU devices"):
        main(argv)
    assert started == []


def test_a_mesh_beyond_the_cards_raises_before_any_rank(started, monkeypatch):
    """On CUDA devices each rank takes one card (NCCL puts no two ranks on
    one): ``--mesh-devices 2`` with one card raises ``ValueError`` before
    any rank starts, and nothing falls back to gloo or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 CUDA devices, one a rank.*1 visible"):
        main(["slam", "--dataset", "D", "--out", "t.txt", "--mesh-devices", "2"])
    assert started == []


@pytest.mark.parametrize("argv", [
    ["synth", "--out", "D"],
    ["pair", "--dataset", "D", "--detector", "tpu"],
    ["odom", "--dataset", "D", "--out", "t.txt"],
    ["ba", "--dataset", "D", "--out", "t.txt"],
    ["slam", "--dataset", "D", "--out", "t.txt"],
    ["eval", "--est", "a", "--gt", "b"],
], ids=lambda a: a[0])
def test_without_a_card_every_command_raises_unless_cpu(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*--cpu"):
        main(argv)


def test_orb_without_opencv_raises_and_never_takes_the_device_detector(data, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    with pytest.raises(RuntimeError, match='detector "orb".*cv2'):
        main(["pair", "--dataset", data["dir"], "--intrinsics", "from_dataset", "--cpu"])
