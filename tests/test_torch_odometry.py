"""models/odometry.py of the PyTorch port against the JAX package's
``DenseOdometry``, frame by frame on the CPU, and the port's pipelined server
against its synchronous one; then ``models/slam.py::Slam``, loop closure and
``icp_track_batch`` against the JAX package's on the same frames.

80x60 frames, two levels, two tracking settings in all (unstrided and
strided): the JAX side compiles one track and one frame builder for each.
The sequence is rendered once by the JAX package and fed to both as numpy.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.ba import schur as jschur
from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
from rgbd_pose_estimation_tpu.data import synthetic as jsyn
from rgbd_pose_estimation_tpu.graph import pose_graph as jpose_graph
from rgbd_pose_estimation_tpu.icp import dense as jdense
from rgbd_pose_estimation_tpu.models.odometry import DenseOdometry as JDenseOdometry
from rgbd_pose_estimation_tpu.models.slam import Slam as JSlam
from rgbd_pose_estimation_tpu.utils.config import IcpConfig as JIcpConfig
from rgbd_pose_estimation_tpu.utils.config import KeyframeConfig as JKeyframeConfig
from rgbd_pose_estimation_tpu.utils.config import PipelineConfig as JPipelineConfig
from rgbd_pose_estimation_tpu_torch.eval.ate import ate_rmse
from rgbd_pose_estimation_tpu_torch.graph.pose_graph import detect_loop_closures
from rgbd_pose_estimation_tpu_torch.icp.dense import icp_track, icp_track_batch
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry, Keyframe
from rgbd_pose_estimation_tpu_torch.models.slam import Slam
from rgbd_pose_estimation_tpu_torch.parallel.mesh import make_mesh
from rgbd_pose_estimation_tpu_torch.utils.config import KeyframeConfig
from rgbd_pose_estimation_tpu_torch.utils.convert import (
    camera_from_reference,
    config_from_reference,
    icp_frame_from_reference,
    keyframes_from_reference,
)
from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger

# The JAX package's sequence renderer, jitted (camera and frame count are
# compile-time constants): one compile instead of one per primitive.
synthetic_sequence = jax.jit(jsyn.synthetic_sequence, static_argnums=(0, 2))

JCAM = JCamera(80.0, 80.0, 39.5, 29.5, 80, 60)
CAM = camera_from_reference(JCAM)
ICP = JIcpConfig(levels=2, iters_per_level=(3, 4))
ICP_STRIDED = JIcpConfig(levels=2, iters_per_level=(3, 4), source_stride=(2, 2), reassoc_every=2)
FRAMES = 5
# Poses of the two packages, frame by frame: the tracks agree to ~5e-5 (see
# test_torch_icp.py) and a trajectory chains up to four of them.
POSE_ATOL = 2e-4
# Against the rendered poses, and between runs that track against different
# keyframes: 80x60 pixels resolve the scene to some millimetres (more
# iterations do not help). 1e-2 is the JAX package's own bound for both.
TRUTH_TOL = 1e-2
STREAM_TOL = 1e-2


@pytest.fixture(scope="module")
def sequence():
    poses, depths, intens = synthetic_sequence(JCAM, jax.random.key(0), FRAMES, 0.01)
    return np.asarray(poses), [np.asarray(d) for d in depths], [np.asarray(i) for i in intens]


def _port(icp=ICP, kf=JKeyframeConfig(), **kw):
    return DenseOdometry(
        CAM, config_from_reference(icp), config_from_reference(kf), device="cpu", **kw
    )


def _keyframe_flags(odo):
    return [r["keyframe"] for r in odo.metrics.records]


@pytest.fixture(scope="module")
def reference_run(sequence):
    """The JAX package's server over the sequence, keyframe every 2nd frame."""
    _, depths, _ = sequence
    odo = JDenseOdometry(JCAM, ICP, JKeyframeConfig(max_interval=2))
    for d in depths:
        odo.process(d)
    return odo


def test_process_matches_reference(sequence, reference_run):
    poses_gt, depths, _ = sequence
    odo = _port(kf=JKeyframeConfig(max_interval=2))
    out = [odo.process(d) for d in depths]
    ref = reference_run
    assert out[0].dtype == np.float32 and odo.trajectory().shape == (FRAMES, 4, 4)
    np.testing.assert_allclose(odo.trajectory(), ref.trajectory(), atol=POSE_ATOL)
    assert np.abs(odo.trajectory() - poses_gt).max() < TRUTH_TOL
    # Keyframe decisions, edges and the overlap signal behind them.
    assert _keyframe_flags(odo) == _keyframe_flags(ref) == [True, False, True, False, True]
    assert [k.index for k in odo.keyframes] == [k.index for k in ref.keyframes] == [0, 2, 4]
    assert [(a, b) for a, b, _ in odo.odom_edges] == [(a, b) for a, b, _ in ref.odom_edges]
    for (_, _, Ta), (_, _, Tb) in zip(odo.odom_edges, ref.odom_edges):
        np.testing.assert_allclose(Ta, Tb, atol=POSE_ATOL)
    mine = [r["overlap"] for r in odo.metrics.records[1:]]
    theirs = [r["overlap"] for r in ref.metrics.records[1:]]
    np.testing.assert_allclose(mine, theirs, rtol=2e-3)
    assert all(0.8 < o <= 1.0 for o in mine)
    assert odo.keyframes[0].ref_weight_value() == ref.keyframes[0].ref_weight_value()
    assert odo.metrics.summary()["num_frames"] == FRAMES


def test_uint16_depth_matches_reference(sequence):
    """Sensor units (uint16, 1/5000 m) are turned into meters on the device,
    in both packages."""
    _, depths, _ = sequence
    u16 = [np.asarray(d * 5000.0, np.uint16) for d in depths[:3]]
    ref = JDenseOdometry(JCAM, ICP, JKeyframeConfig())
    odo = _port()
    for d in u16:
        ref.process(d)
        odo.process(d)
    np.testing.assert_allclose(odo.trajectory(), ref.trajectory(), atol=POSE_ATOL)
    # ... and as a tensor that is already on the device.
    odo_t = _port()
    for d in u16:
        odo_t.process(torch.from_numpy(d.copy()))
    np.testing.assert_array_equal(odo_t.trajectory(), odo.trajectory())


def test_uint16_above_the_sign_bit():
    """40000 units = 8 m: through int16 bits and back, not negative."""
    odo = _port()
    d = np.full((60, 80), 40000, np.uint16)
    d[:, 40:] = 10000
    frame, ref_w = odo._make_frame(odo._to_device(d), None)
    z = frame.vertices[0][..., 2]
    assert torch.all(z[:, :40] == 0.0)  # 8 m is beyond max_depth: invalid, not −5.1 m
    np.testing.assert_allclose(z[:, 40:].numpy(), 2.0, rtol=1e-6)
    for dtype in (np.int32, np.int16):
        f2, _ = odo._make_frame(odo._to_device(np.full((60, 80), 10000, dtype)), None)
        np.testing.assert_allclose(f2.vertices[0][..., 2].numpy(), 2.0, rtol=1e-6)


def test_overlap_ratio_under_source_stride_makes_every_frame_a_keyframe(sequence):
    """A fault of the reference, ported as it is: the overlap ratio divides
    the weight sum of the STRIDED sample by a full-resolution reference
    weight, so under a stride of 2 it is about a quarter, below
    ``min_inlier_ratio``, and every frame becomes a keyframe."""
    _, depths, _ = sequence
    ref = JDenseOdometry(JCAM, ICP_STRIDED, JKeyframeConfig())
    odo = _port(ICP_STRIDED)
    for d in depths[:4]:
        ref.process(d)
        odo.process(d)
    assert _keyframe_flags(odo) == _keyframe_flags(ref) == [True] * 4
    mine = [r["overlap"] for r in odo.metrics.records[1:]]
    theirs = [r["overlap"] for r in ref.metrics.records[1:]]
    np.testing.assert_allclose(mine, theirs, rtol=2e-3)
    assert all(0.15 < o < 0.3 for o in mine)
    np.testing.assert_allclose(odo.trajectory(), ref.trajectory(), atol=POSE_ATOL)


def test_max_keyframes_saturates_silently(sequence):
    """A fault of the reference, ported as it is: at ``max_keyframes`` the
    server stops adopting keyframes and recording edges, logs
    ``keyframe: true`` all the same, and says nothing."""
    _, depths, _ = sequence
    kf = JKeyframeConfig(max_interval=1, max_keyframes=2)
    ref = JDenseOdometry(JCAM, ICP, kf)
    odo = _port(kf=kf)
    for d in depths:
        ref.process(d)
        odo.process(d)
    assert len(odo.keyframes) == len(ref.keyframes) == 2
    assert len(odo.odom_edges) == len(ref.odom_edges) == 1
    assert _keyframe_flags(odo) == _keyframe_flags(ref) == [True] * FRAMES
    np.testing.assert_allclose(odo.trajectory(), ref.trajectory(), atol=POSE_ATOL)


def test_process_stream_equals_process_without_keyframe_lag(sequence):
    """With one keyframe for the whole run the pipelined server tracks the
    same pairs from the same poses (carried on the device instead of through
    the host): the same bits."""
    _, depths, _ = sequence
    kf = JKeyframeConfig(min_inlier_ratio=0.0, max_interval=1000)
    a, b = _port(kf=kf), _port(kf=kf)
    for d in depths:
        a.process(d)
    out = list(b.process_stream(iter(depths), pipeline_depth=2))
    assert [i for i, _ in out] == list(range(FRAMES))
    np.testing.assert_array_equal(np.stack([p for _, p in out]), a.trajectory())
    np.testing.assert_array_equal(b.trajectory(), a.trajectory())
    assert all(r.get("pipelined") for r in b.metrics.records[1:])
    assert "pipelined" not in a.metrics.records[1]


@pytest.mark.parametrize("kw", [
    {"pipeline_depth": 1}, {"pipeline_depth": 4}, {"h2d_batch": 2},
    {"h2d_batch": 3, "pipeline_depth": 4}, {"start_index": 10},
])
def test_process_stream_options(kw, sequence, reference_run):
    """Ingestion and fetch granularity only: keyframe adoption may lag by the
    pipeline's depth, so some frames track against an older keyframe."""
    poses_gt, depths, _ = sequence
    odo = _port(kf=JKeyframeConfig(max_interval=2))
    out = list(odo.process_stream(iter(depths), **kw))
    first = kw.get("start_index", 0)
    assert [i for i, _ in out] == list(range(first, first + FRAMES))
    assert np.abs(odo.trajectory() - reference_run.trajectory()).max() < STREAM_TOL
    assert np.abs(odo.trajectory() - poses_gt).max() < TRUTH_TOL
    assert odo.keyframes[0].index == first and len(odo.keyframes) >= 2


def test_stream_with_intensity_and_device_resident_items(sequence):
    _, depths, intens = sequence
    icp = JIcpConfig(levels=2, iters_per_level=(3, 4), photometric_weight=0.5)
    a, b = _port(icp), _port(icp)
    for d, i in zip(depths, intens):
        a.process(d, intensity=i)
    # pairs, one of them already tensors on the device, batched transfers
    items = [(d, i) for d, i in zip(depths, intens)]
    items[2] = (torch.from_numpy(depths[2].copy()), torch.from_numpy(intens[2].copy()))
    out = list(b.process_stream(iter(items), h2d_batch=2))
    assert len(out) == FRAMES and len(b.keyframes[0].frame.photo) == 2
    assert np.abs(a.trajectory() - b.trajectory()).max() < STREAM_TOL
    # without intensity the same server tracks depth-only
    c = _port(icp)
    c.process(depths[0])
    assert c.keyframes[0].frame.photo == ()


def test_downscale_and_shape_check(sequence):
    _, depths, _ = sequence
    icp = JIcpConfig(levels=2, iters_per_level=(3, 4), downscale=2)
    ref = JDenseOdometry(JCAM, icp, JKeyframeConfig())
    odo = _port(icp)
    assert (odo.cam.width, odo.cam.height) == (40, 30) and odo.cam_full == CAM
    for d in depths[:3]:
        ref.process(d)
        odo.process(d)
    assert tuple(odo.keyframes[0].frame.vertices[0].shape) == (30, 40, 3)
    np.testing.assert_allclose(odo.trajectory(), ref.trajectory(), atol=POSE_ATOL)
    with pytest.raises(ValueError, match="does not match the camera"):
        odo.process(np.zeros((30, 40), np.float32))
    with pytest.raises(ValueError, match="power of 2"):
        _port(JIcpConfig(downscale=3))


def test_keyframe_and_metrics_plumbing(tmp_path, sequence):
    assert Keyframe(0, np.eye(4), None).ref_weight_value() == 0.0
    kf = Keyframe(0, np.eye(4), None, None, torch.tensor(7.0))
    assert kf.ref_weight_value() == 7.0 and isinstance(kf.ref_weight, float)
    assert _port().trajectory().shape == (0, 4, 4)
    path = tmp_path / "odo.jsonl"
    odo = DenseOdometry(CAM, config_from_reference(ICP), KeyframeConfig(),
                        metrics=MetricsLogger(str(path)), device="cpu")
    for i, d in enumerate(sequence[1][:2]):
        odo.process(d, frame_index=7 + i)
    odo.metrics.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["frame"] for r in lines] == [7, 8] and lines[0]["keyframe"] is True
    assert 0.0 < lines[1]["overlap"] <= 1.0


# --- Slam and loop closure (configuration 4's backend) on the same frames ----
# Every frame a keyframe, so that five keyframes give one loop candidate
# (keyframes 0 and 4, min_gap 3). The JAX side compiles only icp_track_batch
# (two settings, the batch padded to 4) and optimize_pose_graph anew.

SLAM_KF = JKeyframeConfig(max_interval=1)
# Config 3's finest-level stride in a two-level pyramid, with its re-association.
ICP_STRIDE4 = JIcpConfig(levels=2, iters_per_level=(3, 4), source_stride=(4, 4), reassoc_every=2)
LOOP_ATOL = 1e-3  # T_rel and overlap of a verification track: two chained ICP tracks' agreement


@pytest.fixture(scope="module")
def slam_runs(sequence):
    """Both packages' Slam over the sequence: (reference, port, trajectories)."""
    _, depths, intens = sequence
    jcfg = JPipelineConfig(icp=ICP, keyframe=SLAM_KF)
    ref = JSlam(JCAM, jcfg)
    port = Slam(CAM, config_from_reference(jcfg), device="cpu")
    for d, g in zip(depths, intens):
        ref.track(d, gray=g)
        port.track(d, gray=g)
    return ref, port, ref.optimize(), port.optimize()


def _loop_view(ref_odo, icp):
    """The reference server's keyframes as the port's, for the port's
    detect_loop_closures (which reads keyframes, cam and icp_cfg)."""
    return types.SimpleNamespace(
        keyframes=keyframes_from_reference(ref_odo.keyframes, "cpu"),
        cam=camera_from_reference(ref_odo.cam), icp_cfg=config_from_reference(icp))


def test_slam_matches_reference(sequence, slam_runs):
    poses_gt, _, _ = sequence
    ref, port, traj_ref, traj = slam_runs
    assert traj.shape == (FRAMES, 4, 4) and traj.dtype == np.float32
    np.testing.assert_allclose(traj, traj_ref, atol=1e-3)
    assert [k.index for k in port.odo.keyframes] == [k.index for k in ref.odo.keyframes]
    np.testing.assert_allclose(port.trajectory, ref.trajectory, atol=POSE_ATOL)
    # The backend closed the loop, and the result stays on the rendered poses.
    assert [(a, b) for a, b, *_ in detect_loop_closures(port.odo)] == [(0, 4)]
    assert np.abs(traj - poses_gt).max() < TRUTH_TOL


def _centers(T):
    return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])


def test_slam_bundle_adjust_waits_for_ba(sequence, slam_runs):
    """``optimize(bundle_adjust=True)`` of both packages on the same tracked
    frames (the same keyframes, the pose graph, then BA: build, prune,
    priors, 10 steps): trajectories within 1e-3, both on the rendered poses
    (ATE < 2 cm, the JAX package's own BA bound). Without the gray images
    the reference's ValueError comes first. With ``mesh=`` a mesh of one
    rank, the sharded step gives the same trajectory bit for bit."""
    poses_gt, depths, _ = sequence
    ref, port, _, _ = slam_runs
    # The on-device detector: host ORB finds no keypoint in 80x60 frames.
    ref_cfg, port_cfg = ref.cfg, port.cfg
    ref.cfg = dataclasses.replace(ref_cfg, frontend=dataclasses.replace(ref_cfg.frontend, detector="tpu"))
    port.cfg = config_from_reference(ref.cfg)
    try:
        # The reference's step jitted (it runs eagerly there): one compile.
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jschur, "ba_step", jax.jit(jschur.ba_step, static_argnums=(1,)))
            traj_ref = ref.optimize(bundle_adjust=True)
        traj = port.optimize(bundle_adjust=True)
    finally:
        ref.cfg, port.cfg = ref_cfg, port_cfg
    assert traj.shape == (FRAMES, 4, 4) and traj.dtype == np.float32
    np.testing.assert_allclose(traj, traj_ref, atol=1e-3)
    report = port.ba_report
    assert report["info"]["detector"] == "tpu"
    assert report["costs"].shape == (port.cfg.ba.outer_iters,)
    assert report["info"]["num_landmarks"] > 10
    for t in (traj, traj_ref):
        assert ate_rmse(_centers(t), _centers(poses_gt)) < 0.02
    # The sharded BA step on a mesh of one rank (a gloo group of world size
    # 1): the same collectives as a larger mesh, the same numbers.
    port.cfg = config_from_reference(
        dataclasses.replace(ref_cfg, frontend=dataclasses.replace(ref_cfg.frontend, detector="tpu")))
    try:
        mesh = make_mesh(device="cpu")
        traj_mesh = port.optimize(bundle_adjust=True, mesh=mesh)
    finally:
        port.cfg = port_cfg
        torch.distributed.destroy_process_group()
    assert np.array_equal(traj_mesh, traj)
    assert mesh.comm["all_reduce"][0] > 0
    bare = Slam(CAM, port.cfg, keep_images=False, device="cpu")
    bare.track(depths[0])
    bare.track(depths[1])
    with pytest.raises(ValueError, match="requires gray images"):
        bare.optimize(bundle_adjust=True)
    assert bare.optimize().shape == (2, 4, 4)


def test_detect_loop_closures_matches_reference(slam_runs):
    """On the reference's own keyframes (converted): the same accepted pairs,
    T_rel and overlap to 1e-3."""
    ref, _, _, _ = slam_runs
    loops_ref = jpose_graph.detect_loop_closures(ref.odo)
    loops = detect_loop_closures(_loop_view(ref.odo, ICP))
    assert [(a, b) for a, b, *_ in loops] == [(a, b) for a, b, *_ in loops_ref] == [(0, 4)]
    for (_, _, T, ov), (_, _, T_r, ov_r) in zip(loops, loops_ref):
        np.testing.assert_allclose(T, T_r, atol=LOOP_ATOL)
        assert abs(ov - ov_r) < LOOP_ATOL and ov > 0.3


def test_icp_track_batch_matches_reference(slam_runs):
    """The batch of four (pairs the reference's loop detection tracks) against
    the reference's vmapped batch, pair by pair; and each pair of the batch
    equals its own icp_track."""
    ref, _, _, _ = slam_runs
    kfs = ref.odo.keyframes
    pairs = [(0, 4), (0, 3), (1, 4), (2, 4)]
    T0 = np.stack([kfs[a].pose @ np.linalg.inv(kfs[b].pose) for a, b in pairs]).astype(np.float32)
    stack = lambda frames: jax.tree.map(lambda *xs: jax.numpy.stack(xs, 0), *frames)
    src = stack([kfs[b].frame for _, b in pairs])
    tgt = stack([kfs[a].frame for a, _ in pairs])
    T_ref, stats_ref = (np.asarray(x) for x in jdense.icp_track_batch(JCAM, ICP, T0, src, tgt))
    cfg = config_from_reference(ICP)
    args = (torch.from_numpy(T0), icp_frame_from_reference(src, "cpu"), icp_frame_from_reference(tgt, "cpu"))
    T, stats = icp_track_batch(CAM, cfg, *args)
    assert T.shape == (4, 4, 4) and stats.shape == (4, 2)
    np.testing.assert_allclose(T.numpy(), T_ref, atol=2e-4)
    np.testing.assert_allclose(stats.numpy(), stats_ref, rtol=2e-3)
    one = icp_frame_from_reference(jax.tree.map(lambda x: x[2], src), "cpu")
    T2, s2 = icp_track(CAM, cfg, args[0][2], one, icp_frame_from_reference(jax.tree.map(lambda x: x[2], tgt), "cpu"))
    assert torch.equal(T2, T[2]) and torch.equal(s2, stats[2])


def test_overlap_ratio_under_source_stride_rejects_every_loop(slam_runs):
    """A fault of the reference, ported as it is: loop acceptance divides the
    verification track's weight sum over the STRIDED sample by the
    full-resolution count of valid normals, so at config 3's finest stride of
    4 the overlap of a true loop is ~1/16, under min_overlap 0.3, and no loop
    passes, in both packages."""
    ref, _, _, _ = slam_runs
    ref.odo.icp_cfg = ICP_STRIDE4
    try:
        seen_ref = jpose_graph.detect_loop_closures(ref.odo, min_overlap=0.0)
        accepted_ref = jpose_graph.detect_loop_closures(ref.odo)
    finally:
        ref.odo.icp_cfg = ICP
    view = _loop_view(ref.odo, ICP_STRIDE4)
    seen = detect_loop_closures(view, min_overlap=0.0)
    assert [(a, b) for a, b, *_ in seen] == [(a, b) for a, b, *_ in seen_ref] == [(0, 4)]
    assert abs(seen[0][3] - seen_ref[0][3]) < LOOP_ATOL and 0.03 < seen[0][3] < 0.1
    np.testing.assert_allclose(seen[0][2], seen_ref[0][2], atol=LOOP_ATOL)
    assert detect_loop_closures(view) == accepted_ref == []
