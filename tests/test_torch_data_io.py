"""The port's data readers and host utilities against the JAX package's, on
the CPU: TUM and raw ICL-NUIM directories written by either package and read
by both, the standard-library PNG codec against the native decoder, the
prefetcher, the odometry checkpoint, the timer.

The reference's writers render through the JAX package's renderer, jitted
here once for the 80x60 camera (its writers call it eagerly otherwise); they
encode with OpenCV (the file is skipped where ``cv2`` is missing).
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.data import icl_nuim as jicl
from rgbd_pose_estimation_tpu.data import native_loader as jnative
from rgbd_pose_estimation_tpu.data import synthetic as jsyn
from rgbd_pose_estimation_tpu.data import tum as jtum
from rgbd_pose_estimation_tpu.utils import checkpoint as jcheckpoint
from rgbd_pose_estimation_tpu_torch.data import icl_nuim, native_loader, png, tum
from rgbd_pose_estimation_tpu_torch.data.prefetch import sequence_prefetcher
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry
from rgbd_pose_estimation_tpu_torch.utils import checkpoint
from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig, KeyframeConfig
from rgbd_pose_estimation_tpu_torch.utils.timing import Timer, trace_context

cv2 = pytest.importorskip("cv2")

SIZE = (80, 60)
FRAMES = 4


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """TUM and raw-ICL directories written by each package."""
    root = tmp_path_factory.mktemp("data")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsyn, "synthetic_sequence", jax.jit(jsyn.synthetic_sequence, static_argnums=(0, 2)))
        jtum.write_synthetic_tum(str(root / "ref_tum"), n_frames=FRAMES, size=SIZE)
        jicl.write_synthetic_icl(str(root / "ref_icl"), n_frames=FRAMES, size=SIZE)
    cam = tum.write_synthetic_tum(str(root / "port_tum"), n_frames=FRAMES, size=SIZE, seed=3, device="cpu")
    icl_nuim.write_synthetic_icl(str(root / "port_icl"), n_frames=FRAMES, size=SIZE, seed=3, device="cpu")
    return {name: str(root / name) for name in ("ref_tum", "ref_icl", "port_tum", "port_icl")}, cam


def _assert_same_sequence(seq, ref):
    assert len(seq) == len(ref) == FRAMES
    assert np.array_equal(seq.timestamps, ref.timestamps)
    for i in range(len(seq)):
        (ts, g, d), (ts_r, g_r, d_r) = seq.frame(i), ref.frame(i)
        assert ts == ts_r and g.dtype == d.dtype == np.float32
        assert np.array_equal(g, g_r) and np.array_equal(d, d_r)
    (ia, gt), (ia_r, gt_r) = seq.groundtruth_aligned(), ref.groundtruth_aligned()
    assert np.array_equal(ia, ia_r) and len(ia) == FRAMES
    np.testing.assert_allclose(gt, gt_r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["ref_tum", "port_tum"])
def test_tum_round_trip_between_packages(dirs, writer):
    """A TUM directory of either package's writer reads bit-equal in both."""
    paths, _ = dirs
    _assert_same_sequence(tum.TumSequence(paths[writer]), jtum.TumSequence(paths[writer]))


def test_port_writer_stores_the_quantised_render(dirs):
    paths, cam = dirs
    seq = tum.TumSequence(paths["port_tum"])
    poses, depths, intens = tum.render_synthetic(cam, FRAMES, 0.01, 3, device="cpu")
    for i in range(FRAMES):
        _, g, d = seq.frame(i)
        assert np.array_equal(g, tum.quantize_gray8(intens[i]).astype(np.float32) / 255.0)
        assert np.array_equal(d, tum.quantize_depth16(depths[i]).astype(np.float32) * seq.depth_scale)
    np.testing.assert_allclose(seq.groundtruth_aligned()[1], poses.numpy(), atol=2e-6)
    with open(os.path.join(paths["port_tum"], "intrinsics.txt")) as f:
        assert [float(v) for v in f.read().split()] == [80.0, 80.0, 39.5, 29.5, 80.0, 60.0]


def test_stdlib_codec_equals_native_decoder(dirs, tmp_path):
    """Every file both writers made, and OpenCV's filtered 8/16-bit gray,
    RGB and RGBA images of noise: the stdlib codec decodes them as the
    native library does, luma weights included."""
    assert native_loader.native_available() and native_loader.decoder_name() == "native"
    paths, _ = dirs
    rng = np.random.default_rng(0)
    images = {
        "gray16": rng.integers(0, 65535, (33, 47), dtype=np.uint16),
        "gray8": rng.integers(0, 255, (33, 47), dtype=np.uint8),
        "bgr8": rng.integers(0, 255, (33, 47, 3), dtype=np.uint8),
        "bgra8": rng.integers(0, 255, (33, 47, 4), dtype=np.uint8),
    }
    files = []
    for name, img in images.items():
        files.append(str(tmp_path / f"{name}.png"))
        cv2.imwrite(files[-1], img)
        assert np.array_equal(png.read_png(files[-1]), img if img.ndim == 2 else img[..., [2, 1, 0, 3][: img.shape[2]]])
    for d in (paths["ref_tum"], paths["port_tum"]):
        files += [os.path.join(d, sub, f) for sub in ("rgb", "depth") for f in sorted(os.listdir(os.path.join(d, sub)))]
    for f in files:
        img = png.read_png(f)
        assert np.array_equal(png.to_gray8(img), jnative.decode_gray8(f)), f
        if img.dtype == np.uint16:
            assert np.array_equal(img, native_loader.decode_depth16(f))
    for img in (images["gray16"], images["gray8"], images["bgr8"][..., ::-1]):
        assert np.array_equal(png.decode_png_bytes(png.encode_png(img)), img)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png_bytes(b"GIF89a" + bytes(16))


@pytest.mark.parametrize("writer", ["ref_icl", "port_icl"])
def test_icl_raw_directory_reads_equal_in_both_packages(dirs, tmp_path, writer):
    """Raw ICL (ray-length text depth, PNG colour, .gt.freiburg) of either
    writer reads equal in both, upright and with fy < 0 (the y-flipped raw
    release)."""
    paths, _ = dirs
    seq, ref = icl_nuim.open_sequence(paths[writer]), jicl.open_sequence(paths[writer])
    assert isinstance(seq, icl_nuim.IclNuimSequence) and seq.cam.fy > 0
    _assert_same_sequence(seq, ref)
    d = seq.frame(1)[2]
    assert d.shape == (SIZE[1], SIZE[0]) and 0.5 < float(np.median(d[d > 0])) < 10.0
    flipped = str(tmp_path / "flipped")
    shutil.copytree(paths[writer], flipped)
    c = seq.cam
    with open(os.path.join(flipped, "intrinsics.txt"), "w") as f:
        f.write(f"{c.fx} {-c.fy} {c.cx} {c.cy} {c.width} {c.height}\n")
    seq_f, ref_f = icl_nuim.IclNuimSequence(flipped), jicl.IclNuimSequence(flipped)
    assert seq_f.cam == c
    _assert_same_sequence(seq_f, ref_f)
    assert np.array_equal(seq_f.frame(1)[1], seq.frame(1)[1][::-1])
    assert isinstance(icl_nuim.open_sequence(paths["port_tum"]), tum.TumSequence)
    assert icl_nuim.icl_nuim_intrinsics(raw=True).fy == -icl_nuim.icl_nuim_intrinsics().fy == -480.0


def test_sequence_prefetcher_yields_the_frames_in_order(dirs):
    """Native decode pool, Python fallback, and depth shipped ahead to the
    device: each yields what ``frame(i)`` yields, in order."""
    paths, _ = dirs
    for seq, start in ((tum.TumSequence(paths["port_tum"]), 0), (tum.TumSequence(paths["ref_tum"]), 1),
                       (icl_nuim.IclNuimSequence(paths["port_icl"]), 0)):
        n = len(seq) - start
        got = list(sequence_prefetcher(seq, start, n))
        shipped = list(sequence_prefetcher(seq, start, n, device_depth=True, device="cpu"))
        assert len(got) == len(shipped) == n
        for k in range(n):
            ts, g, d = seq.frame(start + k)
            assert got[k][0] == shipped[k][0] == ts
            assert np.array_equal(got[k][1], g) and np.array_equal(shipped[k][1], g)
            assert np.array_equal(got[k][2], d)
            dev = shipped[k][2]
            assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
            if dev.dtype == torch.uint16:  # raw units from the native pool
                dev = (dev.to(torch.int32).numpy().astype(np.float32) * seq.depth_scale)
            assert np.array_equal(np.asarray(dev), d)


def test_odometry_checkpoint_round_trip(dirs, tmp_path):
    """Track three frames, checkpoint, restore into a fresh server (pyramids
    rebuilt from the sequence): the same state, and the next frame tracks to
    the same pose. The file has the reference's keys and contents."""
    paths, cam = dirs
    seq = tum.TumSequence(paths["port_tum"])
    icp, kf = IcpConfig(levels=2, iters_per_level=(3, 4)), KeyframeConfig(max_interval=2)
    odo = DenseOdometry(cam, icp, kf, device="cpu")
    for i in range(3):
        odo.process(seq.frame(i)[2])
    path = str(tmp_path / "odo.npz")
    checkpoint.save_odometry_checkpoint(path, odo, 3)
    fresh = DenseOdometry(cam, icp, kf, device="cpu")
    assert checkpoint.load_odometry_checkpoint(str(tmp_path / "none.npz"), fresh, seq) == 0
    assert checkpoint.load_odometry_checkpoint(path, fresh, seq) == 3
    np.testing.assert_array_equal(fresh.trajectory(), odo.trajectory())
    assert [k.index for k in fresh.keyframes] == [k.index for k in odo.keyframes] == [0, 2]
    for a, b in zip(fresh.keyframes, odo.keyframes):
        assert np.array_equal(a.pose, b.pose) and torch.equal(a.frame.vertices[0], b.frame.vertices[0])
    assert [e[:2] for e in fresh.odom_edges] == [e[:2] for e in odo.odom_edges]
    np.testing.assert_array_equal(fresh._last_rel, odo._last_rel)
    np.testing.assert_array_equal(fresh.process(seq.frame(3)[2]), odo.process(seq.frame(3)[2]))
    view = types.SimpleNamespace(poses=odo.poses[:3], keyframes=odo.keyframes[:2],
                                 odom_edges=odo.odom_edges[:1], _last_rel=np.eye(4, dtype=np.float32))
    ref_path = str(tmp_path / "ref.npz")
    jcheckpoint.save_odometry_checkpoint(ref_path, view, 3)
    checkpoint.save_odometry_checkpoint(path, view, 3)
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key


def test_timer_and_trace_context(tmp_path):
    timer = Timer()
    with timer.phase("a", sync_on=torch.zeros(1)):
        pass
    with timer.phase("a", sync_on="cpu"):
        pass
    assert len(timer.times["a"]) == 2 and timer.mean_ms("a") >= 0.0 and timer.mean_ms("b") == 0.0
    off = Timer(enabled=False)
    with off.phase("a"):
        pass
    assert off.times == {}
    with trace_context(None):
        pass
    with trace_context(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
