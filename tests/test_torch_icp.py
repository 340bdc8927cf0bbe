"""icp/dense.py of the PyTorch port against the JAX package's, on the CPU:
the frame pyramid, one Gauss-Newton step from the same pose, a whole track.

80x60 images, two levels, four settings in all (nearest, bilinear,
stride + re-association every 2nd iteration, photometric rows): the JAX side
compiles one track for each, so there are no more. Depth and intensity are
rendered once by the JAX package and handed to both as numpy arrays.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
from rgbd_pose_estimation_tpu.core.lie import se3_exp as jse3_exp
from rgbd_pose_estimation_tpu.data import synthetic as jsyn
from rgbd_pose_estimation_tpu.icp import dense as jdense
from rgbd_pose_estimation_tpu.utils.config import IcpConfig as JIcpConfig
from rgbd_pose_estimation_tpu_torch.icp import dense as tdense
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops.icp_jtj import icp_assoc_jtj_jtr
from rgbd_pose_estimation_tpu_torch.utils.convert import (
    camera_from_reference,
    config_from_reference,
    icp_frame_from_reference,
    to_numpy,
    to_torch,
)

# The JAX package's renderer and pyramid, jitted (the camera and the config
# are compile-time constants): one compile instead of one per primitive.
synthetic_depth_scene = jax.jit(jsyn.synthetic_depth_scene, static_argnums=0)
make_icp_frame_j = jax.jit(jdense.make_icp_frame, static_argnums=(0, 2))

JCAM = JCamera(80.0, 80.0, 39.5, 29.5, 80, 60)
CAM = camera_from_reference(JCAM)
XI = [0.01, -0.008, 0.005, 0.01, -0.012, 0.008]
BASE = JIcpConfig(levels=2, iters_per_level=(3, 4))
CONFIGS = {
    "nearest": BASE,
    "bilinear": dataclasses.replace(BASE, association="bilinear"),
    "stride_reassoc": dataclasses.replace(BASE, source_stride=(2, 2), reassoc_every=2),
    "photometric": dataclasses.replace(BASE, photometric_weight=0.5),
}


@pytest.fixture(scope="module")
def scene():
    """(depth, intensity) at identity and at exp(XI), as numpy, and exp(XI)."""
    T_gt = jse3_exp(jnp.asarray(XI, jnp.float32))
    a = [np.asarray(x) for x in synthetic_depth_scene(JCAM, jnp.eye(4))]
    b = [np.asarray(x) for x in synthetic_depth_scene(JCAM, T_gt)]
    return a, b, np.asarray(T_gt)


@pytest.fixture(scope="module")
def reference_frames(scene):
    """The JAX package's pyramids of both images, with photo maps."""
    a, b, _ = scene
    cfg = CONFIGS["photometric"]
    return tuple(
        make_icp_frame_j(JCAM, jnp.asarray(d), cfg, jnp.asarray(i)) for d, i in (a, b)
    )


def _frames_for(cfg, frames):
    """Depth-only settings track on frames without photo maps."""
    if cfg.photometric_weight > 0:
        return frames
    return tuple(f._replace(photo=()) for f in frames)


def test_make_icp_frame(scene, reference_frames):
    (depth, intensity), _, _ = scene
    depth = depth.copy()
    depth[:5, :5] = [[0.05, 7.0, 0.1, 5.0, 0.0]] * 5  # outside [min_depth, max_depth] → invalid
    cfg = CONFIGS["photometric"]
    ref = make_icp_frame_j(JCAM, jnp.asarray(depth), cfg, jnp.asarray(intensity))
    out = tdense.make_icp_frame(
        CAM, to_torch(depth, "cpu"), config_from_reference(cfg), to_torch(intensity, "cpu")
    )
    assert [tuple(v.shape) for v in out.vertices] == [(60, 80, 3), (30, 40, 3)]
    for name in ("vertices", "normals", "photo"):
        for lvl, (a, b) in enumerate(zip(getattr(out, name), getattr(ref, name))):
            # 1e-5: unit normals from cross products of f32 differences
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=f"{name}[{lvl}]")
    assert not out.vertices[0][0, 0, 2] and not out.vertices[0][0, 1, 2]
    assert out.vertices[0][0, 2, 2] > 0 and out.vertices[0][0, 3, 2] > 0
    depth_only = tdense.make_icp_frame(CAM, to_torch(depth, "cpu"), config_from_reference(cfg))
    assert depth_only.photo == ()
    # The converter carries a pyramid across unchanged.
    carried = icp_frame_from_reference(ref, "cpu")
    assert isinstance(carried, tdense.IcpFrame) and len(carried.photo) == 2
    np.testing.assert_array_equal(carried.normals[1].numpy(), np.asarray(ref.normals[1]))


def _step_pair(cfg, frames, level):
    src_j, tgt_j = _frames_for(cfg, frames)
    photo = len(src_j.photo) > 0
    args_j = [src_j.vertices[level], src_j.normals[level], tgt_j.vertices[level],
              tgt_j.normals[level], src_j.photo[level] if photo else None,
              tgt_j.photo[level] if photo else None]
    src_t, tgt_t = (icp_frame_from_reference(f, "cpu") for f in (src_j, tgt_j))
    args_t = [src_t.vertices[level], src_t.normals[level], tgt_t.vertices[level],
              tgt_t.normals[level], src_t.photo[level] if photo else None,
              tgt_t.photo[level] if photo else None]
    step_j = jdense._level_iteration(JCAM.scaled(0.5**level), cfg, *args_j, level=level)
    step_t, rows_t = tdense._level_iteration(
        CAM.scaled(0.5**level), config_from_reference(cfg), *args_t, level=level
    )
    return step_j, step_t, rows_t


def _spy(monkeypatch, module):
    """Record what the module's accumulation returns (the step keeps the
    normal equations to itself)."""
    seen = []
    inner = module.icp_jtj_jtr

    def spy(*args):
        seen.append(inner(*args))
        return seen[-1]

    monkeypatch.setattr(module, "icp_jtj_jtr", spy)
    return seen


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_step_from_the_same_pose(name, reference_frames, monkeypatch):
    """JtJ, Jtr, the statistics, the association and the new pose of one
    step at the finest level, from a pose a little off the answer. Sums over
    ~4800 rows in another order: rtol 2e-4 on the normal equations (the K4
    tolerance), 1e-5 on the pose they solve to."""
    cfg = CONFIGS[name]
    step_j, step_t, _ = _step_pair(cfg, reference_frames[::-1], level=0)
    seen_j, seen_t = _spy(monkeypatch, jdense), _spy(monkeypatch, tdense)
    T0 = np.asarray(jse3_exp(jnp.asarray([0.004, 0.0, -0.003, -0.005, 0.004, 0.0], jnp.float32)))
    T_j, stats_j, assoc_j = step_j(jnp.asarray(T0))
    T_t, stats_t, assoc_t = step_t(to_torch(T0, "cpu"))
    for a, b in zip(to_numpy(seen_t[0]), seen_j[0]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=1e-4 * max(1.0, float(np.abs(b).max())))
    np.testing.assert_allclose(stats_t.numpy(), np.asarray(stats_j), rtol=2e-4)
    assert float(stats_t[1]) > 500
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    assert np.abs(T_t.numpy() - T0).max() > 1e-3  # it did step
    if cfg.association == "nearest":
        g_t, in_t, ui_t, vi_t = to_numpy(assoc_t)
        g_j, in_j, ui_j, vi_j = (np.asarray(x) for x in assoc_j)
        np.testing.assert_array_equal(in_t, in_j)
        # a projection within rounding of a pixel boundary may land next door
        same = (ui_t == ui_j) & (vi_t == vi_j)
        assert same.mean() > 0.999
        np.testing.assert_array_equal(g_t[same], g_j[same])
        assert g_t.shape[1] == (9 if cfg.photometric_weight > 0 else 6)
        stride = cfg.source_stride[0]
        assert g_t.shape[0] == (60 // stride) * (80 // stride)
        # Reusing the association: the step minimizes again over the same rows.
        T2_j, s2_j, _ = step_j(T_j, assoc_j)
        T2_t, s2_t, again = step_t(T_t, assoc_t)
        assert again is assoc_t
        np.testing.assert_allclose(T2_t.numpy(), np.asarray(T2_j), atol=2e-5)
        np.testing.assert_allclose(s2_t.numpy(), np.asarray(s2_j), rtol=1e-3)
    else:
        assert assoc_t is None and assoc_j is None


@pytest.mark.parametrize("name", ["nearest", "stride_reassoc"])
def test_fused_step_plain_version_matches_reference(name, reference_frames, monkeypatch):
    """What the fused CUDA step is held to on the card, its plain version
    (``ops/icp_jtj.py``: the rows of ``icp_assoc_rows_reference``, then
    ``icp_jtj_jtr_reference``), against the normal equations of the JAX
    package's step: a fresh step from the pose of
    ``test_one_step_from_the_same_pose``, then a carried one from the pose
    that step reached, at the finest level, unstrided (the dense setting) and
    at stride 2 with re-association every 2nd iteration (config 3's kind).
    Tolerance as there: sums over ~4800 or ~1200 rows in another order."""
    cfg = CONFIGS[name]
    step_j, _, _ = _step_pair(cfg, reference_frames[::-1], level=0)
    seen_j = _spy(monkeypatch, jdense)
    src_j, tgt_j = _frames_for(cfg, reference_frames[::-1])
    src, tgt = (icp_frame_from_reference(f, "cpu") for f in (src_j, tgt_j))
    accumulate = icp_assoc_jtj_jtr(
        src.vertices[0], src.normals[0], tgt.vertices[0], tgt.normals[0], cfg.source_stride[0],
        (CAM.fx, CAM.fy, CAM.cx, CAM.cy), (cfg.dist_threshold, cfg.normal_threshold, cfg.huber_delta))
    T0 = np.asarray(jse3_exp(jnp.asarray([0.004, 0.0, -0.003, -0.005, 0.004, 0.0], jnp.float32)))
    before = _build.launch_counts()
    T_j, _, assoc_j = step_j(jnp.asarray(T0))
    *fresh, assoc = accumulate(to_torch(T0, "cpu"))
    step_j(T_j, assoc_j)
    *carried, again = accumulate(to_torch(np.asarray(T_j), "cpu"), assoc)
    assert again is assoc and assoc[0].shape[0] == (60 // cfg.source_stride[0]) * (80 // cfg.source_stride[0])
    assert _build.launch_counts() == before  # CPU tensors: the plain version, no launch
    for out, ref in ((fresh, seen_j[0]), (carried, seen_j[1])):
        for a, b in zip(to_numpy(out), ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=1e-4 * max(1.0, float(np.abs(b).max())))
        assert float(out[3]) > 500


@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_track(name, scene, reference_frames):
    """depth → pyramid → icp_track, each package by its own means. The pose
    within 5e-5 (iterates that differ by rounding flip a few nearest-pixel
    associations on the way), both within the bench's gate of the truth."""
    (da, ia), (db, ib), T_gt = scene
    cfg = CONFIGS[name]
    src_j, tgt_j = _frames_for(cfg, reference_frames[::-1])
    T_j, stats_j = jdense.icp_track(JCAM, cfg, jnp.eye(4), src_j, tgt_j)
    tcfg = config_from_reference(cfg)
    photo = cfg.photometric_weight > 0
    src_t = tdense.make_icp_frame(CAM, to_torch(db, "cpu"), tcfg, to_torch(ib, "cpu") if photo else None)
    tgt_t = tdense.make_icp_frame(CAM, to_torch(da, "cpu"), tcfg, to_torch(ia, "cpu") if photo else None)
    T_t, stats_t = tdense.icp_track(CAM, tcfg, torch.eye(4), src_t, tgt_t)
    assert T_t.dtype == torch.float32 and stats_t.shape == (2,)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=5e-5)
    np.testing.assert_allclose(stats_t.numpy(), np.asarray(stats_j), rtol=5e-3)
    assert np.abs(T_t.numpy() @ T_gt - np.eye(4)).max() < 0.05
    # Two runs agree to the last bit.
    again, _ = tdense.icp_track(CAM, tcfg, torch.eye(4), src_t, tgt_t)
    assert torch.equal(T_t, again)


@pytest.mark.parametrize("name", ["nearest", "bilinear"])
def test_points_behind_the_camera(name, reference_frames):
    """Pushed 2.4 m back, half the source lands at z <= 0 and projects up to
    ~1e8 pixels out, beyond int32. The port clamps before the cast, so what
    is in bounds, the statistics and the step agree with the JAX package,
    whose casts saturate."""
    step_j, step_t, rows_t = _step_pair(CONFIGS[name], reference_frames[::-1], level=0)
    T0 = np.eye(4, dtype=np.float32)
    T0[2, 3] = -2.4
    T_j, stats_j, assoc_j = step_j(jnp.asarray(T0))
    T_t, stats_t, assoc_t = step_t(to_torch(T0, "cpu"))
    (p, _, _, w), _, _ = rows_t(to_torch(T0, "cpu"))
    behind = p[:, 2] <= 0
    assert 0.2 < behind.float().mean() < 0.9 and not w[behind].any()
    assert torch.isfinite(T_t).all() and torch.isfinite(stats_t).all()
    np.testing.assert_allclose(stats_t.numpy(), np.asarray(stats_j), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    if name == "nearest":
        np.testing.assert_array_equal(assoc_t[1].numpy(), np.asarray(assoc_j[1]))
        assert not assoc_t[1][behind].all()


def test_short_source_stride_falls_back_to_one_silently(reference_frames):
    """A fault of the reference, ported as it is: ``source_stride`` shorter
    than ``levels`` gives the missing levels stride 1 without a word."""
    cfg = dataclasses.replace(BASE, source_stride=(2,))
    for level, rows in ((0, 30 * 40), (1, 30 * 40)):  # level 1 is 30x40, unstrided
        step_j, step_t, _ = _step_pair(cfg, reference_frames, level)
        _, _, assoc_j = step_j(jnp.eye(4))
        _, _, assoc_t = step_t(torch.eye(4))
        assert assoc_t[0].shape[0] == assoc_j[0].shape[0] == rows


def test_short_iters_per_level_raises_index_error(reference_frames):
    """A fault of the reference, ported as it is: ``iters_per_level`` shorter
    than ``levels`` is an IndexError at the coarsest level, not a message."""
    cfg = dataclasses.replace(BASE, iters_per_level=(3,))
    src_j, tgt_j = _frames_for(cfg, reference_frames)
    with pytest.raises(IndexError):
        jdense.icp_track(JCAM, cfg, jnp.eye(4), src_j, tgt_j)
    src_t, tgt_t = (icp_frame_from_reference(f, "cpu") for f in (src_j, tgt_j))
    with pytest.raises(IndexError):
        tdense.icp_track(CAM, config_from_reference(cfg), torch.eye(4), src_t, tgt_t)


def test_photometric_needs_nearest_association(reference_frames):
    cfg = config_from_reference(dataclasses.replace(BASE, photometric_weight=0.5, association="bilinear"))
    src, tgt = (icp_frame_from_reference(f, "cpu") for f in reference_frames)
    with pytest.raises(NotImplementedError):
        tdense.icp_track(CAM, cfg, torch.eye(4), src, tgt)


def test_no_overlap_takes_no_step(reference_frames):
    """Fewer than 50 associated rows: the pose stays where it was, by a
    ``where`` on the device, in both packages."""
    step_j, step_t, _ = _step_pair(BASE, reference_frames, level=0)
    T0 = np.eye(4, dtype=np.float32)
    T0[0, 3] = 5.0
    T_j, stats_j, _ = step_j(jnp.asarray(T0))
    T_t, stats_t, _ = step_t(to_torch(T0, "cpu"))
    assert float(stats_t[1]) == float(stats_j[1]) == 0.0
    np.testing.assert_array_equal(T_t.numpy(), T0)
    np.testing.assert_array_equal(np.asarray(T_j), T0)
