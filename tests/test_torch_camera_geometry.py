"""core/camera.py and data/geometry.py of the PyTorch port against the JAX
package's, same numpy inputs, on the CPU.

Tolerance 1e-6 absolute (relative for values above 1) unless a test says
otherwise: both sides evaluate the same f32 formulas; XLA may contract a
multiply-add that PyTorch rounds twice. Masks and integer results are equal.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core import camera as jcam
from rgbd_pose_estimation_tpu.data import geometry as jgeo
from rgbd_pose_estimation_tpu_torch.core import camera as tcam
from rgbd_pose_estimation_tpu_torch.data import geometry as tgeo
from rgbd_pose_estimation_tpu_torch.utils.convert import camera_from_reference, to_torch

JCAM = jcam.CameraIntrinsics(80.0, 82.0, 39.5, 29.5, 80, 60)
CAM = camera_from_reference(JCAM)


def _close(out, ref, atol=1e-6, rtol=1e-6):
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == tuple(np.shape(ref))
    np.testing.assert_allclose(out, np.asarray(ref), atol=atol, rtol=rtol)


def _depth(seed, h=60, w=80, holes=0.1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 2.0 + 0.3 * np.sin(xx / 9.0) + 0.2 * np.cos(yy / 7.0) + 0.01 * rng.normal(size=(h, w))
    d[rng.uniform(size=(h, w)) < holes] = 0.0
    return d.astype(np.float32)


def test_camera_from_reference_and_scaled():
    assert CAM == tcam.CameraIntrinsics(80.0, 82.0, 39.5, 29.5, 80, 60)
    for name in ("tum_fr1", "tum_default"):
        assert camera_from_reference(getattr(jcam.CameraIntrinsics, name)()) == getattr(
            tcam.CameraIntrinsics, name)()
    # int(width * factor) truncates: 0.3 * 80 = 24.000000000000004, 0.7 * 60 = 42
    for factor in (0.5, 0.25, 0.3, 0.7, 1.0 / 3.0):
        assert camera_from_reference(JCAM.scaled(factor)) == CAM.scaled(factor)
    _close(CAM.matrix(device="cpu"), JCAM.matrix())
    assert hash(CAM) == hash(camera_from_reference(JCAM))  # frozen, hashable


def test_pixel_grid_is_u_then_v():
    grid = tcam.pixel_grid(CAM, device="cpu")
    _close(grid, jcam.pixel_grid(JCAM))
    assert grid.shape == (60, 80, 2)
    assert grid[3, 5].tolist() == [5.0, 3.0]  # (u, v) = (column, row)


def test_project_backproject():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4, 50, 3)).astype(np.float32) * np.float32(2.0)
    pts[0, :5, 2] = [0.0, -1.0, 1e-7, 1e-6, 2e-6]  # at and behind the camera plane
    uv_ref, ok_ref = jcam.project(JCAM, jnp.asarray(pts))
    uv, ok = tcam.project(CAM, to_torch(pts, "cpu"))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert np.isfinite(uv.numpy()).all()
    _close(uv, uv_ref, atol=1e-4, rtol=1e-6)  # pixels reach 1e8 where z is clamped
    depth = np.abs(pts[..., 2]) + np.float32(0.5)
    back_ref = jcam.backproject(JCAM, uv_ref, jnp.asarray(depth))
    back = tcam.backproject(CAM, to_torch(np.asarray(uv_ref), "cpu"), to_torch(depth, "cpu"))
    _close(back, back_ref, atol=1e-5, rtol=1e-5)


def test_vertex_and_normal_map():
    d = _depth(1)
    v_ref = jgeo.vertex_map(JCAM, jnp.asarray(d))
    v = tgeo.vertex_map(CAM, to_torch(d, "cpu"))
    _close(v, v_ref)
    n_ref = np.asarray(jgeo.normal_map(v_ref))
    n = tgeo.normal_map(to_torch(np.asarray(v_ref), "cpu")).numpy()
    # The same pixels are valid (holes poison their four neighbours; the
    # border rows and columns, where roll wraps around, are always invalid).
    np.testing.assert_array_equal(np.any(n != 0, -1), np.any(n_ref != 0, -1))
    assert not n[0].any() and not n[-1].any() and not n[:, 0].any() and not n[:, -1].any()
    # 1e-5: a unit normal from a cross product of f32 differences.
    np.testing.assert_allclose(n, n_ref, atol=1e-5)
    valid = np.any(n != 0, -1)
    assert valid.mean() > 0.4
    assert (np.sum(n * np.asarray(v_ref), -1)[valid] < 0).all()  # camera-facing


def _sample_points(seed):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-3.0, 1.0, size=(400, 2)).astype(np.float32)
    uv = uv * np.float32(-30.0)  # spills over every border of the 80x60 image
    uv[:8] = [[0.5, 0.5], [1.5, 2.5], [78.5, 58.5], [79.0, 59.0], [78.0, 58.0],
              [-0.5, -0.5], [79.5, 59.5], [2.5, 3.5]]  # ties: round half to even
    # Far outside int32, as the projection of a point behind the camera is.
    uv[8:12] = [[4e9, 10.0], [-4e9, 10.0], [10.0, 3e10], [5e8, -5e8]]
    return uv


@pytest.mark.parametrize("channels", [3, None])
def test_bilinear_and_nearest_sample(channels):
    rng = np.random.default_rng(2)
    shape = (60, 80) if channels is None else (60, 80, channels)
    img = rng.normal(size=shape).astype(np.float32)
    uv = _sample_points(3)
    for name in ("bilinear_sample", "nearest_sample"):
        ref, ok_ref = getattr(jgeo, name)(jnp.asarray(img), jnp.asarray(uv))
        out, ok = getattr(tgeo, name)(to_torch(img, "cpu"), to_torch(uv, "cpu"))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref), err_msg=name)
        assert 0.1 < ok.float().mean() < 0.9
        assert not ok[8:12].any()  # out-of-range casts never land inside
        # 1e-5: four products of a value of order 1 and two weights
        _close(out, ref, atol=1e-5 if name == "bilinear_sample" else 0.0, rtol=0.0)


def test_nearest_rounds_half_to_even():
    img = np.arange(60 * 80, dtype=np.float32).reshape(60, 80)
    uv = np.array([[0.5, 0.0], [1.5, 0.0], [2.5, 0.0], [0.0, 0.5], [0.0, 1.5]], np.float32)
    out, _ = tgeo.nearest_sample(to_torch(img, "cpu"), to_torch(uv, "cpu"))
    assert out.tolist() == [0.0, 2.0, 2.0, 0.0, 160.0]
    ref, _ = jgeo.nearest_sample(jnp.asarray(img), jnp.asarray(uv))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(60, 80), (61, 79)])
def test_downsamplers_and_pyramid(shape):
    d = _depth(4, *shape, holes=0.4)
    _close(tgeo.downsample_depth(to_torch(d, "cpu")), jgeo.downsample_depth(jnp.asarray(d)))
    _close(tgeo.downsample_intensity(to_torch(d, "cpu")),
           jgeo.downsample_intensity(jnp.asarray(d)))
    pyr_ref = jgeo.build_pyramid(jnp.asarray(d), 3)
    pyr = tgeo.build_pyramid(to_torch(d, "cpu"), 3)
    assert [tuple(x.shape) for x in pyr] == [tuple(x.shape) for x in pyr_ref]
    for a, b in zip(pyr, pyr_ref):
        _close(a, b)
        # a block with no valid texel stays invalid, in both
        np.testing.assert_array_equal(a.numpy() == 0, np.asarray(b) == 0)


def test_photo_map_edge_padding():
    img = np.random.default_rng(5).uniform(size=(60, 80)).astype(np.float32)
    out = tgeo.photo_map(to_torch(img, "cpu"))
    _close(out, jgeo.photo_map(jnp.asarray(img)))
    # one-sided differences at the borders
    np.testing.assert_allclose(out[:, 0, 1].numpy(), (img[:, 1] - img[:, 0]) * 0.5, atol=1e-7)
    np.testing.assert_allclose(out[-1, :, 2].numpy(), (img[-1] - img[-2]) * 0.5, atol=1e-7)
