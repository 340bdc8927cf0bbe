"""The 2D-3D scorer of the PyTorch port (ops/ransac_score.py) against the
JAX package's: its jnp twin and its Pallas kernel run by the interpreter.
On CPU tensors the port's wrapper runs its plain version, which is what
these tests reach; the CUDA kernel is held against that plain version on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.lie import se3_exp as jax_se3_exp
from rgbd_pose_estimation_tpu.ops import ransac_score as jscore
from rgbd_pose_estimation_tpu.ransac.engine import pad_points_obs_2d3d as jax_pad
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops import ransac_score as tscore
from rgbd_pose_estimation_tpu_torch.ransac.engine import pad_points_obs_2d3d
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch

TAU = 0.02


def _problem(k, n, seed=0):
    """K poses near a true camera 4 units in front of N points; the first
    quarter of the observations are exact under pose 0 (e = 0), the rest
    random, and points 5-8 lie behind every camera."""
    rng = np.random.default_rng(seed)
    T = np.asarray(
        jax_se3_exp(jnp.asarray(rng.normal(size=(k, 6)) * 0.05, jnp.float32))
    ).copy()
    T[:, 2, 3] += 4.0
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[5:9, 2] = -6.0
    Xc = pts @ T[0, :3, :3].T + T[0, :3, 3]
    obs = (rng.normal(size=(n, 2)) * 0.3).astype(np.float32)
    obs[: n // 4] = (Xc[:, :2] / Xc[:, 2:3])[: n // 4]
    return T, pts, obs


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return to_torch(list(arrays), "cpu")


def _assert_scores_agree(out, ref, n, flips=1):
    """Scores within 1e-4 relative plus ``flips``·τ², counts within ``flips``
    rows: the sums run over n f32 terms in another order (the JAX package's
    own bound for its kernel is rtol 1e-4, tests/kernels/test_ransac_score.py),
    and the projection is rounded differently (a division here, a reciprocal
    and a product in the Pallas kernel), so an error that sits at τ² within
    one ulp may change side: that moves the count by one row and the score by
    nothing (the term is τ² on either side)."""
    (m_out, c_out), (m_ref, c_ref) = out, ref
    m_out, c_out = m_out.numpy(), c_out.numpy()
    assert m_out.shape == c_out.shape == np.asarray(m_ref).shape
    np.testing.assert_allclose(m_out, np.asarray(m_ref), rtol=1e-4, atol=1e-6)
    assert np.abs(c_out - np.asarray(c_ref)).max() <= flips
    assert (c_out != np.asarray(c_ref)).mean() <= 0.01
    assert m_out.max() <= n * TAU * TAU * (1 + 1e-6)


@pytest.mark.parametrize("packed", [False, True], ids=["matrix", "packed"])
def test_matches_pallas_kernel_interpreted_and_jnp_twin(packed):
    """256 poses × 128 pairs, the smallest shape the Pallas kernel tiles:
    the port's plain version against the kernel under the interpreter and
    against the jnp twin, from ``(K, 4, 4)`` and from packed ``(K, 12)``."""
    T, pts, obs = _problem(256, 128)
    poses_j = jscore.pack_poses(jnp.asarray(T)) if packed else jnp.asarray(T)
    poses_t = tscore.pack_poses(to_torch(T, "cpu")) if packed else to_torch(T, "cpu")
    assert poses_t.shape == ((256, 12) if packed else (256, 4, 4))
    before = _build.launch_counts()
    out = tscore.score_poses_2d3d(poses_t, *_t(pts, obs), TAU)
    assert _build.launch_counts() == before  # CPU tensors: the plain version only
    assert out[0].dtype == out[1].dtype == torch.float32
    pallas = jscore.score_poses_2d3d(poses_j, *_j(pts, obs), TAU, impl="interpret")
    twin = jscore.score_poses_2d3d_reference(poses_j, *_j(pts, obs), TAU)
    _assert_scores_agree(out, pallas, 128)
    _assert_scores_agree(out, twin, 128)
    # Pose 0 explains the exact quarter: those 32 rows less the four behind.
    assert float(out[1][0]) >= 28 and float(out[1][0]) == float(twin[1][0])
    # Packed and matrix input are the same function, to the bit.
    other = tscore.score_poses_2d3d_reference(to_torch(T, "cpu"), *_t(pts, obs), TAU)
    np.testing.assert_array_equal(out[0].numpy(), other[0].numpy())
    np.testing.assert_array_equal(out[1].numpy(), other[1].numpy())


def test_any_shape_matches_jnp_twin():
    """K = 100, N = 77 tile nothing (the JAX wrapper itself falls back to its
    twin there); K = 1, N = 1 is the smallest problem."""
    T, pts, obs = _problem(100, 77, seed=1)
    ref = jscore.score_poses_2d3d_reference(*_j(T, pts, obs), TAU)
    _assert_scores_agree(tscore.score_poses_2d3d(*_t(T, pts, obs), TAU), ref, 77)
    one = tscore.score_poses_2d3d(*_t(T[:1], pts[:1], obs[:1]), TAU)
    assert one[0].shape == (1,) and float(one[1]) == 1.0 and float(one[0]) < 1e-12


def test_nan_pose_scores_nan_and_counts_nothing():
    """A degenerate minimal sample gives a NaN pose: its score is NaN (the
    clamp propagates it; the engine masks it) and its count 0, in both
    packages; the other poses are untouched."""
    T, pts, obs = _problem(256, 128, seed=2)
    clean = tscore.score_poses_2d3d(*_t(T, pts, obs), TAU)
    T[9] = np.nan
    T[17, 0, 3] = np.nan  # one NaN entry is enough
    m_ref, c_ref = jscore.score_poses_2d3d(*_j(T, pts, obs), TAU, impl="interpret")
    m, c = tscore.score_poses_2d3d(*_t(T, pts, obs), TAU)
    assert np.isnan(m.numpy()[[9, 17]]).all() and np.isnan(np.asarray(m_ref)[[9, 17]]).all()
    assert float(c[9]) == 0.0 == float(c_ref[9])
    keep = np.ones(256, bool)
    keep[[9, 17]] = False
    np.testing.assert_array_equal(m.numpy()[keep], clean[0].numpy()[keep])
    np.testing.assert_array_equal(c.numpy()[keep], clean[1].numpy()[keep])


def test_behind_camera_is_outlier():
    """Every point behind the camera (depth < 1e-6): each adds exactly τ² to
    the score and nothing to the count, even where its projection would hit
    the observation (TestScore2D3D.test_behind_camera_is_outlier)."""
    T = np.broadcast_to(np.eye(4, dtype=np.float32), (256, 4, 4)).copy()
    pts = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (128, 1))
    pts[64:, 2] = 0.0  # depth 0 is behind too
    obs = np.zeros((128, 2), np.float32)
    m, c = tscore.score_poses_2d3d(*_t(T, pts, obs), 0.1)
    m_ref, c_ref = jscore.score_poses_2d3d(*_j(T, pts, obs), 0.1, impl="interpret")
    assert float(c.max()) == 0.0 == float(c_ref.max())
    np.testing.assert_allclose(m.numpy(), np.full(256, 128 * 0.01, np.float32), rtol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-6)


@pytest.mark.parametrize("pad", [28, 156])
def test_pad_rows_equal_and_never_inliers(pad):
    """The sentinel rows of ``pad_points_obs_2d3d`` are the JAX package's
    bit for bit, lie behind every plausible camera, and so add exactly
    pad·τ² to every score and nothing to any count."""
    T, pts, obs = _problem(64, 100, seed=3)
    pp, oo = pad_points_obs_2d3d(*_t(pts, obs), 100 + pad)
    jp, jo = jax_pad(*_j(pts, obs), 100 + pad)
    assert pp.shape == (100 + pad, 3) and oo.shape == (100 + pad, 2)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(oo.numpy(), np.asarray(jo))
    m0, c0 = tscore.score_poses_2d3d(*_t(T, pts, obs), TAU)
    m1, c1 = tscore.score_poses_2d3d(to_torch(T, "cpu"), pp, oo, TAU)
    np.testing.assert_allclose(m1.numpy(), m0.numpy() + np.float32(pad * TAU * TAU), rtol=1e-5)
    np.testing.assert_array_equal(c1.numpy(), c0.numpy())
    # No padding asked for: the inputs come back as they are.
    same = pad_points_obs_2d3d(*_t(pts, obs), 100)
    assert same[0].shape == (100, 3) and same[1].shape == (100, 2)


def test_exported_beside_the_other_scorers():
    from rgbd_pose_estimation_tpu import ops as jops
    from rgbd_pose_estimation_tpu_torch import ops as tops

    assert set(jops.__all__) == set(tops.__all__)
    assert tops.score_poses_2d3d is tscore.score_poses_2d3d
    assert "score_poses_2d3d" in _build.launch_counts()
