"""solvers/normals.py and the point+normal RANSAC estimator of the PyTorch
port against the JAX package's, from the same numpy-made inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.lie import se3_exp as jax_se3_exp
from rgbd_pose_estimation_tpu.ransac import engine as jengine
from rgbd_pose_estimation_tpu.ransac.prosac import sample_minimal_sets as jax_sample
from rgbd_pose_estimation_tpu.solvers import normals as jnormals
from rgbd_pose_estimation_tpu.utils.config import RansacConfig as JaxRansacConfig
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ransac import engine as tengine
from rgbd_pose_estimation_tpu_torch.solvers import normals as tnormals
from rgbd_pose_estimation_tpu_torch.utils.convert import (
    config_from_reference,
    result_to_numpy,
    to_torch,
)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _pose(rng, scale=0.5, batch=()):
    xi = jnp.asarray(rng.normal(size=batch + (6,)) * scale, jnp.float32)
    return np.asarray(jax_se3_exp(xi)).astype(np.float64)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return to_torch(list(arrays), "cpu")


def _pairs(seed, b, m):
    """b problems of m point+normal correspondences under b poses, f32."""
    rng = np.random.default_rng(seed)
    T = _pose(rng, batch=(b,))
    p = rng.normal(size=(b, m, 3))
    n_p = _unit(rng.normal(size=(b, m, 3)))
    q = np.einsum("bij,bmj->bmi", T[:, :3, :3], p) + T[:, None, :3, 3]
    n_q = np.einsum("bij,bmj->bmi", T[:, :3, :3], n_p)
    return [x.astype(np.float32) for x in (T, p, q, n_p, n_q)]


def test_ao_2pt_normals_matches_reference_and_truth():
    """256 exact two-correspondence samples: the pose of the JAX package to
    1e-5 (the same component-wise Horn arithmetic), the true pose to 1e-4, and
    a rotation that is orthonormal to 1e-5, as the fast scorer's quadratic
    form assumes."""
    T, p, q, n_p, n_q = _pairs(0, 256, 2)
    ref = np.asarray(jnormals.ao_2pt_normals(*_j(p, q, n_p, n_q)))
    out = tnormals.ao_2pt_normals(*_t(p, q, n_p, n_q))
    assert out.shape == (256, 4, 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), T, atol=1e-4)
    R = out.numpy()[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_procrustes_rotation_weighted_matches_reference():
    rng = np.random.default_rng(1)
    R_gt = _pose(rng, batch=(32,))[:, :3, :3]
    vp = _unit(rng.normal(size=(32, 6, 3)))
    vq = np.einsum("bij,bmj->bmi", R_gt, vp)
    vq[:, 0] = _unit(rng.normal(size=(32, 3)))  # one bad direction, weight 0
    w = np.ones((32, 6))
    w[:, 0] = 0.0
    vp, vq, w = (x.astype(np.float32) for x in (vp, vq, w))
    ref = np.asarray(jnormals.procrustes_rotation(*_j(vp, vq, w)))
    out = tnormals.procrustes_rotation(*_t(vp, vq, w)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, R_gt, atol=1e-4)


@pytest.mark.parametrize("num_yaw", [8, 5])
def test_ao_1pt_normal_fan_matches_reference(num_yaw):
    """The yaw fan from one correspondence, 1e-5 against the JAX package,
    with the antiparallel fallbacks among the inputs: n_q = −n_p, and n_p
    along x (where the first fallback axis degenerates and the second takes
    over). Every hypothesis maps p to q and n_p to n_q; yaw 0 of an exact
    sample with parallel normals is the minimal rotation."""
    T, p, q, n_p, n_q = (x[:, 0] for x in _pairs(2, 64, 1))
    n_q = n_q.copy()
    n_p = n_p.copy()
    n_q[1] = -n_p[1]
    n_p[2] = [1.0, 0.0, 0.0]
    n_q[2] = [-1.0, 0.0, 0.0]
    n_p[3] = n_q[3]  # parallel: zero rotation
    ref = np.asarray(jnormals.ao_1pt_normal_fan(*_j(p, q, n_p, n_q), num_yaw=num_yaw))
    out = tnormals.ao_1pt_normal_fan(*_t(p, q, n_p, n_q), num_yaw=num_yaw).numpy()
    assert out.shape == (64, num_yaw, 4, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    R, t = out[..., :3, :3], out[..., :3, 3]
    np.testing.assert_allclose(np.einsum("byij,bj->byi", R, p) + t, np.broadcast_to(q[:, None], t.shape), atol=1e-5)
    np.testing.assert_allclose(np.einsum("byij,bj->byi", R, n_p), np.broadcast_to(n_q[:, None], t.shape), atol=1e-5)
    np.testing.assert_allclose(R[3, 0], np.eye(3), atol=1e-6)


def _normals_problem(seed, n=300, outlier_frac=0.7):
    """The problem of tests/unit/test_ransac.py::TestRansacNormals in numpy."""
    rng = np.random.default_rng(seed)
    T = _pose(rng)
    p = rng.normal(size=(n, 3))
    n_p = _unit(rng.normal(size=(n, 3)))
    q = p @ T[:3, :3].T + T[:3, 3]
    n_q = n_p @ T[:3, :3].T
    out = rng.uniform(size=n) < outlier_frac
    q[out] = rng.uniform(-2, 2, size=(int(out.sum()), 3))
    n_q[out] = _unit(rng.normal(size=(int(out.sum()), 3)))
    return [x.astype(np.float32) for x in (p, q, n_p, n_q, T)] + [~out]


def test_normals_estimator_matches_reference_from_same_samples():
    """N = 300 (padded to 384), 70% outliers, τ = 0.05, K = 512 two-point
    samples, two refit rounds; JAX draws the samples, the port runs from
    those very pairs. The post-refit contract of the 3D-3D estimator
    (tests/test_torch_engine.py): on the CPU the JAX package scores all K
    exactly while the port ranks with bf16-rounded operands and re-scores 16
    finalists, so the two may enter the refit from different near-tied
    hypotheses, which share one refit basin: pose within 2e-3, inlier masks
    agreeing on at least 99% of the rows, both within 0.02 of the truth (the
    JAX test's bound). Same refit code as ``estimate_pose_3d3d``, so no
    kernel is launched on CPU tensors."""
    p, q, n_p, n_q, T_gt, _ = _normals_problem(0)
    jcfg = JaxRansacConfig(num_hypotheses=512, threshold=0.05, sample_size=2)
    key = jax.random.key(1)
    ref = result_to_numpy(jengine.estimate_pose_3d3d_normals(key, *_j(p, q, n_p, n_q), jcfg))
    idx = np.asarray(jax_sample(key, 300, 512, 2, jcfg.prosac))
    assert idx.shape == (512, 2)

    before = _build.launch_counts()
    res = tengine._estimate_3d3d_normals_from_samples(
        *_t(idx, p, q, n_p, n_q), config_from_reference(jcfg)
    )
    assert _build.launch_counts() == before
    out = result_to_numpy(res)
    np.testing.assert_allclose(out["pose"], ref["pose"], atol=2e-3)
    assert (out["inlier_mask"] == ref["inlier_mask"]).mean() >= 0.99
    assert abs(float(out["num_inliers"]) - float(ref["num_inliers"])) <= 2
    assert bool(out["valid"]) == bool(ref["valid"]) is True
    assert out["num_hypotheses"] == ref["num_hypotheses"] == 512
    assert np.abs(out["pose"] - T_gt).max() < 0.02
    assert np.abs(ref["pose"] - T_gt).max() < 0.02
    assert out["score"] >= 84 * 0.05**2 and np.isfinite(out["score"])


def test_normals_estimator_with_own_sampler():
    p, q, n_p, n_q, T_gt, inl = _normals_problem(1)
    cfg = tengine.RansacConfig(num_hypotheses=512, threshold=0.05, sample_size=2)
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    res = tengine.estimate_pose_3d3d_normals(g, *_t(p, q, n_p, n_q), cfg)
    assert bool(res.valid) and res.num_hypotheses == 512
    assert np.abs(res.pose.numpy() - T_gt).max() < 0.02
    mask = res.inlier_mask.numpy()
    assert (mask & inl).sum() >= 0.95 * inl.sum() and (mask & ~inl).sum() <= 3
