"""The slice as a whole: the PyTorch port's 3D-3D RANSAC estimator against
the JAX package's, from the same correspondences and the same minimal sets."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.lie import se3_exp as jax_se3_exp
from rgbd_pose_estimation_tpu.ransac import engine as jengine
from rgbd_pose_estimation_tpu.ransac.prosac import sample_minimal_sets as jax_sample
from rgbd_pose_estimation_tpu.utils.config import RansacConfig as JaxRansacConfig
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ransac import engine as tengine
from rgbd_pose_estimation_tpu_torch.utils.convert import (
    config_from_reference,
    result_to_numpy,
    to_torch,
)


def _problem(seed, n=200, outlier_frac=0.4, noise=0.003):
    """The bench problem's distribution (data/synthetic.py), in numpy."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, size=(n, 3)) * [2.0, 2.0, 1.0] + [0.0, 0.0, 2.5]
    T = np.asarray(jax_se3_exp(jnp.asarray(rng.normal(size=6) * 0.5, jnp.float32)), np.float64)
    q = p @ T[:3, :3].T + T[:3, 3] + noise * rng.normal(size=(n, 3))
    out = rng.uniform(size=n) < outlier_frac
    q[out] = rng.uniform(-2, 2, size=(int(out.sum()), 3)) + [0.0, 0.0, 2.5]
    return p.astype(np.float32), q.astype(np.float32), T.astype(np.float32), ~out


def _generator(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_matches_reference_from_same_minimal_sets(seed):
    """N = 200 (so the sentinel padding to 256 is exercised), 40% outliers,
    noise 0.003, τ = 0.05, K = 512, two refit rounds. JAX draws the minimal
    sets; the port runs from those very sets.

    Pose within 2e-3: on the CPU the JAX package solves the hypotheses by
    gather + Horn(iters=12) and scores all K exactly, while the port runs
    the production branch (moments + Horn(iters=4), bf16 fast ranking,
    exact re-score of 16 finalists), so the two may enter the refit from
    different hypotheses; the repo's contract
    (test_finalist_window_adversarial) is that near-ties share one refit
    basin, to 2e-3. Inlier masks may then differ on correspondences whose
    residual sits at the threshold: at most 1% of rows. Both must be within
    0.05 of ground truth, the benchmark's own accuracy gate."""
    p, q, T_gt, _ = _problem(seed)
    jcfg = JaxRansacConfig(num_hypotheses=512, threshold=0.05, refit_rounds=2, solver="horn")
    key = jax.random.key(seed)
    ref = result_to_numpy(jengine.estimate_pose_3d3d(key, jnp.asarray(p), jnp.asarray(q), jcfg))
    idx = np.asarray(jax_sample(key, 200, 512, 3, jcfg.prosac))

    cfg = config_from_reference(jcfg)
    before = _build.launch_counts()
    res = tengine._estimate_from_samples(*to_torch((idx, p, q), "cpu"), cfg)
    assert _build.launch_counts() == before  # CPU tensors: plain versions only
    assert res.pose.dtype == torch.float32 and res.inlier_mask.dtype == torch.bool
    out = result_to_numpy(res)

    np.testing.assert_allclose(out["pose"], ref["pose"], atol=2e-3)
    assert out["inlier_mask"].shape == (200,)
    assert (out["inlier_mask"] == ref["inlier_mask"]).mean() >= 0.99
    assert abs(float(out["num_inliers"]) - float(ref["num_inliers"])) <= 2
    assert bool(out["valid"]) == bool(ref["valid"]) is True
    assert out["num_hypotheses"] == ref["num_hypotheses"] == 512
    assert np.abs(out["pose"] - T_gt).max() < 0.05
    assert np.abs(ref["pose"] - T_gt).max() < 0.05
    # The pre-refit score is an exact MSAC over the PADDED set on both sides.
    assert out["score"] >= 56 * 0.05**2 and np.isfinite(out["score"])


@pytest.mark.parametrize("solver", ["horn", "kabsch"])
def test_estimate_with_own_sampler(solver):
    p, q, T_gt, inl = _problem(2)
    cfg = tengine.RansacConfig(num_hypotheses=256, threshold=0.05, solver=solver)
    res = tengine.estimate_pose_3d3d(_generator(0), *to_torch((p, q), "cpu"), cfg)
    assert np.abs(res.pose.numpy() - T_gt).max() < 0.05
    assert bool(res.valid) and res.num_hypotheses == 256
    # Nearly every true inlier is found, and hardly any outlier.
    mask = res.inlier_mask.numpy()
    assert (mask & inl).sum() >= 0.95 * inl.sum() and (mask & ~inl).sum() <= 3


def test_all_outliers_is_invalid():
    rng = np.random.default_rng(3)
    p = rng.uniform(-2, 2, size=(128, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, size=(128, 3)).astype(np.float32)
    cfg = tengine.RansacConfig(num_hypotheses=256, threshold=0.01, min_inliers=10)
    res = tengine.estimate_pose_3d3d(_generator(1), *to_torch((p, q), "cpu"), cfg)
    assert not bool(res.valid) and np.isfinite(res.pose.numpy()).all()


def test_unknown_solver_raises():
    p, q, _, _ = _problem(4, n=32)
    with pytest.raises(ValueError, match="solver"):
        tengine.estimate_pose_3d3d(
            _generator(0), *to_torch((p, q), "cpu"), tengine.RansacConfig(solver="svd")
        )


@pytest.mark.parametrize(
    "inlier_ratio,sample_size,confidence",
    [(0.0, 3, 0.999), (1.0, 3, 0.999), (0.6, 3, 0.999), (0.3, 3, 0.99), (0.5, 4, 0.999)],
)
def test_required_hypotheses_equal(inlier_ratio, sample_size, confidence):
    assert tengine.required_hypotheses(
        inlier_ratio, sample_size, confidence
    ) == jengine.required_hypotheses(inlier_ratio, sample_size, confidence)


def test_adaptive_stops_after_probe_at_high_inlier_ratio():
    p, q, T_gt, _ = _problem(5, n=256, outlier_frac=0.1)
    cfg = tengine.RansacConfig(num_hypotheses=1024, probe_hypotheses=128, threshold=0.05)
    res = tengine.estimate_pose_3d3d_adaptive(_generator(2), *to_torch((p, q), "cpu"), cfg)
    assert res.num_hypotheses == 128  # the probe alone met the bound
    assert np.abs(res.pose.numpy() - T_gt).max() < 0.05


def test_adaptive_runs_full_round_at_low_inlier_ratio():
    p, q, T_gt, _ = _problem(6, n=256, outlier_frac=0.75)
    cfg = tengine.RansacConfig(num_hypotheses=1024, probe_hypotheses=128, threshold=0.05)
    res = tengine.estimate_pose_3d3d_adaptive(_generator(3), *to_torch((p, q), "cpu"), cfg)
    # Inlier ratio 0.25 needs ~440 samples for 0.999: the full round runs,
    # and the work metric sums both rounds.
    assert res.num_hypotheses == 128 + 1024
    assert np.abs(res.pose.numpy() - T_gt).max() < 0.05 and bool(res.valid)
