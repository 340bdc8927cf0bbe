"""The 2D-3D (P3P) RANSAC estimator of the PyTorch port against the JAX
package's, from the same correspondences and the same minimal sets.

JAX compiles ``estimate_pose_2d3d`` afresh for every ``(cfg, refine_iters,
N)``: this file uses four such signatures in all (K = 512 and its K = 64
probe, at N = 300 and at N = 512), each once, through module-scoped fixtures.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import dataclasses

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

# One configuration for every JAX call of this file.
JCFG = JaxRansacConfig(num_hypotheses=512, probe_hypotheses=64, threshold=0.01)
CFG = config_from_reference(JCFG)
N = 300


def _problem(seed, n=N, outlier_frac=0.3, noise=0.0):
    """The problem of tests/unit/test_ransac.py::TestRansac2D3D, in numpy: a
    camera about 4 units from points in [-1.5, 1.5]³, exact normalized
    observations (plus ``noise``), a fraction replaced by uniform draws in
    [-1, 1]²."""
    rng = np.random.default_rng(seed)
    T = np.asarray(jax_se3_exp(jnp.asarray(rng.normal(size=6) * 0.4, jnp.float32))).copy()
    T[2, 3] += 4.0
    pts = rng.uniform(-1.5, 1.5, size=(n, 3))
    Xc = pts @ T[:3, :3].T + T[:3, 3]
    obs = Xc[:, :2] / Xc[:, 2:3] + noise * rng.normal(size=(n, 2))
    out = rng.uniform(size=n) < outlier_frac
    obs[out] = rng.uniform(-1, 1, size=(int(out.sum()), 2))
    return pts.astype(np.float32), obs.astype(np.float32), T.astype(np.float32), ~out


def _generator(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (1, 0.001)])
def test_estimate_matches_reference_from_same_minimal_sets(seed, noise):
    """N = 300 (so the sentinel padding to 384 is exercised), 30% outliers,
    τ = 0.01, K = 512 samples, eight refinement steps. JAX draws the minimal
    sets; the port runs from those very sets. On the CPU both packages run
    one algorithm (the JAX scorer takes its jnp twin, the port its plain
    version), so: pose within 1e-3 (all-inlier samples tie to f32 rounding,
    so the two may refine from different winners towards the one optimum),
    pre-refinement score within 1e-3 relative, inlier masks agreeing on at
    least 99% of the rows (an error at τ² may change side), the same count of
    hypotheses, 4·K, and both within 0.05 of the truth, the bench's gate."""
    pts, obs, T_gt, inl = _problem(seed, noise=noise)
    key = jax.random.key(seed)
    ref = result_to_numpy(
        jengine.estimate_pose_2d3d(key, jnp.asarray(pts), jnp.asarray(obs), JCFG)
    )
    idx = np.asarray(jax_sample(key, N, 512, 3, JCFG.prosac))

    before = _build.launch_counts()
    res = tengine._estimate_2d3d_from_samples(*to_torch((idx, pts, obs), "cpu"), CFG)
    assert _build.launch_counts() == before  # CPU tensors: plain versions only
    assert res.pose.dtype == torch.float32 and res.inlier_mask.dtype == torch.bool
    out = result_to_numpy(res)

    np.testing.assert_allclose(out["pose"], ref["pose"], atol=1e-3)
    np.testing.assert_allclose(out["score"], ref["score"], rtol=1e-3)
    assert out["inlier_mask"].shape == (N,)
    assert (out["inlier_mask"] == ref["inlier_mask"]).mean() >= 0.99
    assert abs(float(out["num_inliers"]) - float(ref["num_inliers"])) <= 3
    assert bool(out["valid"]) == bool(ref["valid"]) is True
    assert out["num_hypotheses"] == ref["num_hypotheses"] == 4 * 512
    assert np.abs(out["pose"] - T_gt).max() < 0.05
    assert np.abs(ref["pose"] - T_gt).max() < 0.05
    # The pre-refinement score is an MSAC over the PADDED set: the 84 pad rows
    # and every outlier add τ² each.
    floor = (84 + (~inl).sum() - 3) * 0.01**2
    assert floor <= out["score"] <= 384 * 0.01**2
    if noise == 0.0:
        assert (out["inlier_mask"] & inl).sum() >= inl.sum() - 1


def test_estimate_with_own_sampler_and_refine_guard():
    """The port's own sampler; ``refine_iters=0`` leaves the winning root as
    it is (still within the gate), eight steps do not lose inliers."""
    pts, obs, T_gt, inl = _problem(2, outlier_frac=0.5, noise=0.001)
    args = to_torch((pts, obs), "cpu")
    raw = tengine.estimate_pose_2d3d(_generator(0), *args, CFG, refine_iters=0)
    res = tengine.estimate_pose_2d3d(_generator(0), *args, CFG)
    assert bool(raw.valid) and bool(res.valid)
    assert raw.num_hypotheses == res.num_hypotheses == 2048
    assert float(res.score) == float(raw.score)  # the same winner before refinement
    assert float(res.num_inliers) >= float(raw.num_inliers)
    assert np.abs(raw.pose.numpy() - T_gt).max() < 0.05
    assert np.abs(res.pose.numpy() - T_gt).max() < 0.02
    mask = res.inlier_mask.numpy()
    assert (mask & inl).sum() >= 0.95 * inl.sum() and (mask & ~inl).sum() <= 3


def test_all_outliers_is_invalid():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.5, 1.5, size=(128, 3)).astype(np.float32) + np.float32([0, 0, 4])
    obs = rng.uniform(-1, 1, size=(128, 2)).astype(np.float32)
    cfg = tengine.RansacConfig(num_hypotheses=256, threshold=0.002, min_inliers=10)
    res = tengine.estimate_pose_2d3d(_generator(1), *to_torch((pts, obs), "cpu"), cfg)
    assert not bool(res.valid) and np.isfinite(res.pose.numpy()).all()
    assert res.inlier_mask.shape == (128,) and res.num_hypotheses == 1024


def test_degenerate_samples_never_win():
    """Minimal sets that repeat a point give NaN or invalid roots: they are
    masked (identity pose, +inf score) and a clean set among them wins."""
    pts, obs, T_gt, inl = _problem(4, n=64, outlier_frac=0.0)
    idx = np.zeros((8, 3), np.int32)  # seven times the same point three times
    idx[5] = [3, 17, 40]
    res = tengine._estimate_2d3d_from_samples(*to_torch((idx, pts, obs), "cpu"), CFG)
    assert bool(res.valid) and np.isfinite(float(res.score))
    assert np.abs(res.pose.numpy() - T_gt).max() < 1e-3
    assert res.num_hypotheses == 32
    allbad = tengine._estimate_2d3d_from_samples(
        *to_torch((np.zeros((8, 3), np.int32), pts, obs), "cpu"), CFG
    )
    assert not bool(allbad.valid) and np.isfinite(allbad.pose.numpy()).all()


@pytest.fixture(scope="module")
def adaptive_runs():
    """Both packages' adaptive wrapper on a 35%-outlier problem, as it is
    (N = 300) and padded to 512 rows before the call, as
    ``models/frame_pair.py`` of the JAX package pads it."""
    pts, obs, T_gt, _ = _problem(7, outlier_frac=0.35)
    runs = {"T_gt": T_gt}
    for name, n_pad in (("as_it_is", N), ("padded", 512)):
        jp, jo = jengine.pad_points_obs_2d3d(jnp.asarray(pts), jnp.asarray(obs), n_pad)
        tp, to = tengine.pad_points_obs_2d3d(*to_torch((pts, obs), "cpu"), n_pad)
        runs[name] = (
            jengine.estimate_pose_2d3d_adaptive(jax.random.key(51), jp, jo, JCFG),
            tengine.estimate_pose_2d3d_adaptive(_generator(51), tp, to, CFG),
        )
    return runs


def test_2d3d_adaptive_stops_after_probe(adaptive_runs):
    """65% inliers: 64 samples meet the 0.999 bound (sample size 3 needs 22),
    so the probe's result is returned, and ``num_hypotheses`` counts its
    roots: 4·max(probe_hypotheses, 64). The same in both packages."""
    ref, res = adaptive_runs["as_it_is"]
    assert res.num_hypotheses == ref.num_hypotheses == 4 * 64
    assert bool(res.valid) and bool(ref.valid)
    assert np.abs(res.pose.numpy() - adaptive_runs["T_gt"]).max() < 0.03
    assert np.abs(np.asarray(ref.pose) - adaptive_runs["T_gt"]).max() < 0.03
    assert abs(float(res.num_inliers) - float(ref.num_inliers)) <= 3


def test_2d3d_adaptive_ratio_divides_by_padded_n(adaptive_runs):
    """A fault of the JAX package, ported as it is: the wrapper divides the
    probe's inliers by the row count it was handed. A caller that pads first
    (300 rows to 512) is seen at 0.65·300/512 = 0.38 instead of 0.65, the bound
    asks for 122 samples instead of 22, and the full round runs although the
    probe was enough. Both packages: probe and full round summed, 4·(64 + 512),
    and the pad rows (behind the camera) are no inliers."""
    ref, res = adaptive_runs["padded"]
    assert res.num_hypotheses == ref.num_hypotheses == 4 * (64 + 512)
    assert tengine.required_hypotheses(0.65 * 300 / 512, 3, CFG.confidence) == 122
    assert tengine.required_hypotheses(0.65, 3, CFG.confidence) == 22
    assert res.inlier_mask.shape == (512,) and not bool(res.inlier_mask[N:].any())
    assert np.abs(res.pose.numpy() - adaptive_runs["T_gt"]).max() < 0.03
    assert abs(float(res.num_inliers) - float(ref.num_inliers)) <= 3


def test_2d3d_adaptive_runs_full_round_at_low_inlier_ratio():
    """35% inliers need ~158 samples: the full round runs on the same
    generator's stream and the better of the two rounds is returned; a full
    round no larger than the probe never runs."""
    pts, obs, T_gt, _ = _problem(8, outlier_frac=0.65)
    args = to_torch((pts, obs), "cpu")
    res = tengine.estimate_pose_2d3d_adaptive(_generator(3), *args, CFG)
    assert res.num_hypotheses == 4 * (64 + 512) and bool(res.valid)
    assert np.abs(res.pose.numpy() - T_gt).max() < 0.05
    small = dataclasses.replace(CFG, num_hypotheses=64)
    assert tengine.estimate_pose_2d3d_adaptive(_generator(3), *args, small).num_hypotheses == 256


def test_exported_as_in_the_reference():
    from rgbd_pose_estimation_tpu import ransac as jransac
    from rgbd_pose_estimation_tpu import solvers as jsolvers
    from rgbd_pose_estimation_tpu_torch import ransac as transac
    from rgbd_pose_estimation_tpu_torch import solvers as tsolvers

    assert set(jransac.__all__) == set(transac.__all__)
    assert set(jsolvers.__all__) == set(tsolvers.__all__)
    assert transac.estimate_pose_2d3d is tengine.estimate_pose_2d3d
