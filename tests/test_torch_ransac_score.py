"""ops/ransac_score.py of the PyTorch port against the JAX package's
kernels (run by the Pallas interpreter) and its two-stage selector. On CPU
tensors the port's wrappers run their plain versions, which is what these
tests reach; the CUDA kernels are held against those plain versions on the
card by chip_smoke.py."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.lie import se3_exp as _jax_se3_exp
from rgbd_pose_estimation_tpu.ops import ransac_score as jscore
from rgbd_pose_estimation_tpu.ransac.engine import pad_correspondences_3d3d as jax_pad
from rgbd_pose_estimation_tpu.solvers.absolute_orientation import kabsch as _jax_kabsch
from rgbd_pose_estimation_tpu_torch.ops import ransac_score as tscore
from rgbd_pose_estimation_tpu_torch.ransac.engine import pad_correspondences_3d3d
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch

# The JAX package's functions, jitted: one compile per shape instead of one
# per primitive and shape.
jax_se3_exp = jax.jit(_jax_se3_exp)
jax_kabsch = jax.jit(_jax_kabsch)


def _poses(seed, k, scale=0.4):
    rng = np.random.default_rng(seed)
    return np.asarray(jax_se3_exp(jnp.asarray(rng.normal(size=(k, 6)) * scale, jnp.float32)))


def _points(seed, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


def _apply(T, p):
    return (p @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return to_torch(list(arrays), "cpu")


@pytest.mark.parametrize("k,n", [(256, 128), (512, 384)])
def test_exact_matches_pallas_kernel_interpreted(k, n):
    """Exact f32 scorer against the Pallas kernel under the interpreter:
    1e-5 relative on the scores (sums of n f32 terms in another order) and
    equal counts, the JAX package's own bounds for its kernel
    (tests/kernels/test_ransac_score.py:33-34)."""
    T, (p, q) = _poses(1, k), _points(0, n)
    m_ref, c_ref = jscore.score_poses_3d3d(*_j(T, p, q), 0.1, impl="interpret")
    m_out, c_out = tscore.score_poses_3d3d(*_t(T, p, q), 0.1)
    assert m_out.shape == (k,) and m_out.dtype == torch.float32
    np.testing.assert_allclose(m_out.numpy(), np.asarray(m_ref), rtol=1e-5)
    np.testing.assert_array_equal(c_out.numpy(), np.asarray(c_ref))


def test_exact_any_shape_matches_jnp_twin():
    # K and N that tile nothing: the JAX kernel falls back to its twin here.
    T, (p, q) = _poses(2, 100), _points(3, 77)
    m_ref, c_ref = jscore.score_poses_3d3d_reference(*_j(T, p, q), 0.5)
    m_out, c_out = tscore.score_poses_3d3d_reference(*_t(T, p, q), 0.5)
    np.testing.assert_allclose(m_out.numpy(), np.asarray(m_ref), rtol=1e-5)
    np.testing.assert_array_equal(c_out.numpy(), np.asarray(c_ref))


def test_quad_features_equal():
    T, (p, q) = _poses(4, 64), _points(5, 50)
    f_ref, pn_ref = jscore._quad_features(*_j(T, p, q))
    f_out, pn_out = tscore._quad_features(*_t(T, p, q))
    assert f_out.shape == (64, 17) and pn_out.shape == (17, 50)
    np.testing.assert_allclose(f_out.numpy(), np.asarray(f_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pn_out.numpy(), np.asarray(pn_ref), rtol=1e-6, atol=1e-6)
    # R and -2t are copied, not computed: bit-identical.
    np.testing.assert_array_equal(f_out.numpy()[:, :9], T[:, :3, :3].reshape(64, 9))
    np.testing.assert_array_equal(f_out.numpy()[:, 12:15], -2.0 * T[:, :3, 3])


@pytest.mark.parametrize("k,n", [(256, 128), (512, 384)])
def test_quad_matches_pallas_kernel_interpreted(k, n):
    """Fast ranking scores against the fused Pallas kernel under the
    interpreter. Both round the operands to bf16 and accumulate in f32, so
    the products are identical; what differs is the order of the 17-term
    sum, whose terms (of order |p|² ~ 10) cancel down to residuals near τ²:
    a rounding difference of one f32 ulp of a term, ~1e-6, against entries
    of ~1e-2, i.e. up to ~1e-4 relative on an entry and less on the sum of
    n of them. Hence 1e-4 where the JAX package's own test, whose two
    sides share one summation order, asks 1e-5."""
    T, (p, q) = _poses(4, k), _points(3, n)
    ref = jscore.score_poses_3d3d_quad_fused(*_j(T, p, q), 0.1, impl="interpret")
    out = tscore.score_poses_3d3d_quad_fused(*_t(T, p, q), 0.1)
    assert out.shape == (k,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4)
    twin = jscore.score_poses_3d3d_quad(*_j(T, p, q), 0.1, operand_dtype=jnp.bfloat16)
    np.testing.assert_allclose(
        tscore.score_poses_3d3d_quad(*_t(T, p, q), 0.1).numpy(), np.asarray(twin), rtol=1e-4
    )


def test_quad_survives_pad_sentinels():
    """The ~1e4 pad sentinels give pn entries ~1e8 whose bf16 rounding
    drives residuals negative: clip (not min) keeps the scores finite and
    the true pose first."""
    T, (p, _) = _poses(6, 256), _points(5, 100)
    q = _apply(T[3], p)
    pp, qq = pad_correspondences_3d3d(*_t(p, q), 128)
    fast = tscore.score_poses_3d3d_quad_fused(to_torch(T, "cpu"), pp, qq, 0.05).numpy()
    assert np.isfinite(fast).all() and int(np.argmin(fast)) == 3
    assert fast.min() >= 0.0 and fast.max() <= 128 * 0.05**2 * (1 + 1e-6)


@pytest.mark.parametrize("pad", [28, 128])
def test_pad_sentinels_add_exactly_pad_tau2(pad):
    tau = 0.05
    T, (p, _) = _poses(6, 64), _points(5, 100)
    q = _apply(T[3], p)
    pp, qq = pad_correspondences_3d3d(*_t(p, q), 100 + pad)
    assert pp.shape == (100 + pad, 3)
    jp, jq = jax_pad(*_j(p, q), 100 + pad)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(qq.numpy(), np.asarray(jq))
    m0, c0 = tscore.score_poses_3d3d(*_t(T, p, q), tau)
    m1, c1 = tscore.score_poses_3d3d(to_torch(T, "cpu"), pp, qq, tau)
    np.testing.assert_allclose(m1.numpy(), m0.numpy() + np.float32(pad * tau * tau), rtol=1e-6)
    np.testing.assert_array_equal(c1.numpy(), c0.numpy())


def test_pack_unpack_roundtrip():
    T = _poses(11, 64)
    P = tscore.pack_poses(to_torch(T, "cpu"))
    assert P.shape == (64, 12)
    np.testing.assert_array_equal(P.numpy(), np.asarray(jscore.pack_poses(jnp.asarray(T))))
    for k in (0, 17, 63):
        np.testing.assert_array_equal(tscore.unpack_pose(P[k]).numpy(), T[k])


@pytest.mark.parametrize("selection", ["group", "topk", "approx"])
def test_best_pose_same_winner_well_separated(selection):
    """One pose explains the data exactly, the others are far off: both
    packages must pick it, and return it bit for bit (it is rebuilt from
    the feature rows: R copied, t = (-2t) * -0.5)."""
    T, (p, _) = _poses(7, 512), _points(6, 256)
    q = _apply(T[123], p)
    b_ref, s_ref, T_ref = jscore.best_pose_3d3d(
        *_j(T, p, q), 0.05, impl="two_stage", selection=selection, return_pose=True
    )
    b, s, Tw = tscore.best_pose_3d3d(*_t(T, p, q), 0.05, selection=selection, return_pose=True)
    assert int(b) == int(b_ref) == 123
    assert float(s) < 1e-6 and float(s_ref) < 1e-6
    np.testing.assert_array_equal(Tw.numpy(), np.asarray(T_ref))
    np.testing.assert_array_equal(Tw.numpy(), T[123])
    b2, s2 = tscore.best_pose_3d3d(*_t(T, p, q), 0.05, impl="two_stage", selection=selection)
    assert int(b2) == 123 and float(s2) == float(s)


def test_best_pose_group_needs_divisible_k():
    """K = 500 is not a multiple of top = 16: "group" takes exact top-k, as
    the JAX package does, and still finds the winner; top > K is clamped."""
    T, (p, _) = _poses(8, 500), _points(7, 128)
    q = _apply(T[499], p)
    b, _ = tscore.best_pose_3d3d(*_t(T, p, q), 0.05, selection="group")
    assert int(b) == 499
    b, _ = tscore.best_pose_3d3d(*_t(T[:10], p, _apply(T[9], p)), 0.05, top=64)
    assert int(b) == 9


def test_best_pose_exact_impl():
    T, (p, _) = _poses(9, 256), _points(8, 128)
    q = _apply(T[41], p)
    b_ref, s_ref = jscore.best_pose_3d3d(*_j(T, p, q), 0.05, impl="exact")
    b, s, Tw = tscore.best_pose_3d3d(*_t(T, p, q), 0.05, impl="exact", return_pose=True)
    assert int(b) == int(b_ref) == 41
    np.testing.assert_allclose(float(s), float(s_ref), atol=1e-7)
    np.testing.assert_array_equal(Tw.numpy(), T[41])


@pytest.mark.parametrize("impl", ["auto", "two_stage", "exact"])
def test_nan_pose_never_wins(impl):
    T, (p, _) = _poses(4, 256), _points(3, 128)
    T = T.copy()
    q = _apply(T[7], p)
    T[9] = np.nan
    T[0, 0, 0] = np.nan  # first of its group
    msac, count = tscore.score_poses_3d3d(*_t(T, p, q), 0.05)
    assert np.isnan(msac.numpy()[[0, 9]]).all()  # NaN propagates, as in JAX
    assert np.isnan(tscore.score_poses_3d3d_quad_fused(*_t(T, p, q), 0.05).numpy()[[0, 9]]).all()
    b, s = tscore.best_pose_3d3d(*_t(T, p, q), 0.05, impl=impl)
    assert int(b) == 7 and np.isfinite(float(s))


def test_best_pose_rejects_unknown_arguments():
    T, (p, q) = _poses(1, 16), _points(1, 16)
    with pytest.raises(ValueError, match="impl"):
        tscore.best_pose_3d3d(*_t(T, p, q), 0.05, impl="pallas")
    with pytest.raises(ValueError, match="selection"):
        tscore.best_pose_3d3d(*_t(T, p, q), 0.05, selection="sorted")


@pytest.mark.parametrize("selection", ["group", "topk"])
def test_finalist_window_adversarial(selection):
    """The near-tie fixture of the JAX package's
    test_finalist_window_adversarial (tests/kernels/test_ransac_score.py):
    hundreds of hypotheses within 2% exact MSAC of the winner whose inlier
    sets differ on threshold-straddling residuals. The contract is
    post-refit: the port's two-stage pick, the JAX two-stage pick and the
    exact pick must refit to the same pose within 2e-3, because the
    near-tie band shares one refit basin. The pre-refit pick may sit up to
    5% above the exact optimum (same bound as that test)."""
    rng = np.random.default_rng(7)
    tau, n, k = 0.05, 256, 2048
    p = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mags = np.where(
        rng.uniform(size=(n, 1)) < 0.6,
        rng.uniform(0.0, 0.2 * tau, size=(n, 1)),
        rng.uniform(0.7 * tau, 1.3 * tau, size=(n, 1)),
    )
    q = (p + dirs * mags).astype(np.float32)
    deltas = rng.normal(size=(k, 6)) * 0.05 * tau
    deltas[0] = 0.0
    T = np.asarray(jax_se3_exp(jnp.asarray(deltas, jnp.float32)))

    exact = tscore.score_poses_3d3d(*_t(T, p, q), tau)[0].numpy()
    assert (exact / exact.min() - 1.0 < 0.02).sum() >= 64, "fixture not adversarial enough"

    b_port, s_port = tscore.best_pose_3d3d(*_t(T, p, q), tau, selection=selection)
    b_jax, _ = jscore.best_pose_3d3d(*_j(T, p, q), tau, impl="two_stage", selection=selection)
    b_exact, s_exact = tscore.best_pose_3d3d(*_t(T, p, q), tau, impl="exact")
    assert float(s_exact) == exact.min()
    assert float(s_port) <= exact.min() * 1.05

    def refit(T0, rounds=3):
        Tc = np.asarray(T0)
        for _ in range(rounds):
            e = np.sum((q - (p @ Tc[:3, :3].T + Tc[:3, 3])) ** 2, axis=-1)
            w = (e < tau * tau).astype(np.float32)
            if w.sum() < 3:
                break
            Tc = np.asarray(jax_kabsch(jnp.asarray(p), jnp.asarray(q), weights=jnp.asarray(w)))
        return Tc

    Ta, Tb, Tc = refit(T[int(b_port)]), refit(T[int(b_exact)]), refit(T[int(b_jax)])
    np.testing.assert_allclose(Ta, Tb, atol=2e-3)
    np.testing.assert_allclose(Ta, Tc, atol=2e-3)
