"""solvers/p3p.py and solvers/pnp.py of the PyTorch port against the JAX
package's, from the same numpy-made problems."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.lie import se3_exp as _jax_se3_exp
from rgbd_pose_estimation_tpu.solvers import pnp as _jpnp
from rgbd_pose_estimation_tpu.solvers.p3p import p3p as jax_p3p
from rgbd_pose_estimation_tpu.solvers.p3p import p3p_best as jax_p3p_best
from rgbd_pose_estimation_tpu_torch.solvers import pnp as tpnp
from rgbd_pose_estimation_tpu_torch.solvers.p3p import p3p, p3p_best
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch

# The JAX package's functions, jitted: one compile per shape instead of one
# per primitive and shape.
jax_se3_exp = jax.jit(_jax_se3_exp)


class jpnp:  # noqa: N801 - stands for the module
    pnp_dlt = staticmethod(jax.jit(_jpnp.pnp_dlt))
    pnp_refine = staticmethod(jax.jit(_jpnp.pnp_refine, static_argnames="iters"))


def _poses(rng, b, scale):
    T = np.asarray(jax_se3_exp(jnp.asarray(rng.normal(size=(b, 6)) * scale, jnp.float32)))
    return T.copy()


def _apply(T, P):
    return np.einsum("bij,bnj->bni", T[:, :3, :3], P) + T[:, None, :3, 3]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return to_torch(list(arrays), "cpu")


@pytest.fixture(scope="module")
def p3p_problem():
    """512 cameras 4 units in front of four points in [-1, 1]³ (the problem
    of tests/unit/test_solvers.py::_p3p_problem), and p3p of both packages."""
    rng = np.random.default_rng(0)
    T = _poses(rng, 512, 0.5)
    T[:, 2, 3] += 4.0
    Pw = rng.uniform(-1, 1, size=(512, 4, 3)).astype(np.float32)
    Xc = _apply(T, Pw)
    rays = (Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)).astype(np.float32)
    ref = [np.asarray(x) for x in jax_p3p(*_j(Pw[:, :3], rays[:, :3]))]
    out = [x.numpy() for x in p3p(*_t(Pw[:, :3], rays[:, :3]))]
    return T, Pw, rays, ref, out


def test_p3p_matches_reference(p3p_problem):
    """``valid`` agrees on at least 99% of the 2048 roots and the poses are
    within 1e-3 wherever both packages call the root valid, on at least 99%
    of those: the quartic's ``disc >= 0`` branches are taken on cancelling
    f32 values that the two compilers round differently, so next to a
    double root a pair of roots may flip or move (tests/test_torch_poly.py)."""
    _, _, _, (T_ref, v_ref), (T_out, v_out) = p3p_problem
    assert T_out.shape == (512, 4, 4, 4) and v_out.shape == (512, 4)
    assert T_out.dtype == np.float32 and v_out.dtype == np.bool_
    assert np.isfinite(T_out).all()  # invalid roots carry finite dummy poses
    assert (v_out == v_ref).mean() >= 0.99
    both = v_out & v_ref
    close = np.abs(T_out - T_ref).max(axis=(-1, -2)) < 1e-3
    assert close[both].mean() >= 0.99
    np.testing.assert_array_equal(T_out[..., 3, :], np.broadcast_to([0, 0, 0, 1.0], (512, 4, 4)))


def test_p3p_true_pose_among_roots(p3p_problem):
    """The true pose is among the valid roots: median Frobenius distance
    under 1e-2 (the bound of TestP3P.test_true_pose_among_roots), and within
    5e-2 on more than 90% of these 512 problems, no fewer (to one point)
    than the JAX package finds on them."""
    T, _, _, (T_ref, v_ref), (T_out, v_out) = p3p_problem

    def closest(Ts, valid):
        err = np.linalg.norm(Ts - T[:, None], axis=(-1, -2))
        return np.where(valid, err, np.inf).min(axis=-1)

    err, err_ref = closest(T_out, v_out), closest(T_ref, v_ref)
    assert np.median(err) < 1e-2
    assert (err < 5e-2).mean() > 0.9
    assert (err < 5e-2).mean() >= (err_ref < 5e-2).mean() - 0.01


def test_p3p_best_matches_reference(p3p_problem):
    """The fourth correspondence picks the root: the same pose as the JAX
    package's within 1e-3 on at least 99% of the problems (two roots that
    nearly coincide may be picked differently), found valid alike, and the
    true pose on most (TestP3P.test_best_root_disambiguation's bounds)."""
    T, Pw, rays, _, _ = p3p_problem
    Tb_ref, v_ref = jax_p3p_best(*_j(Pw[:, :3], rays[:, :3], Pw[:, 3], rays[:, 3]))
    Tb, v = p3p_best(*_t(Pw[:, :3], rays[:, :3], Pw[:, 3], rays[:, 3]))
    assert Tb.shape == (512, 4, 4) and v.dtype == torch.bool
    assert (v.numpy() == np.asarray(v_ref)).mean() >= 0.99 and v.numpy().mean() > 0.95
    close = np.abs(Tb.numpy() - np.asarray(Tb_ref)).max(axis=(-1, -2)) < 1e-3
    assert close.mean() >= 0.99
    assert np.median(np.linalg.norm(Tb.numpy() - T, axis=(-1, -2))) < 1e-2


def test_p3p_leading_axes():
    rng = np.random.default_rng(5)
    T = _poses(rng, 6, 0.3)
    T[:, 2, 3] += 4.0
    Pw = rng.uniform(-1, 1, size=(6, 3, 3)).astype(np.float32)
    Xc = _apply(T, Pw)
    rays = (Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)).astype(np.float32)
    Ts, valid = p3p(*_t(Pw.reshape(2, 3, 3, 3), rays.reshape(2, 3, 3, 3)))
    assert Ts.shape == (2, 3, 4, 4, 4) and valid.shape == (2, 3, 4)
    flat, _ = p3p(*_t(Pw, rays))
    np.testing.assert_array_equal(Ts.reshape(6, 4, 4, 4).numpy(), flat.numpy())


def _pnp_problem(seed, b, n, scale=0.5, depth=4.0):
    rng = np.random.default_rng(seed)
    T = _poses(rng, b, scale)
    T[:, 2, 3] += depth
    Pw = rng.normal(size=(b, n, 3)).astype(np.float32)
    Xc = _apply(T, Pw)
    obs = (Xc[..., :2] / Xc[..., 2:3]).astype(np.float32)
    return rng, T, Pw, obs


def test_pnp_dlt_matches_reference():
    """TestPnP.test_dlt_exact's problem (32 poses, 12 exact observations).
    Poses within 1e-4: the null vector of the 12×12 normal matrix comes from
    two LAPACK ``eigh`` builds and its sign is arbitrary (the cheirality flip
    fixes it), so poses are compared, not eigenvectors. Both within the JAX
    test's 1e-3 (median) of the truth."""
    _, T, Pw, obs = _pnp_problem(0, 32, 12)
    ref = np.asarray(jpnp.pnp_dlt(*_j(Pw, obs)))
    out = tpnp.pnp_dlt(*_t(Pw, obs)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.median(np.linalg.norm(out - T, axis=(1, 2))) < 1e-3


def test_pnp_dlt_weights_ignore_outliers():
    """Three of sixteen observations corrupted and given weight 0: the pose
    from the thirteen left, within 1e-4·(1 + |entry|) of the JAX package's
    (fewer rows, a worse-conditioned null vector than the case above)."""
    rng, T, Pw, obs = _pnp_problem(3, 8, 16)
    w = np.ones((8, 16), np.float32)
    w[:, :3] = 0.0
    obs = obs.copy()
    obs[:, :3] += rng.normal(size=(8, 3, 2)).astype(np.float32)
    ref = np.asarray(jpnp.pnp_dlt(*_j(Pw, obs, w)))
    out = tpnp.pnp_dlt(*_t(Pw, obs, w)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    assert np.median(np.linalg.norm(out - T, axis=(1, 2))) < 1e-3


def test_pnp_refine_matches_reference_from_perturbed_start():
    """TestPnP.test_refine_converges_from_perturbed_init's problem: ten
    damped Gauss-Newton steps from the same start perturbed by 0.05. Within
    1e-5 of the JAX package's result (both converge to the one optimum; what
    is left is f32 rounding of the last step), and within its 1e-3 of the
    truth."""
    rng, T, Pw, obs = _pnp_problem(1, 16, 30)
    dT = np.asarray(jax_se3_exp(jnp.asarray(rng.normal(size=(16, 6)) * 0.05, jnp.float32)))
    T0 = (dT @ T).astype(np.float32)
    ref = np.asarray(jpnp.pnp_refine(*_j(T0, Pw, obs), iters=10))
    out = tpnp.pnp_refine(*_t(T0, Pw, obs), iters=10)
    assert out.dtype == torch.float32 and out.shape == (16, 4, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert np.linalg.norm(out.numpy() - T, axis=(1, 2)).max() < 1e-3


def test_pnp_refine_one_step_weighted_single_problem():
    """One step, unbatched ``(4, 4)`` pose, 0/1 weights that switch off
    corrupted observations (as the RANSAC engine calls it): the same step as
    the JAX package's to 1e-5, and repeatable to the bit."""
    rng, T, Pw, obs = _pnp_problem(2, 1, 40, scale=0.3, depth=3.0)
    w = (rng.uniform(size=40) < 0.7).astype(np.float32)
    obs = obs[0].copy()
    obs[w == 0] += 0.3
    dT = np.asarray(jax_se3_exp(jnp.asarray(rng.normal(size=6) * 0.02, jnp.float32)))
    T0 = (dT @ T[0]).astype(np.float32)
    ref = np.asarray(jpnp.pnp_refine(*_j(T0, Pw[0], obs), weights=jnp.asarray(w), iters=1))
    args = _t(T0, Pw[0], obs)
    out = tpnp.pnp_refine(*args, weights=to_torch(w, "cpu"), iters=1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    again = tpnp.pnp_refine(*args, weights=to_torch(w, "cpu"), iters=1)
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    # The step moved towards the truth.
    assert np.abs(out.numpy() - T[0]).max() < np.abs(T0 - T[0]).max()


def test_pnp_refine_reads_nothing_back():
    """No call in the refinement waits for the device: the 6×6 solve is
    ``solve_ex`` (``torch.linalg.solve`` checks for singularity on the host)."""
    import inspect

    code = inspect.getsource(tpnp.pnp_refine)
    for banned in (".item(", "float(", ".cpu(", ".numpy(", ".tolist(", "bool(", "torch.tensor("):
        assert banned not in code, banned
    assert "torch.linalg.solve_ex" in code and "torch.linalg.solve(" not in code
