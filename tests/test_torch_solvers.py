"""solvers/absolute_orientation.py of the PyTorch port against the JAX
package's, on the same numpy inputs.

Tolerance 1e-5 absolute on the (4, 4) poses: the port keeps the JAX
package's component-wise f32 arithmetic line for line, so what differs is
the order of the sums over the N points (and the SVD library for Kabsch and
Umeyama), a few f32 ulps on entries of order 1."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.lie import se3_exp as jax_se3_exp
from rgbd_pose_estimation_tpu.solvers import absolute_orientation as jao
from rgbd_pose_estimation_tpu_torch.solvers import absolute_orientation as tao
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch

ATOL = 1e-5


def _problem(seed, batch=(), n=64, noise=0.01):
    """Points, their image under a random rigid motion plus noise, weights."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=batch + (n, 3)).astype(np.float32)
    T = np.asarray(jax_se3_exp(jnp.asarray(rng.normal(size=batch + (6,)) * 0.5, jnp.float32)))
    q = np.einsum("...ij,...nj->...ni", T[..., :3, :3], p) + T[..., None, :3, 3]
    q = (q + noise * rng.normal(size=q.shape)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=batch + (n,)).astype(np.float32)
    return p, q, w


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "weighted,iters", [(False, 12), (True, 12), (True, 4)],
    ids=["unweighted", "weighted", "weighted-iters4"],
)
def test_horn_quaternion(weighted, iters):
    p, q, w = _problem(0, batch=(8,))
    w = w if weighted else None
    ref = jao.horn_quaternion(jnp.asarray(p), jnp.asarray(q), None if w is None else jnp.asarray(w), iters=iters)
    out = tao.horn_quaternion(*to_torch((p, q, w), "cpu"), iters=iters)
    _close(out, ref)


def test_horn_quaternion_unbatched_hard_weights():
    # The engine's refit: one problem, 0/1 weights.
    p, q, w = _problem(1, n=200)
    w = (w > 0.4).astype(np.float32)
    ref = jao.horn_quaternion(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    _close(tao.horn_quaternion(*to_torch((p, q, w), "cpu")), ref)


def _moments(p, q):
    """(16, K) moments of (K, m, 3) minimal sets, in numpy."""
    so = np.einsum("kma,kmb->kab", p, q).reshape(p.shape[0], 9)
    cnt = np.full((p.shape[0], 1), p.shape[1], np.float32)
    return np.concatenate([p.sum(1), q.sum(1), so, cnt], -1).T.astype(np.float32)


@pytest.mark.parametrize("iters", [4, 12])
def test_horn_from_moments(iters):
    """Minimal sets of three points, solved from their moments. 1e-5 holds
    for sets that are not close to collinear (second singular value of the
    centred points at least a fifth of the first): three centred points
    have rank 2, the gap between the top two eigenvalues of Horn's matrix
    is twice that second singular value, and near collinearity any f32
    rounding difference between the two frameworks is amplified by its
    inverse. Every set, conditioned or not, must stay finite and proper."""
    p, q, _ = _problem(2, batch=(256,), n=3, noise=0.003)
    mom = _moments(p, q)
    ref = np.asarray(jao.horn_from_moments(jnp.asarray(mom), iters=iters))
    out = tao.horn_from_moments(to_torch(mom, "cpu"), iters=iters)
    _proper_and_finite(out)
    sv = np.linalg.svd(p - p.mean(1, keepdims=True), compute_uv=False)
    good = sv[:, 1] > 0.2 * sv[:, 0]
    assert good.sum() > 150
    np.testing.assert_allclose(out.numpy()[good], ref[good], atol=ATOL, rtol=0)


def test_horn_rotation_directions():
    p, q, w = _problem(3, batch=(8,), n=32)
    ref = jao.horn_rotation_directions(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    _close(tao.horn_rotation_directions(*to_torch((p, q, w), "cpu")), ref)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch(weighted):
    p, q, w = _problem(4, batch=(8,))
    w = w if weighted else None
    ref = jao.kabsch(jnp.asarray(p), jnp.asarray(q), None if w is None else jnp.asarray(w))
    _close(tao.kabsch(*to_torch((p, q, w), "cpu")), ref)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama(with_scale):
    p, q, w = _problem(5, batch=(8,))
    q = (1.7 * q).astype(np.float32) if with_scale else q
    T_ref, s_ref = jao.umeyama(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w), with_scale=with_scale)
    T_out, s_out = tao.umeyama(*to_torch((p, q, w), "cpu"), with_scale=with_scale)
    # Translations are scaled by s here, hence the factor on the tolerance.
    _close(T_out, T_ref, atol=2 * ATOL)
    _close(s_out, s_ref)
    if with_scale:
        np.testing.assert_allclose(s_out.numpy(), 1.7, atol=2e-2)


def _proper_and_finite(T):
    T = T.numpy()
    assert np.isfinite(T).all()
    np.testing.assert_allclose(np.linalg.det(T[..., :3, :3]), 1.0, atol=1e-4)


def test_near_collinear_minimal_sets():
    """Three nearly collinear points (off the line by 0.0035 of its
    length): the top two eigenvalues of Horn's N matrix nearly coincide,
    which a single-vector power method cannot split (it leaves rotation
    errors of order 0.5). The block iteration must stay finite and proper
    on every set and recover the motion on the typical one; the worst sets
    are limited by the f32 rounding of the points themselves, in both
    packages alike, so no set-by-set parity is asked here."""
    rng = np.random.default_rng(6)
    base = rng.normal(size=(64, 1, 3))
    direction = rng.normal(size=(64, 1, 3))
    steps = np.array([-1.0, 0.1, 1.0]).reshape(1, 3, 1)
    p = (base + steps * direction + 0.0035 * rng.normal(size=(64, 3, 3))).astype(np.float32)
    T = np.asarray(jax_se3_exp(jnp.asarray(rng.normal(size=(64, 6)) * 0.5, jnp.float32)))
    q = (np.einsum("kij,knj->kni", T[:, :3, :3], p) + T[:, None, :3, 3]).astype(np.float32)
    out = tao.horn_quaternion(*to_torch((p, q), "cpu"))
    _proper_and_finite(out)
    err = np.abs(out.numpy()[:, :3, :3] - T[:, :3, :3]).max(axis=(1, 2))
    assert np.median(err) < 2e-2
    ref = np.asarray(jao.horn_quaternion(jnp.asarray(p), jnp.asarray(q)))
    err_ref = np.abs(ref[:, :3, :3] - T[:, :3, :3]).max(axis=(1, 2))
    assert np.median(err) < 2 * np.median(err_ref) + 1e-3


def test_sentinel_scale_points_stay_finite():
    """Points at the 1e4 scale of the engine's pad sentinels: without the
    scale normalization of the N matrix the squaring cascade overflows."""
    rng = np.random.default_rng(7)
    p = (1e4 * rng.normal(size=(32, 3, 3))).astype(np.float32)
    q = (1e4 * rng.normal(size=(32, 3, 3))).astype(np.float32)
    _proper_and_finite(tao.horn_quaternion(*to_torch((p, q), "cpu")))
    _proper_and_finite(tao.horn_from_moments(to_torch(_moments(p, q), "cpu"), iters=4))
