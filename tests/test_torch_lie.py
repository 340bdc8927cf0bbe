"""core/lie.py of the PyTorch port against the JAX package's, same inputs.

Tolerance 1e-6 absolute throughout: both sides evaluate the same f32
formulas on the CPU; only the order of a few additions inside the 3x3
products and the libm behind sin/cos differ."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core import lie as jlie
from rgbd_pose_estimation_tpu_torch.core import lie as tlie
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch

ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's function, jitted: one compile per shape instead of
    one per primitive and shape."""
    return jax.jit(getattr(jlie, name))


def _both(name, *arrays):
    ref = _jax(name)(*[jnp.asarray(a) for a in arrays])
    out = getattr(tlie, name)(*to_torch(list(arrays), "cpu"))
    return ref, out


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _twists(seed, shape, scale=0.7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name,width", [("so3_hat", 3), ("so3_exp", 3), ("se3_exp", 6)])
def test_exponentials(name, width):
    ref, out = _both(name, _twists(0, (2, 7, width)))
    assert out.shape == tuple(ref.shape) and out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("name,width", [("so3_exp", 3), ("se3_exp", 6)])
def test_small_angle_branch(name, width):
    # Angles below and just above the 1e-4 switch, and exactly zero.
    w = _twists(1, (6, width), scale=1.0)
    w /= np.linalg.norm(w[:, -3:], axis=-1, keepdims=True)
    w[:, -3:] *= np.array([0.0, 1e-7, 5e-5, 9.9e-5, 1.01e-4, 3e-4], np.float32)[:, None]
    ref, out = _both(name, w)
    assert np.isfinite(out.numpy()).all()
    _close(out, ref)


def _poses(seed, shape):
    return np.asarray(_jax("se3_exp")(jnp.asarray(_twists(seed, shape + (6,)))))


def test_rt_to_matrix_broadcasts():
    T = _poses(2, (5,))
    t = _twists(3, (4, 1, 3))
    ref, out = _both("rt_to_matrix", T[:, :3, :3], t)
    assert out.shape == (4, 5, 4, 4)
    _close(out, ref)
    R, tt = tlie.matrix_to_rt(out)
    np.testing.assert_array_equal(R[0].numpy(), T[:, :3, :3])
    assert tt.shape == (4, 5, 3)


@pytest.mark.parametrize("name", ["se3_inverse", "se3_compose", "se3_apply"])
def test_group_operations(name):
    A = _poses(4, (3, 5))
    second = {
        "se3_inverse": (),
        "se3_compose": (_poses(5, (3, 5)),),
        "se3_apply": (_twists(6, (3, 5, 11, 3), scale=2.0),),
    }[name]
    ref, out = _both(name, A, *second)
    _close(out, ref)


def test_inverse_composes_to_identity():
    A = to_torch(_poses(7, (9,)), "cpu")
    eye = tlie.se3_compose(A, tlie.se3_inverse(A))
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(4), (9, 4, 4)), atol=1e-6)


def test_quat_to_rotmat():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(16, 4)).astype(np.float32)  # not unit: normalized inside
    ref, out = _both("quat_to_rotmat", q)
    _close(out, ref)
    np.testing.assert_allclose(np.linalg.det(out.numpy()), 1.0, atol=1e-5)


# --- logarithms, adjoint, quaternions: the cases of tests/unit/test_lie.py ---


def _rand_twists(seed, n, scale):
    """Rotation angles strictly below pi, so log is the exact inverse."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)) * scale
    ang = np.linalg.norm(xi[:, 3:], axis=-1, keepdims=True)
    xi[:, 3:] *= np.minimum(1.0, 0.9 * np.pi / np.maximum(ang, 1e-9))
    return xi.astype(np.float32)


def test_hat_vee_roundtrip():
    w = _twists(10, (17, 3))
    ref, out = _both("so3_vee", np.asarray(_jax("so3_hat")(jnp.asarray(w))))
    _close(out, ref)
    np.testing.assert_array_equal(tlie.so3_vee(tlie.so3_hat(to_torch(w, "cpu"))).numpy(), w)


# 1e-5 on the logarithms: acos of a trace near ±1 amplifies the last bit of
# the rotation's entries (the two libms differ there), and the result is an
# angle of order 1.
@pytest.mark.parametrize("scale", [0.9, 1.2])
def test_so3_log(scale):
    R = np.asarray(_jax("so3_exp")(jnp.asarray(_rand_twists(11, 128, scale)[:, 3:])))
    ref, out = _both("so3_log", R)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    w = _rand_twists(11, 128, scale)[:, 3:]
    np.testing.assert_allclose(out.numpy(), w, atol=1e-4)  # exp, then log: the round trip


def test_so3_log_near_identity_and_pi():
    w = np.array([[1e-6, -2e-6, 3e-7], [0.0, 0.0, 0.0], [5e-5, 0.0, 0.0]], np.float32)
    R = np.asarray(_jax("so3_exp")(jnp.asarray(w)))
    ref, out = _both("so3_log", R)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(out.numpy(), w, atol=1e-6)
    # Near pi, about three different axes: exp(log(R)) must reproduce R even
    # if the twist flips sign, in both packages.
    axes = np.array([[0.6, 0.8, 0.0], [0.0, -0.6, 0.8], [0.8, 0.0, 0.6], [1.0, 0.0, 0.0]], np.float32)
    for gap in (1e-4, 5e-4, 2e-3, 1e-2):
        R = np.asarray(_jax("so3_exp")(jnp.asarray(axes * np.float32(np.pi - gap))))
        ref, out = _both("so3_log", R)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
        assert np.isfinite(out.numpy()).all()
        if gap < 1e-3:  # the near-pi branch
            np.testing.assert_allclose(tlie.so3_exp(out).numpy(), R, atol=1e-3)


def test_so3_log_loses_the_axis_just_outside_the_near_pi_branch():
    """A fault of the reference, ported as it is: between 1e-3 and ~1e-2 of
    pi the generic branch divides by sin(theta) ~ 1e-3 and exp(log(R)) misses
    R by up to 2e-2, in both packages alike."""
    axes = np.array([[0.6, 0.8, 0.0], [0.0, -0.6, 0.8]], np.float32)
    R = np.asarray(_jax("so3_exp")(jnp.asarray(axes * np.float32(np.pi - 2e-3))))
    ref, out = _both("so3_log", R)
    miss = np.abs(tlie.so3_exp(out).numpy() - R).max()
    miss_ref = np.abs(np.asarray(_jax("so3_exp")(ref)) - R).max()
    assert 1e-3 < miss < 5e-2 and 1e-3 < miss_ref < 5e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_se3_log_and_roundtrip():
    xi = _rand_twists(12, 128, 0.8)
    T = np.asarray(_jax("se3_exp")(jnp.asarray(xi)))
    ref, out = _both("se3_log", T)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), xi, atol=2e-4)
    ref, out = _both("_left_jacobian_inv", xi[:, 3:])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # batched over two leading axes, identity included
    T2 = np.concatenate([T[:6], np.eye(4, dtype=np.float32)[None]]).reshape(1, 7, 4, 4)
    ref, out = _both("se3_log", T2)
    assert out.shape == (1, 7, 6) and not out[0, 6].any()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_se3_matrix_and_adjoint():
    T = _poses(13, (9,))
    xi = _twists(14, (9, 6), scale=0.3)
    ref, out = _both("se3_matrix", T[:, :3, :3], T[:, :3, 3])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref, out = _both("se3_adjoint", T)
    assert out.shape == (9, 6, 6)
    _close(out, ref)
    # T exp(xi) T^-1 = exp(Ad_T xi)
    Tt = to_torch(T, "cpu")
    lhs = Tt @ tlie.se3_exp(to_torch(xi, "cpu")) @ tlie.se3_inverse(Tt)
    rhs = tlie.se3_exp(torch.einsum("bij,bj->bi", out, to_torch(xi, "cpu")))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)


def test_rotmat_to_quat_covers_all_pivots():
    # Rotations near 0 and near pi about each axis exercise all four of
    # Shepperd's branches.
    ws = np.array(
        [[0.0, 0.0, 0.0], [np.pi - 0.01, 0.0, 0.0], [0.0, np.pi - 0.01, 0.0],
         [0.0, 0.0, np.pi - 0.01], [1.0, -1.2, 0.7]], np.float32)
    R = np.concatenate([np.asarray(_jax("so3_exp")(jnp.asarray(ws))), _poses(15, (20,))[:, :3, :3]])
    ref, out = _both("rotmat_to_quat", R)
    _close(out, ref)
    assert (out[:, 0] >= 0).all()  # canonical sign
    np.testing.assert_allclose(tlie.quat_to_rotmat(out).numpy(), R, atol=1e-5)
