"""core/lie.py of the PyTorch port against the JAX package's, same inputs.

Tolerance 1e-6 absolute throughout: both sides evaluate the same f32
formulas on the CPU; only the order of a few additions inside the 3x3
products and the libm behind sin/cos differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core import lie as jlie
from rgbd_pose_estimation_tpu_torch.core import lie as tlie
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch

ATOL = 1e-6


def _both(name, *arrays):
    ref = getattr(jlie, name)(*[jnp.asarray(a) for a in arrays])
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
    return np.asarray(jlie.se3_exp(jnp.asarray(_twists(seed, shape + (6,)))))


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
