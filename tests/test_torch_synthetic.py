"""The depth scenes and sequences of data/synthetic.py: the PyTorch port
against the JAX package, on the CPU.

The two frameworks draw different random numbers from the same seed, so each
test takes the JAX package's draws (recomputed here from its keys) and hands
them to the port; everything downstream of the draws is compared.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
from rgbd_pose_estimation_tpu.data import synthetic as jsyn
from rgbd_pose_estimation_tpu_torch.data import synthetic as tsyn
from rgbd_pose_estimation_tpu_torch.utils.convert import camera_from_reference, to_torch

JCAM = JCamera(80.0, 80.0, 39.5, 29.5, 80, 60)
CAM = camera_from_reference(JCAM)
FRAMES = 4


def test_hash_noise_is_bit_equal():
    """int32 products that wrap around by design, arithmetic shifts: held to
    the original exactly, negative and large lattice coordinates included."""
    rng = np.random.default_rng(0)
    ijk = rng.integers(-(2**20), 2**20, size=(3, 5000)).astype(np.int32)
    ijk[:, :6] = [[0, -1, 1, 2**30, -(2**31), 2**31 - 1]] * 3
    ref = np.asarray(jsyn._hash_noise(*[jnp.asarray(a) for a in ijk]))
    out = tsyn._hash_noise(*to_torch(list(ijk), "cpu")).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.min() >= 0.0 and out.max() <= 1.0 and len(np.unique(out)) > 1000


def test_texture_on_seeded_points():
    """The lattice hash is exact; the shading term 0.1·sin·cos goes through
    two libms, hence 1e-6."""
    rng = np.random.default_rng(1)
    pts = (rng.uniform(-3.0, 3.0, size=(4000, 3))).astype(np.float32)
    ref = np.asarray(jsyn._texture(jnp.asarray(pts)))
    out = tsyn._texture(to_torch(pts, "cpu")).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_raycast():
    rng = np.random.default_rng(2)
    o = (rng.normal(size=(3000, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(3000, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + np.float32(0.5)
    d[:3, 2] = [0.0, 1e-10, -1e-10]  # rays parallel to the back plane
    ref = np.asarray(jsyn._raycast(jnp.asarray(o), jnp.asarray(d)))
    out = tsyn._raycast(*to_torch([o, d], "cpu")).numpy()
    assert (ref > 0).mean() > 0.5
    # 1e-4 relative: a quadratic's root, b² − 4ac cancels near a sphere's rim
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def _pose(xi):
    from rgbd_pose_estimation_tpu.core.lie import se3_exp

    return np.asarray(se3_exp(jnp.asarray(xi, jnp.float32)))


@pytest.mark.parametrize("xi", [[0.0] * 6, [0.05, -0.03, 0.04, 0.02, -0.03, 0.01]])
def test_synthetic_depth_scene(xi):
    T = _pose(xi)
    d_ref, i_ref = (np.asarray(a) for a in jsyn.synthetic_depth_scene(JCAM, jnp.asarray(T)))
    d, i = (a.numpy() for a in tsyn.synthetic_depth_scene(CAM, to_torch(T, "cpu")))
    assert d.shape == i.shape == (60, 80) and (d > 0).all()
    # Depth: 1e-5 m, except where the two pick different surfaces at a
    # sphere's silhouette (a tie decided by the last bit).
    assert (np.abs(d - d_ref) > 1e-5).mean() < 0.002
    # Intensity: a hit within rounding of a 2.5 cm lattice boundary lands in
    # the neighbouring block, whose value is unrelated.
    assert (np.abs(i - i_ref) > 1e-5).mean() < 0.02


def test_kinect_degrade_with_the_reference_draws():
    key = jax.random.key(3)
    depth = np.asarray(jsyn.synthetic_depth_scene(JCAM, jnp.eye(4))[0])
    ref = np.asarray(jsyn.kinect_degrade(key, jnp.asarray(depth), border=4))
    k1, k2 = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k1, depth.shape))
    seed = int(jax.random.randint(k2, (), 0, 1 << 30))
    out = tsyn.kinect_degrade(
        None, to_torch(depth, "cpu"), border=4, noise=to_torch(noise, "cpu"), dropout_seed=seed
    ).numpy()
    # The holes (shadows, hashed dropout blobs, border) are the same pixels.
    np.testing.assert_array_equal(out == 0, ref == 0)
    assert 0.02 < (out == 0).mean() < 0.6 and not out[:4].any() and not out[:, -4:].any()
    # Depth is quantized to disparity steps (centimetres at 3 m): equal,
    # except where a disparity lands within rounding of a step's edge.
    assert (np.abs(out - ref) > 1e-6).mean() < 0.002
    # Drawn from a generator, the same model gives another sample of it.
    g = torch.Generator().manual_seed(0)
    own = tsyn.kinect_degrade(g, to_torch(depth, "cpu"), border=4).numpy()
    assert own.shape == ref.shape and 0.02 < (own == 0).mean() < 0.6
    assert np.abs(own - depth)[own > 0].max() < 0.1


def test_handheld_trajectory():
    key = jax.random.key(4)
    ref = np.asarray(jsyn.handheld_trajectory(key, 6))
    deltas = np.asarray(jax.random.normal(key, (6, 6)))
    out = tsyn.handheld_trajectory(None, 6, deltas=to_torch(deltas, "cpu")).numpy()
    np.testing.assert_array_equal(out[0], np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(out, ref, atol=1e-6)
    own = tsyn.handheld_trajectory(torch.Generator().manual_seed(1), 6, device="cpu")
    assert own.shape == (6, 4, 4) and own.dtype == torch.float32


@pytest.fixture(scope="module")
def reference_sequence():
    key = jax.random.key(5)
    poses, depths, intens = jsyn.synthetic_sequence(JCAM, key, FRAMES, 0.02)
    deltas = np.asarray(jax.random.normal(key, (FRAMES, 6)))
    return np.asarray(poses), np.asarray(depths), np.asarray(intens), deltas


def test_synthetic_sequence(reference_sequence):
    poses_ref, depths_ref, intens_ref, deltas = reference_sequence
    poses, depths, intens = tsyn.synthetic_sequence(
        CAM, None, FRAMES, 0.02, deltas=to_torch(deltas, "cpu")
    )
    np.testing.assert_allclose(poses.numpy(), poses_ref, atol=1e-6)
    assert depths.shape == intens.shape == (FRAMES, 60, 80)
    assert (np.abs(depths.numpy() - depths_ref) > 1e-5).mean() < 0.002
    assert (np.abs(intens.numpy() - intens_ref) > 1e-5).mean() < 0.02


def test_synthetic_sequence_draws_on_its_device():
    g = torch.Generator().manual_seed(2)
    poses, depths, _ = tsyn.synthetic_sequence(CAM, g, 3, 0.02, device="cpu")
    assert poses.shape == (3, 4, 4) and depths.shape == (3, 60, 80)
    assert torch.equal(poses[0], torch.eye(4)) and not torch.equal(poses[1], poses[2])


def test_synthetic_sequence_hard_with_the_reference_draws():
    key = jax.random.key(6)
    ref = [np.asarray(a) for a in jsyn.synthetic_sequence_hard(JCAM, key, FRAMES, border=4)]
    k_traj, k_deg = jax.random.split(key)
    deltas = np.asarray(jax.random.normal(k_traj, (FRAMES, 6)))
    noise, seeds = [], []
    for k in jax.random.split(k_deg, FRAMES):
        k1, k2 = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k1, (60, 80))))
        seeds.append(int(jax.random.randint(k2, (), 0, 1 << 30)))
    out = tsyn.synthetic_sequence_hard(
        CAM, None, FRAMES, border=4, deltas=to_torch(deltas, "cpu"),
        noise=to_torch(np.stack(noise), "cpu"),
        dropout_seeds=torch.tensor(seeds, dtype=torch.int32),
    )
    poses, depths, intens, clean = (a.numpy() for a in out)
    np.testing.assert_allclose(poses, ref[0], atol=1e-6)
    assert (np.abs(clean - ref[3]) > 1e-5).mean() < 0.002
    assert (np.abs(intens - ref[2]) > 1e-5).mean() < 0.02
    # Holes and quantized depth: equal but for the silhouette and step-edge
    # pixels of the clean depth they were made from.
    assert ((depths == 0) != (ref[1] == 0)).mean() < 0.005
    assert (np.abs(depths - ref[1]) > 1e-6).mean() < 0.01
