"""ops/moments.py of the PyTorch port against the JAX package's kernel and
its jnp twin. On CPU tensors the port's wrapper runs its plain version,
which is what these tests reach; the CUDA kernel itself is held against
that plain version on the card by chip_smoke.py."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.ops import moments as jmoments
from rgbd_pose_estimation_tpu.solvers import absolute_orientation as jao
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops import moments as tmoments
from rgbd_pose_estimation_tpu_torch.solvers import absolute_orientation as tao
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch


def _case(seed, k, n, m, scale=1.0):
    rng = np.random.default_rng(seed)
    p = (scale * rng.normal(size=(n, 3))).astype(np.float32)
    q = (scale * rng.normal(size=(n, 3))).astype(np.float32)
    idx = np.stack([rng.choice(n, size=m, replace=False) for _ in range(k)]).astype(np.int32)
    return idx, p, q


@pytest.mark.parametrize("k,n,m", [(256, 128, 3), (512, 384, 4)])
def test_matches_pallas_kernel_interpreted(k, n, m):
    """Against the Pallas kernel run by the interpreter. 3e-5 is the JAX
    package's own bound for that kernel (tests/kernels/test_moments.py):
    its bf16 hi/lo split carries ~2^-17 relative error by design, which the
    gathering port does not have."""
    idx, p, q = _case(0, k, n, m)
    ref = jmoments.minimal_moments(jnp.asarray(idx), jnp.asarray(p), jnp.asarray(q), impl="interpret")
    out = tmoments.minimal_moments(*to_torch((idx, p, q), "cpu"))
    assert out.shape == (16, k) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize(
    "k,n,m", [(256, 128, 3), (1000, 100, 3), (7, 5, 1), (64, 200, 5), (33, 40, 2), (33, 40, 8)]
)
def test_matches_jnp_twin(k, n, m):
    """Against the gathering jnp twin, any (K, N, m). Both sum m f32
    products; 1e-6 relative is a few ulps, and the absolute 1e-6 covers
    sums that cancel to near zero, where one ulp of an addend (of order 1)
    is all that differs between two summation orders."""
    idx, p, q = _case(1, k, n, m)
    ref = jmoments.minimal_moments_reference(jnp.asarray(idx), jnp.asarray(p), jnp.asarray(q))
    out = tmoments.minimal_moments_reference(*to_torch((idx, p, q), "cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out.numpy()[15], float(m))


def test_row_layout():
    """Rows 0-2 Σp, 3-5 Σq, 6 + a*3 + b = Σ p_a q_b, 15 = m, in float64."""
    idx, p, q = _case(2, 64, 50, 3, scale=3.0)
    out = tmoments.minimal_moments(*to_torch((idx, p, q), "cpu")).numpy()
    pm, qm = p[idx].astype(np.float64), q[idx].astype(np.float64)
    np.testing.assert_allclose(out[0:3], pm.sum(1).T, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out[3:6], qm.sum(1).T, rtol=1e-6, atol=1e-5)
    for a in range(3):
        for b in range(3):
            np.testing.assert_allclose(
                out[6 + a * 3 + b], (pm[:, :, a] * qm[:, :, b]).sum(1), rtol=1e-6, atol=1e-5
            )


def test_hypotheses_from_moments_match_gather_path():
    """Hypothesize parity (tests/kernels/test_moments.py:60-80): Horn from
    the port's moments against the JAX package's gather → Horn, on
    noise-free correspondences. 5e-4 is that test's bound: the moment form
    of the covariance (Σpq − ΣpΣq/n) cancels where the gather form centres
    first, and a few near-collinear sets amplify that."""
    from rgbd_pose_estimation_tpu.core.lie import se3_apply, se3_exp

    idx, p, _ = _case(2, 512, 256, 3)
    T_true = se3_exp(jnp.asarray([0.2, -0.1, 0.3, 0.1, -0.2, 0.15]))
    q = np.asarray(se3_apply(T_true[None], jnp.asarray(p)[None])[0])
    mom = tmoments.minimal_moments(*to_torch((idx, p, q), "cpu"))
    T_mom = tao.horn_from_moments(mom).numpy()
    T_gat = np.asarray(jao.horn_quaternion(jnp.asarray(p)[idx], jnp.asarray(q)[idx]))
    assert np.abs(T_mom - np.asarray(T_true)[None]).max() < 5e-4
    np.testing.assert_allclose(T_mom, T_gat, atol=5e-4)


def test_cpu_tensors_launch_no_kernel():
    before = _build.launch_counts()
    tmoments.minimal_moments(*to_torch(_case(3, 8, 16, 3), "cpu"))
    assert _build.launch_counts() == before
