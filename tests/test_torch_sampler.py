"""ransac/prosac.py of the PyTorch port against the JAX package's."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.ransac import prosac as jprosac
from rgbd_pose_estimation_tpu_torch.ransac import prosac as tprosac
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch


@pytest.mark.parametrize(
    "n,k,m", [(200, 512, 3), (1000, 512, 3), (2048, 4096, 3), (50, 256, 4), (3, 64, 3)]
)
def test_prosac_windows_equal(n, k, m):
    assert tprosac.prosac_windows(n, k, m) == jprosac.prosac_windows(n, k, m)


@pytest.mark.parametrize("prosac", [True, False])
@pytest.mark.parametrize("n,k,m", [(200, 512, 3), (37, 256, 4)])
def test_shifted_draw_identical_from_same_uniforms(n, k, m, prosac):
    """The JAX sampler draws u = uniform(key, (K, m)) and then does f32
    arithmetic on it; given the same u the port must give the very same
    integers (a floor of an f32 product: no tolerance applies)."""
    key = jax.random.key(5)
    ref = np.asarray(jprosac.sample_minimal_sets(key, n, k, m, prosac))
    u = np.asarray(jax.random.uniform(key, (k, m)))
    win = tprosac._windows_tensor(n, k, m, prosac, "cpu")
    out = tprosac.shifted_draw(to_torch(u, "cpu"), win)
    assert out.dtype == torch.int32 and out.shape == (k, m)
    np.testing.assert_array_equal(out.numpy(), ref)


def _generator(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("method", ["shifted", "gumbel"])
def test_rows_distinct_and_inside_windows(method):
    n, k, m = 300, 512, 3
    idx = tprosac.sample_minimal_sets(_generator(0), n, k, m, True, method, device="cpu")
    assert idx.dtype == torch.int32 and idx.shape == (k, m)
    idx = idx.numpy()
    w = np.asarray(tprosac.prosac_windows(n, k, m))
    assert idx.min() >= 0 and np.all(idx.max(axis=1) < w)
    assert all(len(set(row.tolist())) == m for row in idx)


def test_window_equal_to_sample_size_gives_permutations():
    idx = tprosac.sample_minimal_sets(_generator(1), 3, 256, 3, prosac=False, device="cpu")
    assert all(sorted(row.tolist()) == [0, 1, 2] for row in idx.numpy())


@pytest.mark.parametrize("method,k", [("shifted", 20000), ("gumbel", 4000)])
def test_marginal_is_uniform(method, k):
    """Without PROSAC every index is equally likely: each count is
    binomial(k*m, 1/n), and 6 standard deviations is the repo's own bound
    for this check (tests/unit/test_sampler.py)."""
    n, m = 50, 3
    idx = tprosac.sample_minimal_sets(_generator(2), n, k, m, False, method, device="cpu")
    counts = np.bincount(idx.numpy().reshape(-1), minlength=n)
    expected = k * m / n
    assert np.all(np.abs(counts - expected) < 6 * np.sqrt(expected))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown sampling method"):
        tprosac.sample_minimal_sets(_generator(3), 10, 8, 3, method="nope", device="cpu")
