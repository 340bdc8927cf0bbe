"""core/poly.py of the PyTorch port against the JAX package's: the masked
closed-form cubic and quartic solvers, from the same coefficients."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core import poly as jpoly
from rgbd_pose_estimation_tpu_torch.core import poly as tpoly
from rgbd_pose_estimation_tpu_torch.utils.convert import to_torch


def _both(fn, coeffs):
    """``fn`` ("solve_cubic_real" / "solve_quartic_real") of both packages on
    the same f32 coefficient columns → ((roots, valid) JAX, (roots, valid) port)."""
    cols = [np.asarray(c, np.float32) for c in coeffs]
    ref = getattr(jpoly, fn)(*(jnp.asarray(c) for c in cols))
    out = getattr(tpoly, fn)(*to_torch(cols, "cpu"))
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.bool
    return tuple(np.asarray(x) for x in ref), tuple(x.numpy() for x in out)


# The five cases of tests/unit/test_solvers.py::TestPoly.
_CASES = {
    # (x-1)(x-2)(x-3) = x^3 - 6x^2 + 11x - 6
    "cubic_three_real": ("solve_cubic_real", [[-6.0], [11.0], [-6.0]], [1.0, 2.0, 3.0], 1e-4),
    # (x-2)(x^2+1) = x^3 - 2x^2 + x - 2
    "cubic_one_real": ("solve_cubic_real", [[-2.0], [1.0], [-2.0]], [2.0], 1e-4),
    # (x-1)(x+1)(x-2)(x+3) = x^4 + x^3 - 7x^2 - x + 6
    "quartic_four_real": (
        "solve_quartic_real", [[1.0], [1.0], [-7.0], [-1.0], [6.0]], [-3.0, -1.0, 1.0, 2.0], 1e-3),
    # (x-1)(x-2)(x^2+1) = x^4 - 3x^3 + 3x^2 - 3x + 2
    "quartic_two_real": (
        "solve_quartic_real", [[1.0], [-3.0], [3.0], [-3.0], [2.0]], [1.0, 2.0], 1e-3),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_known_polynomial(case):
    """Each textbook case: the port finds the true real roots to the bound the
    JAX package's own test asks (1e-4 cubic, 1e-3 quartic), flags the same
    slots valid, and agrees with the JAX roots to 1e-5 (the same f32 formulas,
    polished by the same Newton steps, far from any double root)."""
    fn, coeffs, true, atol = _CASES[case]
    (r_ref, v_ref), (r_out, v_out) = _both(fn, coeffs)
    np.testing.assert_array_equal(v_out, v_ref)
    np.testing.assert_allclose(r_out, r_ref, atol=1e-5)
    got = np.unique(np.round(r_out[0][v_out[0]], 3))
    np.testing.assert_allclose(got, true, atol=atol)
    assert np.isfinite(r_out).all()  # invalid slots hold finite dummies


def test_quartic_batch_random_recovers_roots():
    """The 64 monic quartics of the JAX package's test, from real roots in
    [-2, 2]: all valid, sorted roots within its 5e-2 of the truth (two roots
    that nearly coincide are ill-conditioned in f32), and within 1e-3 of the
    JAX package's sorted roots."""
    rng = np.random.default_rng(0)
    true = np.sort(rng.uniform(-2, 2, size=(64, 4)), axis=-1)
    c = np.stack([np.poly(r) for r in true])
    (r_ref, v_ref), (r_out, v_out) = _both("solve_quartic_real", c.T)
    assert v_out.all() and v_ref.all()
    np.testing.assert_allclose(np.sort(r_out, axis=-1), true, atol=5e-2)
    np.testing.assert_allclose(np.sort(r_out, axis=-1), np.sort(r_ref, axis=-1), atol=1e-3)


def test_4096_random_quartics_with_known_roots():
    """4096 quartics a4·Π(x − r_i), a4 in [0.5, 2]: half with four real roots
    in [-2, 2], half with two real roots and a complex pair u ± iv.

    Slot by slot, ``valid`` is equal and the roots agree within
    1e-4·max(1, |x|), except on at most 1% of the problems. Those must all
    sit next to a double root: the branch ``disc >= 0`` of a quadratic factor
    is taken on an f32 value that cancels, XLA and PyTorch round it
    differently (fused multiply-add or not), and the flag of the root pair
    flips; the same cancellation makes the pair itself ill-conditioned. The
    factor's discriminant is ((r_i − r_j)/2)² for the closest pair of roots
    (−v² for the complex pair): the exceptions must have it within 1e-4 of
    zero, relative to max(1, |r|max²)."""
    rng = np.random.default_rng(1)
    n = 4096
    real = rng.uniform(-2, 2, size=(n, 4))
    u, v = rng.uniform(-2, 2, size=n), rng.uniform(0.0, 1.5, size=n)
    with_pair = np.arange(n) % 2 == 1
    roots = real.astype(complex)
    roots[with_pair, 2] = (u + 1j * v)[with_pair]
    roots[with_pair, 3] = (u - 1j * v)[with_pair]
    a4 = rng.uniform(0.5, 2.0, size=n)
    c = np.stack([np.real(np.poly(r)) * a for r, a in zip(roots, a4)])
    (r_ref, v_ref), (r_out, v_out) = _both("solve_quartic_real", c.T)

    tol = 1e-4 * np.maximum(1.0, np.abs(r_ref))
    both = v_ref & v_out
    bad = (v_ref != v_out).any(-1) | ((np.abs(r_out - r_ref) > tol) & both).any(-1)
    assert bad.mean() <= 0.01, f"{int(bad.sum())} of {n} problems disagree"

    # Discriminant of the closest pair, relative.
    i, j = np.triu_indices(4, 1)
    gap2 = (np.abs(roots[:, i] - roots[:, j]) ** 2 / 4.0).min(-1)
    rel = gap2 / np.maximum(1.0, np.abs(roots).max(-1) ** 2)
    assert (rel[bad] < 1e-4).all(), rel[bad].max()

    # The port itself is right: where it flags a root valid it is a root.
    x = r_out.astype(np.float64)
    f = np.zeros_like(x)
    for k in range(5):
        f = f * x + c[:, k : k + 1]
    scale = sum(np.abs(c[:, k : k + 1]) * np.abs(x) ** (4 - k) for k in range(5))
    assert (np.abs(f) <= 1e-4 * scale)[v_out].mean() > 0.995
    # ... and away from a double root it finds the real roots: four, or two.
    apart = rel >= 1e-4
    assert (v_out.sum(-1)[apart] == np.where(with_pair, 2, 4)[apart]).all()
    assert np.isfinite(r_out).all()


def test_cubic_batch_matches_reference():
    """1024 random cubics with coefficients in [-3, 3]: ``valid`` equal and
    roots within 1e-4·max(1, |x|) on at least 99% of the problems (the branch
    ``disc >= 0`` flips next to a double root, as above)."""
    rng = np.random.default_rng(2)
    c = rng.uniform(-3, 3, size=(3, 1024))
    (r_ref, v_ref), (r_out, v_out) = _both("solve_cubic_real", c)
    assert r_out.shape == (1024, 3) and v_out[:, 0].all()
    tol = 1e-4 * np.maximum(1.0, np.abs(r_ref))
    bad = (v_ref != v_out).any(-1) | (np.abs(r_out - r_ref) > tol).any(-1)
    assert bad.mean() <= 0.01


def test_leading_axes_and_degenerate_leading_coefficient():
    """Batched over any leading axes; a vanishing leading coefficient is
    clamped, not divided by: finite output, as in the JAX package."""
    rng = np.random.default_rng(3)
    c = rng.uniform(-2, 2, size=(5, 3, 7)).astype(np.float32)
    c[0, 0, 0] = 0.0
    (r_ref, v_ref), (r_out, v_out) = _both("solve_quartic_real", c)
    assert r_out.shape == (3, 7, 4) and v_out.shape == (3, 7, 4)
    assert np.isfinite(r_out).all() and np.isfinite(r_ref).all()
    assert (v_out == v_ref).mean() >= 0.9
