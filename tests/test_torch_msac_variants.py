"""ops/msac_variants.py of the PyTorch port against the JAX repository's
tools/msac_opt.py: each variant's plain version (what the port's wrappers
run for CPU tensors) against the tool's own Pallas kernel, run by the
interpreter, and against the JAX package's exact scorer. The CUDA kernels
T1, T2, T3 and T5 are held against these plain versions on the card by
chip_smoke.py."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rgbd_pose_estimation_tpu.core.lie import se3_exp as jax_se3_exp
from rgbd_pose_estimation_tpu.ops import ransac_score as jscore
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops import msac_variants as mv
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import _quad_features
from tools import msac_opt as jmsac

K, N, TAU = 256, 128, 0.3
# Per-entry error scale of the 17-term quad form: gamma times the sum of its
# terms' absolute values. The terms (of order 1-10 here) cancel down to
# residuals near tau^2, so f32 rounding is absolute at the terms' scale;
# 1e-5 is ~10 times 17 f32 roundings.
GAMMA = 1e-5


@pytest.fixture(scope="module")
def problem():
    """se3_exp poses, pose 0 explaining 80 of 128 rows to 0.05 noise (so
    residuals fall on both sides of tau^2), pose 5 NaN."""
    rng = np.random.default_rng(0)
    T = np.array(jax_se3_exp(jnp.asarray(rng.normal(size=(K, 6)) * 0.3, jnp.float32)))
    p = rng.normal(size=(N, 3)).astype(np.float32)
    q = rng.normal(size=(N, 3)).astype(np.float32)
    q[:80] = (p[:80] @ T[0, :3, :3].T + T[0, :3, 3] + 0.05 * rng.normal(size=(80, 3))).astype(np.float32)
    T[5] = np.nan
    return T, p, q


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _direct_f64(T, p, q):
    """e = |R p + t - q|^2 in float64, (K, N), and its terms' scale."""
    R, t = T[:, :3, :3].astype(np.float64), T[:, :3, 3].astype(np.float64)
    pred = np.einsum("kij,nj->kni", R, p.astype(np.float64)) + t[:, None]
    e = np.sum((pred - q[None].astype(np.float64)) ** 2, axis=-1)
    return e, np.abs(e) + np.sum(np.abs(pred) * np.abs(q[None]), axis=-1)


def _quad_f64(T, p, q):
    """The quad form of the same f32 features in float64, (K, N), and beside
    every entry the sum of its terms' absolute values."""
    feat, pn = (x.double().numpy() for x in _quad_features(*_t(T, p, q)))
    return feat @ pn, np.abs(feat) @ np.abs(pn)


def _assert_within(msac, count, e64, scale, what):
    """msac and count against float64 entries e64: an entry within
    GAMMA·scale of tau^2 may land on either side (its count may flip), and an
    entry below tau^2 + GAMMA·scale may move its min by GAMMA·scale. NaN
    must sit where float64 has it."""
    tau2 = TAU * TAU
    bound = GAMMA * scale
    nan = np.isnan(e64).any(axis=1)
    assert np.array_equal(np.isnan(msac), nan), what
    ok = ~nan
    m64 = np.minimum(e64, tau2).sum(axis=1)
    c64 = (e64 < tau2).sum(axis=1)
    m_bound = np.where(e64 < tau2 + bound, bound, 0.0).sum(axis=1) + 1e-5 * np.abs(m64)
    c_bound = (np.abs(e64 - tau2) <= bound).sum(axis=1)
    assert (np.abs(msac - m64)[ok] <= m_bound[ok]).all(), what
    assert (np.abs(count - c64)[ok] <= c_bound[ok]).all(), what
    assert (count[nan] == 0).all(), what


@pytest.mark.parametrize("kt", [128, 256])
def test_A_and_D_match_pallas_kernels_interpreted(problem, kt):
    """T1 and T5: 1e-5 relative on the scores (N f32 terms summed in another
    order); counts equal except where a residual sits within rounding of
    tau^2 (bounded per pose from float64)."""
    T, p, q = problem
    with pltpu.force_tpu_interpret_mode():
        m_ref, c_ref = jmsac.variant_A(*_j(T, p, q), TAU, KT=kt)
        d_ref = jmsac.variant_D(*_j(T, p, q), TAU, KT=kt)
    m, c = mv.variant_A(*_t(T, p, q), TAU)
    d = mv.variant_D(*_t(T, p, q), TAU)
    assert m.shape == c.shape == d.shape == (K,) and m.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-5)
    e64, scale = _direct_f64(T, p, q)
    flip = (np.abs(e64 - TAU * TAU) <= GAMMA * scale).sum(axis=1)
    ok = ~np.isnan(m.numpy())
    assert (np.abs(c.numpy() - np.asarray(c_ref))[ok] <= flip[ok]).all()
    assert np.isnan(m.numpy()[5]) and np.isnan(d.numpy()[5]) and float(c[5]) == 0.0


@pytest.mark.parametrize("kt", [128, 256])
def test_C_and_M_match_pallas_kernels_interpreted(problem, kt):
    """T2 and T3 against their Pallas kernels and both against float64 of
    the same features, within the quad form's absolute bound (GAMMA times
    the terms' magnitude, per entry)."""
    T, p, q = problem
    e64, scale = _quad_f64(T, p, q)
    for name, jfn, fn in (("C", jmsac.variant_C, mv.variant_C), ("M", jmsac.variant_M, mv.variant_M)):
        with pltpu.force_tpu_interpret_mode():
            m_ref, c_ref = jfn(*_j(T, p, q), TAU, KT=kt)
        m, c = fn(*_t(T, p, q), TAU)
        _assert_within(m.numpy(), c.numpy(), e64, scale, f"{name} (port, plain)")
        _assert_within(np.asarray(m_ref), np.asarray(c_ref), e64, scale, f"{name} (Pallas kernel)")


def test_variants_match_exact_scorer(problem):
    """Every variant against the JAX package's exact scorer on orthonormal
    poses: A and D as the scorer itself (1e-5), C, M and X-highest within
    the quad form's bound against float64 of the direct residual."""
    T, p, q = problem
    m_ex, c_ex = (np.asarray(x) for x in jscore.score_poses_3d3d_reference(*_j(T, p, q), TAU))
    m, c = mv.variant_A(*_t(T, p, q), TAU)
    np.testing.assert_allclose(m.numpy(), m_ex, rtol=1e-5)
    np.testing.assert_allclose(mv.variant_D(*_t(T, p, q), TAU).numpy(), m_ex, rtol=1e-5)
    e64, _ = _direct_f64(T, p, q)
    _, quad_scale = _quad_f64(T, p, q)
    for name, fn in (("C", mv.variant_C), ("M", mv.variant_M),
                     ("X-highest", lambda *a: mv.variant_X(*a, precision="highest"))):
        mq, cq = fn(*_t(T, p, q), TAU)
        _assert_within(mq.numpy(), cq.numpy(), e64, quad_scale, name)


def test_library_route_bf16_and_arguments(problem):
    """variant_X with bf16 operands: an entry carries three bf16
    roundings (two operands and the bf16 product, 2^-8 each) of its terms'
    scale; outside a band of 2^-6 of that scale around tau^2 its count is
    the exact one. Unknown precisions and poses-per-thread values raise."""
    T, p, q = problem
    m, c = mv.variant_X(*_t(T, p, q), TAU)
    e64, scale = _quad_f64(T, p, q)
    band = (np.abs(e64 - TAU * TAU) <= 2**-6 * scale).sum(axis=1)
    ok = ~np.isnan(m.numpy())
    assert (np.abs(c.numpy() - (e64 < TAU * TAU).sum(axis=1))[ok] <= band[ok]).all()
    with pytest.raises(ValueError, match="precision"):
        mv.variant_X(*_t(T, p, q), TAU, precision="high")
    for fn in (mv.variant_A, mv.variant_D):
        with pytest.raises(ValueError, match="poses_per_thread"):
            fn(*_t(T, p, q), TAU, poses_per_thread=3)


def test_kernel_sources_keep_their_contracts():
    """Nothing compiles here, so this reads the sources: T3 multiplies on
    the tensor cores with the warpgroup MMA in TF32, three passes (3xTF32),
    its operands split by cvt.rna and pn brought in by cp.async; K1 is
    instantiated over the sample size m at compile time; K2 and T2 are one
    kernel with K2's flags unchanged; K3, K5, T1 and T5 are instances of the
    one exact-MSAC header, and score2d.cu has no kernel of its own; no
    floating-point atomics and no fminf (which would drop NaN); the 2D-3D
    division is IEEE (no __fdividef, and the compiler's division wherever the
    reciprocal's fast path is not exact)."""
    src = {p.name: p.read_text() for p in _build._CSRC.glob("*.cu*")}
    mma = src["quad_mma.cu"]
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k8\.f32\.tf32\.tf32", mma)
    assert "mma.sync" not in mma  # no second design beside it
    # lo*hi, hi*lo, hi*hi per k-step
    assert mma.count("(d, a_lo, desc);") == 1 and mma.count("(d, a_hi, desc);") == 2
    assert "cvt.rna.tf32.f32" in mma and "cp.async.cg.shared.global" in mma
    moments = src["moments.cu"]
    assert "template <int kM>" in moments
    assert all(f"case {m}: launch<{m}>(" in moments for m in range(1, 9))
    assert "quad_score_kernel<true, true, false>" in src["quad_score.cu"]
    assert "quad_score_kernel<false, false, true>" in src["quad_score.cu"]
    assert "score3d.cuh" not in src
    for name in ("score3d.cu", "score2d.cu", "msac_variants.cu"):
        assert '#include "msac_exact.cuh"' in src[name], name
    assert "__global__" not in src["score3d.cu"] + src["score2d.cu"]
    # msac_variants.cu's one kernel of its own checks K5's reciprocal.
    assert src["msac_variants.cu"].count("__global__") == 1
    assert "reciprocal_check_kernel(" in src["msac_variants.cu"]
    assert "Residual3D3D" in src["score3d.cu"] and "Residual2D3D" in src["score2d.cu"]
    assert src["msac_variants.cu"].count("launch_poses<msac_exact::Residual3D3D") == 2
    for name in ("quad_mma.cu", "msac_variants.cu", "msac_exact.cuh", "ceilings.cu", "score2d.cu"):
        code = src[name].split("#include", 1)[1]
        assert "atomicAdd" not in code and "fminf" not in code, name
    for name in ("msac_exact.cuh", "score2d.cu"):
        assert "__fdividef" not in src[name].split("#include", 1)[1], name
    assert "iz[g] = 1.f / z[g]" in src["msac_exact.cuh"]  # the division where rcp_rn_normal is not exact
    assert "use_fast_math" not in " ".join(_build._NVCC_FLAGS)
    assert {"msac_variant_a", "msac_variant_c", "msac_variant_m", "msac_variant_d"} <= set(_build._SIGNATURES)


def test_cpu_tensors_take_the_plain_versions(problem):
    """A CPU tensor runs the plain version and launches nothing."""
    T, p, q = problem
    _build.reset_launch_counts()
    for fn in (mv.variant_A, mv.variant_C, mv.variant_M, mv.variant_D):
        fn(*_t(T, p, q), TAU)
    assert all(v == 0 for v in _build.launch_counts().values())
    for x, y in zip(mv.variant_A(*_t(T, p, q), TAU), mv.variant_A_reference(*_t(T, p, q), TAU)):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
