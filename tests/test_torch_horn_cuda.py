"""The 3D-3D estimator's Horn kernels (``ops/csrc/horn.cu``) against their
plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card and
``nvcc`` and skips without a card. Run them on one:

    python -m pytest tests/test_torch_horn_cuda.py -m cuda

No JAX here: the plain versions are ``horn_from_moments_reference`` and
``_refit_3d3d_reference``, run on the same CUDA tensors, whose CPU route the
JAX comparisons in ``test_torch_solvers.py`` and ``test_torch_engine.py``
hold.

Tolerances, and why:

- hypotheses: none; the poses must be the plain version's bits, on every
  set (well-conditioned, near-collinear, NaN, far from the origin). The
  kernel rounds every operation as the plain version does, in its order,
  with the same CUDA math functions (sqrtf, rsqrtf, atan2f, cosf, sinf
  and IEEE division give PyTorch's bits on this card).
- refit: 1e-5 on the pose. The block sums run in another order than
  ``torch.sum``'s, a few f32 ulps of sums of thousands of terms, on a
  well-determined least-squares pose. Inlier masks and counts must be
  equal: no residual of these problems lies within rounding of τ².
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import pytest
import torch

from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_correspondences
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops.moments import minimal_moments
from rgbd_pose_estimation_tpu_torch.ransac import engine
from rgbd_pose_estimation_tpu_torch.ransac.prosac import sample_minimal_sets
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import (
    horn_from_moments,
    horn_from_moments_reference,
)
from rgbd_pose_estimation_tpu_torch.utils.config import RansacConfig

pytestmark = pytest.mark.cuda

REFIT_ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Horn kernels have no CPU mode")
    return torch.device("cuda")


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _same_bits(out, ref):
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def _launched(name, fn):
    before = _build.launch_counts()[name]
    out = fn()
    assert _build.launch_counts()[name] == before + 1
    return out


def _proper_and_finite(T):
    assert bool(torch.isfinite(T).all())
    det = torch.linalg.det(T[:, :3, :3].double())
    assert float((det - 1.0).abs().max()) < 1e-4


@pytest.mark.parametrize("iters", [4, 12])
@pytest.mark.parametrize("K", [1, 1000, 32768])
def test_hypotheses(dev, K, iters):
    p, q, _, _ = synthetic_correspondences(_gen(dev, K), n=2048, outlier_frac=0.4, noise=0.003,
                                           device=dev)
    idx = sample_minimal_sets(_gen(dev, 1), 2048, K, 3, device=dev)
    mom = minimal_moments(idx, p, q)
    out = _launched("horn_hypotheses", lambda: horn_from_moments(mom, iters))
    _same_bits(out, horn_from_moments_reference(mom, iters))
    _proper_and_finite(out)


def test_hypotheses_near_collinear(dev):
    g = _gen(dev, 6)
    base = torch.randn(4096, 1, 3, generator=g, device=dev)
    direction = torch.randn(4096, 1, 3, generator=g, device=dev)
    steps = torch.tensor([-1.0, 0.1, 1.0], device=dev).reshape(1, 3, 1)
    P = base + steps * direction + 0.0035 * torch.randn(4096, 3, 3, generator=g, device=dev)
    _, _, T, _ = synthetic_correspondences(g, n=4, device=dev)
    Q = P @ T[:3, :3].T + T[:3, 3]
    idx = torch.arange(3 * 4096, dtype=torch.int32, device=dev).reshape(4096, 3)
    mom = minimal_moments(idx, P.reshape(-1, 3).contiguous(), Q.reshape(-1, 3).contiguous())
    out = horn_from_moments(mom, 4)
    _same_bits(out, horn_from_moments_reference(mom, 4))
    _proper_and_finite(out)
    err = (out[:, :3, :3] - T[:3, :3]).abs().amax(dim=(1, 2))
    assert float(err.median()) < 2e-2


def test_hypotheses_nan_moments(dev):
    p, q, _, _ = synthetic_correspondences(_gen(dev, 3), n=512, outlier_frac=0.4, noise=0.003,
                                           device=dev)
    idx = sample_minimal_sets(_gen(dev, 4), 512, 1000, 3, device=dev)
    mom = minimal_moments(idx, p, q)
    mom[:, 5] = float("nan")
    mom[7, 9] = float("nan")
    mom[15, 11] = float("nan")
    out = horn_from_moments(mom, 4)
    _same_bits(out, horn_from_moments_reference(mom, 4))
    nan_rows = torch.tensor([5, 9, 11], device=dev)
    assert bool(torch.isnan(out[nan_rows, :3]).all())
    assert torch.equal(out[nan_rows, 3], torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(3, 4))
    keep = torch.ones(1000, dtype=torch.bool, device=dev)
    keep[nan_rows] = False
    assert not bool(torch.isnan(out[keep]).any())


def test_hypotheses_far_points(dev):
    """Minimal sets ~1e4 from the origin, as the engine's pad sentinels lie:
    the Frobenius scaling keeps the squarings finite. Random sets at that
    scale, and sets of the pad sentinels themselves (which lie on a line,
    so that the rotation is not determined)."""
    g = _gen(dev, 5)
    P = 1e4 * torch.randn(1000, 3, 3, generator=g, device=dev)
    Q = 1e4 * torch.randn(1000, 3, 3, generator=g, device=dev)
    idx = torch.arange(3000, dtype=torch.int32, device=dev).reshape(1000, 3)
    mom = minimal_moments(idx, P.reshape(-1, 3).contiguous(), Q.reshape(-1, 3).contiguous())
    out = horn_from_moments(mom, 4)
    _same_bits(out, horn_from_moments_reference(mom, 4))
    _proper_and_finite(out)

    p, q, _, _ = synthetic_correspondences(g, n=100, device=dev)
    pp, qq = engine.pad_correspondences_3d3d(p, q, 2048)
    idx = (100 + torch.rand((1000, 2048 - 100), generator=g, device=dev)
           .argsort(dim=1)[:, :3]).to(torch.int32).contiguous()
    mom = minimal_moments(idx, pp, qq)
    out = horn_from_moments(mom, 4)
    _same_bits(out, horn_from_moments_reference(mom, 4))
    _proper_and_finite(out)


def _refit_pair(dev, n, rounds, threshold=0.05, start=None, seed=0):
    p, q, T, _ = synthetic_correspondences(_gen(dev, 10 + n + seed), n=n, outlier_frac=0.4,
                                           noise=0.003, device=dev)
    T0 = T.clone()
    T0[:3, 3] += 0.01
    if start is not None:
        T0 = start(T0)
    cfg = RansacConfig(threshold=threshold, refit_rounds=rounds)
    score = torch.zeros((), device=dev)
    res = _launched("horn_refit_3d3d", lambda: engine._refit_3d3d(T0, score, p, q, cfg, 1))
    ref = engine._refit_3d3d_reference(T0, score, p, q, cfg, 1)
    torch.cuda.synchronize()
    assert torch.equal(res.inlier_mask, ref.inlier_mask)
    assert float(res.num_inliers) == float(ref.num_inliers)
    assert bool(res.valid) == bool(ref.valid)
    return res, ref, T0, T


@pytest.mark.parametrize("rounds", [0, 1, 2])
@pytest.mark.parametrize("n", [5, 2048, 3000])
def test_refit(dev, n, rounds):
    res, ref, T0, T = _refit_pair(dev, n, rounds)
    assert float((res.pose - ref.pose).abs().max()) <= REFIT_ATOL
    if rounds == 0:
        assert torch.equal(res.pose, T0)
    elif n > 5:
        assert float((res.pose - T).abs().max()) < 0.01


@pytest.mark.parametrize("rounds", [1, 2])
def test_refit_fewer_than_3_inliers_keeps_the_pose(dev, rounds):
    res, ref, T0, _ = _refit_pair(dev, 2048, rounds, threshold=1e-5)
    assert float(res.num_inliers) < 3 and not bool(res.valid)
    assert torch.equal(res.pose, T0) and torch.equal(ref.pose, T0)


def test_refit_nan_start_pose(dev):
    res, ref, _, _ = _refit_pair(dev, 2048, 2, start=lambda T0: T0 * float("nan"))
    assert bool(torch.isnan(res.pose).all()) and bool(torch.isnan(ref.pose).all())
    assert float(res.num_inliers) == 0 and not bool(res.valid) and not bool(res.inlier_mask.any())


def test_estimate_launches_each_horn_kernel_once(dev):
    p, q, T, _ = synthetic_correspondences(_gen(dev, 0), n=2048, outlier_frac=0.4, noise=0.003,
                                           device=dev)
    cfg = RansacConfig(num_hypotheses=32768, threshold=0.05, refit_rounds=2, solver="horn")
    before = _build.launch_counts()
    res = engine.estimate_pose_3d3d(_gen(dev, 1), p, q, cfg)
    after = _build.launch_counts()
    for name in ("minimal_moments", "horn_hypotheses", "score_poses_3d3d_quad_fused",
                 "score_poses_3d3d", "horn_refit_3d3d"):
        assert after[name] == before[name] + 1
    assert bool(res.valid) and float((res.pose - T).abs().max()) < 0.05
