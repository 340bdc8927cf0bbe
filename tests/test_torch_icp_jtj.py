"""ops/icp_jtj.py of the PyTorch port against the JAX package's, same numpy
inputs, on the CPU.

The JAX side runs as that package's own tests run it here: through its plain
reference and through its Pallas kernel in interpret mode, both on the
``(10, S, 128)`` packing. The port takes ``(M, 3)`` rows with no padding rule;
on the CPU its wrapper runs the plain version (the CUDA kernel is held
against it on the card by ``chip_smoke.py``).

Tolerance rtol 2e-4 / atol 1e-4, the one of ``tests/kernels/test_icp_jtj.py``:
every entry is a sum of M f32 products taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
from rgbd_pose_estimation_tpu.icp import dense as jdense
from rgbd_pose_estimation_tpu.ops import icp_jtj as jref
from rgbd_pose_estimation_tpu.utils.config import IcpConfig as JIcpConfig
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops import icp_jtj as tops
from rgbd_pose_estimation_tpu_torch.ops.icp_jtj import icp_jtj_jtr, icp_jtj_jtr_reference
from rgbd_pose_estimation_tpu_torch.utils.convert import to_numpy, to_torch

RTOL, ATOL = 2e-4, 1e-4


def _rows(seed, m):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(m, 3)).astype(np.float32)
    q = p + (rng.normal(size=(m, 3)) * 0.01).astype(np.float32)
    n = rng.normal(size=(m, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = (rng.uniform(0, 1, size=(m,)) > 0.3).astype(np.float32) * rng.uniform(
        0.2, 1.0, size=(m,)).astype(np.float32)
    return p, q, n, w


def _assert_same(out, ref, rtol=RTOL, atol=ATOL):
    names = ("JtJ", "Jtr", "err", "wsum")
    shapes = ((6, 6), (6,), (), ())
    for name, shape, a, b in zip(names, shapes, to_numpy(tuple(out)), ref):
        assert a.shape == shape, name
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=name)


# 3072 = the JAX package's own parity size; 1000 and 1 are ragged (no multiple
# of a warp, a block or the TPU's 8192-pixel tile); 9000 crosses one TPU tile.
@pytest.mark.parametrize("m", [3072, 1000, 9000, 1])
@pytest.mark.parametrize("impl", ["reference", "interpret"])
def test_matches_reference_package(impl, m):
    rows = _rows(m, m)
    data = jref.pack_icp_data(*[jnp.asarray(a) for a in rows])
    ref = jref.icp_jtj_jtr(data, impl=impl)
    _assert_same(icp_jtj_jtr_reference(*to_torch(list(rows), "cpu")), ref)
    # On CPU tensors the wrapper is the plain version, and counts no launch.
    before = _build.launch_counts()["icp_jtj_jtr"]
    _assert_same(icp_jtj_jtr(*to_torch(list(rows), "cpu")), ref)
    assert _build.launch_counts()["icp_jtj_jtr"] == before


def test_against_float64():
    """Each entry within 1e-5 of the sum of its terms' absolute values: the
    bound that ``chip_smoke.py`` holds the kernel to at full size, with room
    to spare at this one."""
    p, q, n, w = (a.astype(np.float64) for a in _rows(7, 20000))
    J = np.concatenate([n, np.cross(p, n), np.sum(n * (p - q), -1, keepdims=True),
                        np.ones((len(w), 1))], axis=-1)
    A, S = (J * w[:, None]).T @ J, np.abs(J * w[:, None]).T @ np.abs(J)
    JtJ, Jtr, err, wsum = to_numpy(icp_jtj_jtr_reference(*to_torch(list(_rows(7, 20000)), "cpu")))
    assert (np.abs(JtJ - A[:6, :6]) <= 1e-5 * S[:6, :6]).all()
    assert (np.abs(Jtr - A[:6, 6]) <= 1e-5 * S[:6, 6]).all()
    assert abs(err - A[6, 6]) <= 1e-5 * S[6, 6] and abs(wsum - A[7, 7]) <= 1e-5 * S[7, 7]


def test_jtj_is_symmetric_psd_and_consistent():
    rows = to_torch(list(_rows(2, 4096)), "cpu")
    JtJ, Jtr, err, wsum = icp_jtj_jtr_reference(*rows)
    # The plain version is a matrix product: symmetric up to the rounding of
    # entries that cancel to near zero (the kernel mirrors one triangle).
    np.testing.assert_allclose(JtJ.numpy(), JtJ.T.numpy(), rtol=1e-5, atol=1e-4)
    assert np.linalg.eigvalsh(JtJ.numpy().astype(np.float64)).min() > -1e-4
    assert float(wsum) == pytest.approx(float(rows[3].sum()), rel=1e-5)
    r = torch.sum(rows[2] * (rows[0] - rows[1]), -1)
    assert float(err) == pytest.approx(float((rows[3] * r * r).sum()), rel=1e-4)


def test_zero_weights_give_exact_zeros():
    p, q, n, w = to_torch(list(_rows(3, 2048)), "cpu")
    for part in icp_jtj_jtr(p, q, n, torch.zeros_like(w)):
        assert not part.any()


def test_zero_weight_rows_are_multiplied_through():
    """A NaN in a row of weight 0 reaches the sums, as in the JAX package:
    no branch skips the row."""
    p, q, n, w = _rows(4, 512)
    w[5] = 0.0
    p[5, 1] = np.nan
    ref = jref.icp_jtj_jtr_reference(jref.pack_icp_data(*[jnp.asarray(a) for a in (p, q, n, w)]))
    out = to_numpy(icp_jtj_jtr_reference(*to_torch([p, q, n, w], "cpu")))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(np.asarray(b)))
    assert np.isnan(out[0]).any() and np.isfinite(out[3])


def test_photometric_rows_concatenate():
    """Two row blocks through one accumulation = the sum of the two blocks'
    results: how the tracker adds the photometric rows."""
    a, b = _rows(5, 1500), _rows(6, 1500)
    both = [np.concatenate([x, y]) for x, y in zip(a, b)]
    whole = icp_jtj_jtr_reference(*to_torch(both, "cpu"))
    parts = [icp_jtj_jtr_reference(*to_torch(list(r), "cpu")) for r in (a, b)]
    _assert_same(whole, [x + y for x, y in zip(*to_numpy(parts))])
    data = jnp.concatenate([jref.pack_icp_data(*[jnp.asarray(x) for x in r]) for r in (a, b)], axis=1)
    _assert_same(whole, jref.icp_jtj_jtr(data, impl="reference"))


def _fused_and_reference(monkeypatch, *poses):
    """The fused step's plain version (what the kernel is held to on the
    card) and the JAX package's step, on the same 16x12 plane-like maps at
    stride 2 (48 samples), at each of ``poses``. Returns, per pose, the
    port's ``(JtJ, Jtr, err_sum, weight_sum, assoc)`` and the JAX
    accumulation of the JAX step's own rows."""
    rng = np.random.default_rng(8)
    depth = rng.uniform(1.0, 2.0, size=(12, 16)).astype(np.float32)
    u, v = np.meshgrid(np.arange(16, dtype=np.float32), np.arange(12, dtype=np.float32))
    verts = np.stack([(u - 7.5) / 20.0 * depth, (v - 5.5) / 20.0 * depth, depth], -1)
    normals = np.broadcast_to(np.float32([0.0, 0.0, -1.0]), verts.shape).copy()
    accumulate = tops.icp_assoc_jtj_jtr(
        *to_torch([verts, normals, verts, normals], "cpu"), 2, (20.0, 20.0, 7.5, 5.5), (0.1, 0.7, 0.01))
    cfg = JIcpConfig(levels=1, iters_per_level=(1,), source_stride=(2,),
                     dist_threshold=0.1, normal_threshold=0.7, huber_delta=0.01)
    maps = [jnp.asarray(x) for x in (verts, normals, verts, normals)]
    step_j = jdense._level_iteration(JCamera(20.0, 20.0, 7.5, 5.5, 16, 12), cfg, *maps, level=0)
    seen = []
    inner = jdense.icp_jtj_jtr

    def spy(data):
        seen.append(inner(data))
        return seen[-1]

    monkeypatch.setattr(jdense, "icp_jtj_jtr", spy)

    @jax.jit  # one compile of the step, not one per primitive
    def reference(T):
        step_j(T)
        return seen.pop()

    return [(accumulate(T), reference(jnp.asarray(T.numpy()))) for T in poses]


def test_fused_step_nan_pose_gives_nan_sums(monkeypatch):
    """A NaN pose through the fused step's plain version and through the JAX
    package's step on the same maps: every row is multiplied through with
    weight 0, so the sums that involve p are NaN, those of the normals alone
    are 0, and the weight sum is exactly 0 (the step then takes no step), in
    both. The JAX step casts a NaN pixel to 0 and gathers there, the port
    counts it out of bounds: either way the row's weight is 0 and its normal
    finite, so the NaN patterns agree entry for entry."""
    [((JtJ, Jtr, err, wsum, assoc), ref)] = _fused_and_reference(
        monkeypatch, torch.full((4, 4), float("nan")))
    assert assoc[0].shape == (48, 6)
    assert (JtJ[:3, :3] == 0).all() and torch.isnan(JtJ[3:]).all() and torch.isnan(JtJ[:, 3:]).all()
    assert torch.isnan(Jtr).all() and torch.isnan(err) and float(wsum) == 0.0
    for a, b in zip(to_numpy((JtJ, Jtr, err, wsum)), ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(np.asarray(b)))
        np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(np.asarray(b)))


def test_fused_step_sees_all_or_nothing(monkeypatch):
    """At the identity every sample associates to itself (weight sum 48 in
    both packages, the sums as the JAX step's); five metres to the side no
    sample lands on the target, and every sum is exactly 0 in both."""
    far = torch.eye(4)
    far[0, 3] = 5.0
    (out, ref), (out_far, ref_far) = _fused_and_reference(monkeypatch, torch.eye(4), far)
    assert float(out[3]) == float(ref[3]) == 48.0
    _assert_same(out[:4], ref)
    for a, b in zip(to_numpy(out_far[:4]), ref_far):
        assert not a.any() and not np.asarray(b).any()
