"""features/ of the PyTorch port (FAST+BRIEF detection, Hamming matching, the
host steps to correspondences) against the JAX package's, on the CPU.

The image is a 320x240 intensity frame of the port's synthetic sequence,
handed to both as numpy. The reference is called through ``jax.jit`` at one
shape each. The cases of the JAX package's own detector tests run on the
port alone.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.features import frontend as jfrontend
from rgbd_pose_estimation_tpu.features import tpu_detect as jdetect
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence
from rgbd_pose_estimation_tpu_torch.features import frontend as tfrontend
from rgbd_pose_estimation_tpu_torch.features import tpu_detect as tdetect

W, H = 320, 240
CAM = CameraIntrinsics(W * 1.0, W * 1.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
# Scores: one f32 sum of the same 16 terms in the same order on both sides
# (bit-equal on the CPU); the tolerance allows one rounding of a 0.1-sized sum.
SCORE_ATOL = 1e-6
# Descriptor bits: the centroid moments are sums of 1369 terms whose order
# the two frameworks choose; an angle rounded differently can flip a test
# whose two samples are near-equal.
DESC_BITS_AGREE = 0.999

fast_scores_j = jax.jit(jdetect.fast_scores)
nms_j = jax.jit(jdetect._nms3x3)


@pytest.fixture(scope="module")
def frames():
    """Two 320x240 frames (gray, depth) of the port's synthetic sequence."""
    g = torch.Generator().manual_seed(5)
    poses, depths, intens = synthetic_sequence(CAM, g, 2, motion_scale=0.01, device="cpu")
    return [(i.numpy(), d.numpy()) for i, d in zip(intens, depths)], poses.numpy()


@pytest.fixture(scope="module")
def reference_detections(frames):
    """The JAX package's detections of both frames (host numpy)."""
    return [jdetect.detect_tpu(gray, 512) for gray, _ in frames[0]]


def test_fast_scores_and_nms_match_reference(frames):
    gray = frames[0][0][0]
    ref = np.asarray(fast_scores_j(jnp.asarray(gray)))
    out = tdetect.fast_scores(torch.from_numpy(gray)).numpy()
    assert (ref > 0).sum() > 1000
    np.testing.assert_allclose(out, ref, rtol=0, atol=SCORE_ATOL)
    ref_nms = np.asarray(nms_j(jnp.asarray(ref)))
    out_nms = tdetect._nms3x3(torch.from_numpy(ref.copy())).numpy()
    np.testing.assert_allclose(out_nms, ref_nms, rtol=0, atol=SCORE_ATOL)
    assert ((out_nms > 0) == (ref_nms > 0)).all()


def test_detect_and_describe_matches_reference(frames):
    gray = frames[0][0][0]
    ref = [np.asarray(x) for x in jdetect.detect_and_describe(jnp.asarray(gray), 512)]
    out = [x.numpy() for x in tdetect.detect_and_describe(torch.from_numpy(gray), 512)]
    (uv_r, d_r, v_r, s_r), (uv, d, v, s) = ref, out
    assert uv.dtype == np.float32 and d.dtype == np.uint8 and v.dtype == bool
    np.testing.assert_array_equal(uv, uv_r)
    np.testing.assert_array_equal(v, v_r)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=SCORE_ATOL)
    assert v.sum() > 400
    differ = np.unpackbits(d[v] ^ d_r[v_r], axis=-1).sum()
    assert differ <= (1 - DESC_BITS_AGREE) * v.sum() * 256, differ
    # detect_tpu: host numpy out, the same arrays.
    uv2, d2, v2 = tdetect.detect_tpu(gray, 512, device="cpu")
    np.testing.assert_array_equal(uv2, uv)
    np.testing.assert_array_equal(d2, d)
    np.testing.assert_array_equal(v2, v)


def test_match_descriptors_matches_reference_with_ties():
    """Descriptors of bytes 0-3 (distances 0-64), a fifth of the rows
    repeated, some rows invalid: ties of best, second and mutual best are
    the rule. Lower index first on both sides, so every output is equal."""
    rng = np.random.default_rng(0)
    da = rng.integers(0, 4, size=(300, 32)).astype(np.uint8)
    db = rng.integers(0, 4, size=(280, 32)).astype(np.uint8)
    db[200:260] = da[:60]
    db[260:] = db[200:220]  # exact duplicates in B
    da[250:] = da[:50]  # ... and in A
    va = rng.uniform(size=300) > 0.1
    vb = rng.uniform(size=280) > 0.1
    ref = [np.asarray(x) for x in jfrontend.match_descriptors(
        jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb))]
    out = [x.numpy() for x in tfrontend.match_descriptors(
        *(torch.from_numpy(a) for a in (da, va, db, vb)))]
    for name, o, r in zip(("idx_b", "good", "quality"), out, ref):
        assert o.dtype == r.dtype, name
        np.testing.assert_array_equal(o, r, err_msg=name)
    assert 10 < out[1].sum() < 300 and len(np.unique(out[2][out[1]])) < out[1].sum()


def test_matched_correspondences_match_reference(frames, reference_detections, monkeypatch):
    """The host steps (depth lookup, the unstable quality sort, back-projection)
    fed the same detections in both packages: equal arrays."""
    (ga, da), (gb, db) = frames[0]
    dets = {id(ga): reference_detections[0], id(gb): reference_detections[1]}
    fake = lambda gray, *args, **kw: dets[id(gray)]
    monkeypatch.setattr(jfrontend, "_detect", fake)
    monkeypatch.setattr(tfrontend, "_detect", fake)
    from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera

    jcam = JCamera(CAM.fx, CAM.fy, CAM.cx, CAM.cy, W, H)
    p_r, q_r = jfrontend.matched_3d3d(jcam, ga, da, gb, db)
    p, q = tfrontend.matched_3d3d(CAM, ga, da, gb, db, device="cpu")
    assert len(p) > 30
    np.testing.assert_array_equal(p, p_r)
    np.testing.assert_array_equal(q, q_r)
    pts_r, obs_r = jfrontend.matched_2d3d(jcam, ga, da, gb)
    pts, obs = tfrontend.matched_2d3d(CAM, ga, da, gb, device="cpu")
    np.testing.assert_array_equal(pts, pts_r)
    np.testing.assert_array_equal(obs, obs_r)


# --- the JAX package's detector cases (tests/unit/test_tpu_features.py), on the port


def _blocky_image(seed=0, h=120, w=160, n=24, rng_vals=True):
    """Random axis-aligned bright rectangles on a dark ramp — known corners."""
    rng = np.random.default_rng(seed)
    img = (np.linspace(0, 0.15, w, dtype=np.float32)[None, :]).repeat(h, 0).copy()
    corners = []
    for _ in range(n):
        y0, x0 = rng.integers(25, h - 45), rng.integers(25, w - 45)
        hh, ww = rng.integers(12, 20), rng.integers(12, 20)
        val = rng.uniform(0.5, 1.0) if rng_vals else 0.8
        img[y0 : y0 + hh, x0 : x0 + ww] = val
        corners += [(y0, x0), (y0, x0 + ww - 1), (y0 + hh - 1, x0), (y0 + hh - 1, x0 + ww - 1)]
    return img, np.asarray(corners, np.float32)


def _detect(img, k):
    return [x.numpy() for x in tdetect.detect_and_describe(torch.from_numpy(img), k)]


def _flat_image_no_corners():
    assert float(tdetect.fast_scores(torch.full((64, 64), 0.5)).max()) == 0.0


def _corners_near_rectangle_corners():
    img, corners = _blocky_image()
    uv, _, valid, _ = _detect(img, 256)
    uv = uv[valid]
    assert len(uv) >= 20
    d = np.linalg.norm(uv[:, None, ::-1] - corners[None], axis=-1).min(1)
    assert np.median(d) <= 3.0
    assert (d <= 6.0).mean() > 0.8


def _scores_descending_and_padded():
    img, _ = _blocky_image(n=3)
    _, _, v, s = _detect(img, 512)
    assert (np.diff(s) <= 1e-6).all()
    assert v[: v.sum()].all() and not v[v.sum() :].any()


def _rotation_invariance_90deg():
    img, _ = _blocky_image(seed=3, h=128, w=128)
    rot = np.rot90(img).copy()  # (x, y) -> (y, W-1-x)
    uv_a, d_a, va = tdetect.detect_tpu(img, 128, device="cpu")
    uv_b, d_b, vb = tdetect.detect_tpu(rot, 128, device="cpu")
    idx_b, good, _ = (x.numpy() for x in tfrontend.match_descriptors(
        *(torch.from_numpy(a) for a in (d_a, va, d_b, vb))))
    assert good.sum() >= 15
    ia = np.where(good)[0]
    pred = np.stack([uv_a[ia, 1], img.shape[1] - 1 - uv_a[ia, 0]], -1)
    assert np.median(np.linalg.norm(pred - uv_b[idx_b[ia]], axis=-1)) < 2.0


def _descriptors_distinct():
    img, _ = _blocky_image(seed=4)
    _, desc, valid, _ = _detect(img, 128)
    d = desc[valid]
    ham = np.unpackbits(d[:, None] ^ d[None, :], axis=-1).sum(-1).astype(int)
    np.fill_diagonal(ham, 999)
    assert np.median(ham.min(1)) > 10


@pytest.mark.parametrize("case", [
    _flat_image_no_corners, _corners_near_rectangle_corners, _scores_descending_and_padded,
    _rotation_invariance_90deg, _descriptors_distinct,
], ids=lambda f: f.__name__.strip("_"))
def test_detector_contract(case):
    case()


def test_detect_orb_matches_reference():
    """Host OpenCV ORB, the same in both packages, padded to ``max_features``
    like the FAST detector's output."""
    pytest.importorskip("cv2")
    img, _ = _blocky_image()
    uv, d, v = tfrontend.detect_orb(img, 64)
    assert uv.shape == (64, 2) and d.shape == (64, 32) and v.shape == (64,)
    ref = jfrontend.detect_orb(img, 64)
    for a, b in zip((uv, d, v), ref):
        np.testing.assert_array_equal(a, b)
