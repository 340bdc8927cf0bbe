"""Sparse feature front-end: detection, matching on the device, and the
host steps that turn matches into RANSAC's correspondences.

Counterpart of the JAX package's ``features/frontend.py``. Detection is host
OpenCV ORB (``detector="orb"``, ``cv2`` imported only when called, so the
port imports without it) or the FAST+BRIEF detector of ``tpu_detect.py``
on ``device`` (``detector="tpu"``). Matching runs on ``device``: the full
Hamming distance matrix, the Lowe ratio test and the mutual-best check. The
depth lookup, the quality sort and the back-projection stay host numpy, as
in the reference (its unstable ``np.argsort`` included, which fixes PROSAC's
order among equal qualities).

Static-shape contract: keypoint arrays are always padded to ``max_features``
with a validity mask.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics

# Set bits of every byte value: the Hamming distance is a table lookup of
# the xor bytes (PyTorch has no population count).
_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint8)
_TABLES: dict = {}


def _popcount_table(device) -> torch.Tensor:
    device = torch.device(device)
    if device not in _TABLES:
        _TABLES[device] = torch.from_numpy(_POPCOUNT).to(device)
    return _TABLES[device]


def detect_orb(gray: np.ndarray, max_features: int = 512):
    """Detect ORB keypoints/descriptors on the host.

    Args: ``gray`` float32 (H, W) in [0,1]. Returns ``(uv (M, 2) f32,
    desc (M, 32) u8, valid (M,) bool)`` padded to ``max_features``.
    Raises ``RuntimeError`` where OpenCV is not installed: the on-device
    detector (``detector="tpu"``) is never taken in its place.
    """
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            'detector "orb" is host OpenCV ORB, and cv2 cannot be imported '
            f'here ({e}); choose the on-device detector ("tpu", --detector tpu)'
        ) from e

    img8 = (np.clip(np.asarray(gray), 0, 1) * 255).astype(np.uint8)
    orb = cv2.ORB_create(nfeatures=max_features)
    kps, desc = orb.detectAndCompute(img8, None)
    uv = np.zeros((max_features, 2), np.float32)
    d = np.zeros((max_features, 32), np.uint8)
    valid = np.zeros(max_features, bool)
    if kps:
        m = min(len(kps), max_features)
        uv[:m] = np.asarray([k.pt for k in kps[:m]], np.float32)
        d[:m] = desc[:m]
        valid[:m] = True
    return uv, d, valid


def match_descriptors(desc_a, valid_a, desc_b, valid_b, ratio: float = 0.8):
    """Mutual-best Hamming matching with Lowe ratio test, on the
    descriptors' device; reads nothing back.

    Args: ``desc_* (..., M, 32) uint8``, ``valid_* (..., M) bool`` tensors;
    leading dimensions are a batch of pairs (``ba/build.py`` matches all its
    keyframe pairs in one call). Returns ``(idx_b (..., M) int32, good
    (..., M), quality (..., M) f32)`` — for each keypoint in A its best
    match in B, whether it passed ratio + mutual-best + validity, and a
    quality score (higher = more distinctive) for PROSAC. Among equal
    distances the lower index wins, as under ``lax.top_k`` and ``argmin``.
    """
    xa = desc_a[..., :, None, :] ^ desc_b[..., None, :, :]  # (..., Ma, Mb, 32)
    counts = _popcount_table(xa.device)[xa.to(torch.int32)]
    ham = counts.sum(-1, dtype=torch.int32).to(torch.float32)
    big = 1e9
    ham = torch.where(valid_a[..., :, None] & valid_b[..., None, :], ham, big)

    # Best and second best distance in B for each A: argmin takes the first
    # minimum; the second is the minimum over the other columns.
    idx_b = torch.argmin(ham, dim=-1)
    best = ham.gather(-1, idx_b[..., None])[..., 0]
    others = ham.scatter(-1, idx_b[..., None], torch.inf)
    second = others.min(dim=-1).values
    passes_ratio = best < ratio * torch.clamp(second, min=1e-6)

    # Mutual best: A must also be B's best.
    best_a_for_b = torch.argmin(ham, dim=-2)  # (..., Mb)
    mutual = best_a_for_b.gather(-1, idx_b) == torch.arange(ham.shape[-2], device=ham.device)

    good = passes_ratio & mutual & valid_a & (best < big * 0.5)
    quality = torch.where(good, second / torch.clamp(best, min=1.0), 0.0)
    return idx_b.to(torch.int32), good, quality


def _detect(gray, max_features: int, detector: str, device="cuda"):
    """Dispatch: ``"orb"`` = host OpenCV (reference parity), ``"tpu"`` =
    FAST+BRIEF on ``device`` (tpu_detect.py), same output contract."""
    if detector == "tpu":
        from rgbd_pose_estimation_tpu_torch.features.tpu_detect import detect_tpu

        return detect_tpu(gray, max_features, device=device)
    return detect_orb(gray, max_features)


def _match(d_a, va, d_b, vb, device):
    """Host detections → matching on ``device`` → host ``(idx_b, good,
    quality)`` (one read-back)."""
    ship = lambda a: torch.from_numpy(np.array(a)).to(device)
    idx_b, good, quality = match_descriptors(ship(d_a), ship(va), ship(d_b), ship(vb))
    return idx_b.cpu().numpy(), good.cpu().numpy(), quality.cpu().numpy()


def _depth_at(depth: np.ndarray, uv: np.ndarray):
    u = np.clip(np.round(uv[:, 0]).astype(int), 0, depth.shape[1] - 1)
    v = np.clip(np.round(uv[:, 1]).astype(int), 0, depth.shape[0] - 1)
    return depth[v, u]


def _sorted_by_quality(quality, good):
    # numpy's default (unstable) argsort, as in the reference: the order of
    # equal qualities is PROSAC's order.
    order = np.argsort(-np.asarray(quality))
    keep = np.asarray(good)[order]
    return order[keep]


def matched_3d3d(cam: CameraIntrinsics, gray_a, depth_a, gray_b, depth_b,
                 max_features: int = 512, detector: str = "orb", device="cuda"):
    """Full front-end for the 3D-3D path: ``(p, q)`` quality-sorted numpy.

    Back-projects matched keypoints through both depth maps; matches whose
    depth is invalid in either frame are dropped. Output order is PROSAC's
    descending-quality order.
    """
    uv_a, d_a, va = _detect(gray_a, max_features, detector, device)
    uv_b, d_b, vb = _detect(gray_b, max_features, detector, device)
    idx_b, good, quality = _match(d_a, va, d_b, vb, device)
    return _correspondences_3d3d(cam, uv_a, uv_b, idx_b, good, quality, depth_a, depth_b)


def _correspondences_3d3d(cam, uv_a, uv_b, idx_b, good, quality, depth_a, depth_b):
    order = _sorted_by_quality(quality, good)
    ia = order
    ib = np.asarray(idx_b)[order]
    za = _depth_at(depth_a, uv_a[ia])
    zb = _depth_at(depth_b, uv_b[ib])
    ok = (za > 0) & (zb > 0)
    ia, ib, za, zb = ia[ok], ib[ok], za[ok], zb[ok]
    p = np.stack(
        [
            (uv_a[ia, 0] - cam.cx) / cam.fx * za,
            (uv_a[ia, 1] - cam.cy) / cam.fy * za,
            za,
        ],
        axis=-1,
    )
    q = np.stack(
        [
            (uv_b[ib, 0] - cam.cx) / cam.fx * zb,
            (uv_b[ib, 1] - cam.cy) / cam.fy * zb,
            zb,
        ],
        axis=-1,
    )
    return p.astype(np.float32), q.astype(np.float32)


def matched_2d3d(cam: CameraIntrinsics, gray_a, depth_a, gray_b,
                 max_features: int = 512, detector: str = "orb", device="cuda"):
    """Front-end for the 2D-3D (PnP) path: 3D points in frame A's camera
    frame + normalized observations in frame B, quality-sorted."""
    uv_a, d_a, va = _detect(gray_a, max_features, detector, device)
    uv_b, d_b, vb = _detect(gray_b, max_features, detector, device)
    idx_b, good, quality = _match(d_a, va, d_b, vb, device)
    return _correspondences_2d3d(cam, uv_a, uv_b, idx_b, good, quality, depth_a)


def _correspondences_2d3d(cam, uv_a, uv_b, idx_b, good, quality, depth_a):
    order = _sorted_by_quality(quality, good)
    ia = order
    ib = np.asarray(idx_b)[order]
    za = _depth_at(depth_a, uv_a[ia])
    ok = za > 0
    ia, ib, za = ia[ok], ib[ok], za[ok]
    pts = np.stack(
        [
            (uv_a[ia, 0] - cam.cx) / cam.fx * za,
            (uv_a[ia, 1] - cam.cy) / cam.fy * za,
            za,
        ],
        axis=-1,
    )
    obs = np.stack(
        [
            (uv_b[ib, 0] - cam.cx) / cam.fx,
            (uv_b[ib, 1] - cam.cy) / cam.fy,
        ],
        axis=-1,
    )
    return pts.astype(np.float32), obs.astype(np.float32)
