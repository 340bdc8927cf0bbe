"""On-device feature detection: FAST-9 corners + oriented-BRIEF descriptors.

Counterpart of the JAX package's ``features/tpu_detect.py`` (the name is
kept so that the two packages stay interchangeable; here "on-device" means
the tensors' device, the card by default). The JAX module has no Pallas
kernel: it is dense tensor arithmetic, and so is this one.

- **FAST-9/16**: the 16-pixel Bresenham circle as 16 rolled copies of the
  image (``torch.roll`` wraps around as ``jnp.roll`` does); a corner needs 9
  contiguous circle pixels all brighter (or all darker) than centre ± t;
  the score is the sum of exceedances.
- **NMS**: a 3×3 max pool (padded with −inf) and an equality test.
- **Selection**: the ``max_features`` best scores of the flattened map, by a
  stable descending sort, so that tied scores come lower index first as
  under ``lax.top_k`` (most of the map is 0, and so are the padding rows).
- **Orientation**: ORB's intensity centroid over a radius-15 disk.
- **rBRIEF**: 256 Gaussian test pairs from a fixed numpy seed, rotated by the
  patch orientation and sampled bilinearly inside one 37×37 patch a
  keypoint; bits packed LSB-first into ``(K, 32)`` uint8, the layout
  ``frontend.match_descriptors`` reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# 16-pixel Bresenham circle of radius 3, in angular order: (dy, dx).
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

_ARC = 9  # FAST-9: required contiguous run length on the circle

# Descriptor patch geometry. BRIEF tests live in a radius-13 disk; after
# rotation they stay within radius 13·√2 < 18.5, so a 37×37 patch (radius
# 18) plus bilinear's +1 means keypoints need an 20-pixel image margin.
_PATCH_R = 18
_PATCH = 2 * _PATCH_R + 1
_MARGIN = _PATCH_R + 2
_ORIENT_R = 15  # intensity-centroid disk radius (ORB)
_N_BITS = 256


def _brief_pattern() -> np.ndarray:
    """(256, 2, 2) float32 test-pair offsets (dy, dx), BRIEF-style Gaussian.

    Generated from a fixed seed (σ = 13/2, clipped to the radius-13 disk) —
    both frames of a match use the same pattern, so any well-spread
    deterministic pattern works; nothing is copied from OpenCV.
    """
    rng = np.random.default_rng(42)
    pts = rng.normal(0.0, 13.0 / 2.0, size=(_N_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(norm > 13.0, pts * (13.0 / norm), pts)
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()

_CONSTANTS: dict = {}


def _constants(device: torch.device) -> dict:
    """The pattern, the patch offsets, the centroid disk and the bit weights
    on ``device``, made once a device (a copy from the host each call would
    wait for the stream)."""
    device = torch.device(device)
    if device not in _CONSTANTS:
        r = torch.arange(-_PATCH_R, _PATCH_R + 1, dtype=torch.int32)
        dy, dx = torch.meshgrid(r, r, indexing="ij")  # jnp.mgrid's layout
        _CONSTANTS[device] = {
            "pattern": torch.from_numpy(_PATTERN).to(device),
            "dy": dy.to(device),
            "dx": dx.to(device),
            "disk": ((dy * dy + dx * dx) <= _ORIENT_R * _ORIENT_R).to(device),
            "weights": torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8).to(device),
        }
    return _CONSTANTS[device]


def fast_scores(gray: torch.Tensor, threshold: float = 0.06) -> torch.Tensor:
    """FAST-9 corner score map, zero at non-corners and inside the margin.

    ``gray`` is float32 (H, W) in [0, 1]; ``threshold`` is the center
    contrast t in the same units (OpenCV's default 20/255 ≈ 0.08).
    """
    ring = torch.stack(
        [torch.roll(gray, (-int(dy), -int(dx)), (0, 1)) for dy, dx in _CIRCLE]
    )  # (16, H, W): ring[k] at pixel p is I(p + circle_k)
    d = ring - gray[None]
    brighter = d > threshold
    darker = d < -threshold

    def _has_arc(b):
        run = b
        for j in range(1, _ARC):
            run = run & torch.roll(b, -j, dims=0)
        return run.any(dim=0)

    corner = _has_arc(brighter) | _has_arc(darker)
    # The exceedance sums run over the 16 ring pixels in circle order, one
    # addition after the other, as the reference's reduction adds them: the
    # score's last bits, and so the order of near-equal corners, depend on it.
    ex_b = torch.where(brighter, d - threshold, 0.0)
    ex_d = torch.where(darker, -d - threshold, 0.0)
    score_b, score_d = ex_b[0], ex_d[0]
    for k in range(1, len(_CIRCLE)):
        score_b = score_b + ex_b[k]
        score_d = score_d + ex_d[k]
    score = torch.where(corner, torch.maximum(score_b, score_d), 0.0)

    h, w = gray.shape
    yy = torch.arange(h, device=gray.device)[:, None]
    xx = torch.arange(w, device=gray.device)[None, :]
    interior = (
        (yy >= _MARGIN) & (yy < h - _MARGIN) & (xx >= _MARGIN) & (xx < w - _MARGIN)
    )
    return torch.where(interior, score, 0.0)


def _nms3x3(score: torch.Tensor) -> torch.Tensor:
    pooled = F.max_pool2d(score[None, None], 3, 1, padding=1)[0, 0]  # pads with −inf
    return torch.where(score >= pooled, score, 0.0)


def _gather_patches(gray: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """(K, 37, 37) patches centered at integer keypoints ``yx`` (K, 2)."""
    c = _constants(gray.device)
    ys = torch.clamp(yx[:, 0, None, None] + c["dy"][None], 0, gray.shape[0] - 1)
    xs = torch.clamp(yx[:, 1, None, None] + c["dx"][None], 0, gray.shape[1] - 1)
    return gray[ys.long(), xs.long()]


def _orientations(patches: torch.Tensor):
    """Intensity-centroid angle per patch → (cosθ, sinθ), each (K,)."""
    c = _constants(patches.device)
    w = patches * c["disk"][None]
    m01 = (w * c["dy"][None]).sum((1, 2))
    m10 = (w * c["dx"][None]).sum((1, 2))
    norm = torch.sqrt(m01 * m01 + m10 * m10)
    safe = norm > 1e-12
    denom = torch.where(safe, norm, 1.0)
    return torch.where(safe, m10 / denom, 1.0), torch.where(safe, m01 / denom, 0.0)


def _bilinear_patch(patches: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """Sample (K, P) patch-frame coordinates (origin at patch center)."""
    py = torch.clamp(y + _PATCH_R, 0.0, _PATCH - 1.001)
    px = torch.clamp(x + _PATCH_R, 0.0, _PATCH - 1.001)
    y0 = py.floor().to(torch.int32)
    x0 = px.floor().to(torch.int32)
    fy = py - y0
    fx = px - x0
    k = torch.arange(patches.shape[0], device=patches.device)[:, None]
    y0, x0 = y0.long(), x0.long()
    p00 = patches[k, y0, x0]
    p01 = patches[k, y0, x0 + 1]
    p10 = patches[k, y0 + 1, x0]
    p11 = patches[k, y0 + 1, x0 + 1]
    return (
        p00 * (1 - fy) * (1 - fx)
        + p01 * (1 - fy) * fx
        + p10 * fy * (1 - fx)
        + p11 * fy * fx
    )


def _brief_descriptors(patches: torch.Tensor, c: torch.Tensor, s: torch.Tensor):
    """Rotated-BRIEF bits from patches: (K, 32) uint8."""
    const = _constants(patches.device)
    pat = const["pattern"]  # (256, 2, 2) as (dy, dx)
    dy = pat[..., 0][None]  # (1, 256, 2)
    dx = pat[..., 1][None]
    c = c[:, None, None]
    s = s[:, None, None]
    ry = s * dx + c * dy  # rotate by θ: steered BRIEF
    rx = c * dx - s * dy
    k = patches.shape[0]
    vals = _bilinear_patch(patches, ry.reshape(k, -1), rx.reshape(k, -1)).reshape(k, _N_BITS, 2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.uint8)  # (K, 256)
    return (bits.reshape(k, 32, 8) * const["weights"][None, None]).sum(-1, dtype=torch.uint8)


def detect_and_describe(gray: torch.Tensor, max_features: int = 512, *, threshold: float = 0.06):
    """FAST-9 + oriented-BRIEF on the image's device; reads nothing back.

    Args: ``gray`` float32 (H, W) in [0, 1]. Returns ``(uv (K, 2) float32
    in (x, y) pixel convention, desc (K, 32) uint8, valid (K,) bool,
    score (K,) float32)`` with K = ``max_features``, quality-descending
    (lower flat index first among equal scores), padded with
    ``valid=False``. The same output contract as ``frontend.detect_orb``.
    """
    score = _nms3x3(fast_scores(gray, threshold))
    flat = score.reshape(-1)
    # A stable sort keeps tied scores in index order (lax.top_k's order);
    # torch.topk promises no order among ties.
    top, idx = torch.sort(flat, descending=True, stable=True)
    top, idx = top[:max_features], idx[:max_features]
    w = gray.shape[1]
    yx = torch.stack([idx // w, idx % w], dim=-1).to(torch.int32)  # (K, 2)
    valid = top > 0.0

    patches = _gather_patches(gray, yx)
    c, s = _orientations(patches)
    desc = _brief_descriptors(patches, c, s)
    uv = torch.stack([yx[:, 1], yx[:, 0]], dim=-1).to(torch.float32)
    return uv, desc, valid, top


def detect_tpu(gray, max_features: int = 512, threshold: float = 0.06, device="cuda"):
    """Drop-in replacement for ``frontend.detect_orb`` (same signature and
    shapes): a host image in, host numpy ``(uv, desc, valid)`` out, detected
    on ``device``. Pipelines that want the device tensors call
    :func:`detect_and_describe` directly."""
    g = torch.from_numpy(np.array(gray, np.float32)).to(device)
    uv, desc, valid, _ = detect_and_describe(g, max_features, threshold=threshold)
    return uv.cpu().numpy(), desc.cpu().numpy(), valid.cpu().numpy()
