"""On-device depth-image geometry: vertex maps, normal maps, pyramids.

Counterpart of the JAX package's ``data/geometry.py``: whole-image tensor
arithmetic, every result on the device of its input.

Conventions:
- depth maps are ``(H, W)`` float32 in meters, 0 = invalid;
- vertex maps are ``(H, W, 3)`` camera-frame points, 0 at invalid pixels;
- normal maps are ``(H, W, 3)`` unit normals (camera-facing), 0 at invalid.
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics, pixel_grid

# Pixel coordinates are clamped to this before they are cast to int32: far
# outside any image, well inside int32. A float beyond int32 casts to
# something else on every backend (saturated, INT_MIN, undefined); clamped,
# the in-bounds test and the clipped index are the same everywhere, and no
# pixel inside an image changes.
_PIXEL_LIMIT = float(2**30)


def pixel_index(x: torch.Tensor) -> torch.Tensor:
    """A float pixel coordinate (already rounded or floored) → int32."""
    return torch.clamp(x, -_PIXEL_LIMIT, _PIXEL_LIMIT).to(torch.int32)


def vertex_map(cam: CameraIntrinsics, depth: torch.Tensor) -> torch.Tensor:
    """Back-project a depth image to a camera-frame vertex map ``(H, W, 3)``."""
    uv = pixel_grid(cam, depth.dtype, depth.device)
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def normal_map(vertices: torch.Tensor) -> torch.Tensor:
    """Normals from central differences of the vertex map, camera-facing.

    Invalid neighbors (zero depth) poison the affected pixels to 0-normals,
    mirroring the masked-out handling the dense ICP expects.
    """
    v = vertices
    # Central differences via roll; borders handled by the validity mask.
    dx = torch.roll(v, -1, dims=1) - torch.roll(v, 1, dims=1)
    dy = torch.roll(v, -1, dims=0) - torch.roll(v, 1, dims=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    # Orient toward the camera: n · v < 0 (camera at origin, +z forward).
    flip = torch.sum(n * v, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)

    z = v[..., 2]
    valid = (
        (z > 0)
        & (torch.roll(z, -1, dims=1) > 0)
        & (torch.roll(z, 1, dims=1) > 0)
        & (torch.roll(z, -1, dims=0) > 0)
        & (torch.roll(z, 1, dims=0) > 0)
        & (norm[..., 0] > 1e-12)
    )
    # Kill the wrap-around rows/cols introduced by roll.
    h, w = z.shape
    row = torch.arange(h, device=z.device)[:, None]
    col = torch.arange(w, device=z.device)[None, :]
    interior = (row > 0) & (row < h - 1) & (col > 0) & (col < w - 1)
    valid = valid & interior
    return torch.where(valid[..., None], n, 0.0)


def bilinear_sample(image: torch.Tensor, uv: torch.Tensor):
    """Bilinearly sample ``(H, W, C)`` (or ``(H, W)``) at ``(..., 2)`` (u, v).

    Returns ``(samples, in_bounds)``. Samples outside the image are 0. A tap
    that touches a zero-depth texel is not flagged here: callers that care
    (projective ICP) also check the sampled z > 0.
    """
    squeeze = image.dim() == 2
    if squeeze:
        image = image[..., None]
    h, w, c = image.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = pixel_index(u0)
    v0i = pixel_index(v0)

    in_bounds = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    u0c = torch.clamp(u0i, 0, w - 2)
    v0c = torch.clamp(v0i, 0, h - 2)

    flat = image.reshape(h * w, c)
    base = (v0c * w + u0c).long()
    s00 = flat[base]
    s01 = flat[base + 1]
    s10 = flat[base + w]
    s11 = flat[base + w + 1]

    wu = fu[..., None]
    wv = fv[..., None]
    out = (
        s00 * (1 - wu) * (1 - wv)
        + s01 * wu * (1 - wv)
        + s10 * (1 - wu) * wv
        + s11 * wu * wv
    )
    out = torch.where(in_bounds[..., None], out, 0.0)
    if squeeze:
        out = out[..., 0]
    return out, in_bounds


def nearest_sample(image: torch.Tensor, uv: torch.Tensor):
    """Nearest-neighbor variant of :func:`bilinear_sample` (for normals,
    where averaging across depth discontinuities produces bogus vectors).
    Rounds half to even, as the JAX package does."""
    squeeze = image.dim() == 2
    if squeeze:
        image = image[..., None]
    h, w, c = image.shape
    ui = pixel_index(torch.round(uv[..., 0]))
    vi = pixel_index(torch.round(uv[..., 1]))
    in_bounds = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    uc = torch.clamp(ui, 0, w - 1)
    vc = torch.clamp(vi, 0, h - 1)
    out = image.reshape(h * w, c)[(vc * w + uc).long()]
    out = torch.where(in_bounds[..., None], out, 0.0)
    if squeeze:
        out = out[..., 0]
    return out, in_bounds


def downsample_depth(depth: torch.Tensor) -> torch.Tensor:
    """2x depth downsample that respects invalid (zero) pixels.

    Averages the valid texels of each 2x2 block; a block with no valid texel
    stays invalid. Plain average-pooling would smear zeros into geometry.
    """
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    valid = (d > 0).to(depth.dtype)
    s = torch.sum(d * valid, dim=(1, 3))
    n = torch.sum(valid, dim=(1, 3))
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), 0.0)


def build_pyramid(depth: torch.Tensor, levels: int):
    """List of depth maps, finest first; level i is downscaled by 2^i."""
    pyr = [depth]
    for _ in range(levels - 1):
        pyr.append(downsample_depth(pyr[-1]))
    return pyr


def downsample_intensity(img: torch.Tensor) -> torch.Tensor:
    """2x intensity downsample (plain 2x2 mean; no invalid semantics)."""
    h, w = img.shape
    return img[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def photo_map(img: torch.Tensor) -> torch.Tensor:
    """(H, W) intensity → (H, W, 3) [I, dI/du, dI/dv] for photometric ICP.

    Central-difference gradients in pixel units (the Jacobian chain in
    icp/dense.py multiplies by fx/z, fy/z). Border gradients use one-sided
    differences via edge padding.
    """
    pad_u = torch.cat([img[:, :1], img, img[:, -1:]], dim=1)
    pad_v = torch.cat([img[:1], img, img[-1:]], dim=0)
    gx = (pad_u[:, 2:] - pad_u[:, :-2]) * 0.5
    gy = (pad_v[2:] - pad_v[:-2]) * 0.5
    return torch.stack([img, gx, gy], dim=-1)
