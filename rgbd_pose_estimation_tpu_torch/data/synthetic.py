"""Synthetic problems and RGB-D scenes with exact ground truth — the test oracle.

Counterpart of the JAX package's ``data/synthetic.py``. Scene depth is
*analytically* raycast (a back plane plus spheres), so every frame, from any
pose, is exact to f32: no meshes, no assets, no I/O.

Every function that draws random numbers takes a ``torch.Generator`` and a
``device`` (the generator must live there). The random streams of the two
frameworks differ, so each such function also accepts the draws themselves
(``deltas``, ``noise``, ``dropout_seed``): the parity tests hand it the JAX
package's draws and compare everything downstream of them.

Pose convention everywhere: ``T`` maps world → camera (``x_cam = R x_w + t``).
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics, pixel_grid
from rgbd_pose_estimation_tpu_torch.core.lie import matrix_to_rt, se3_apply, se3_exp


def synthetic_correspondences(
    generator: torch.Generator,
    n: int = 512,
    outlier_frac: float = 0.0,
    noise: float = 0.0,
    motion_scale: float = 0.5,
    batch: tuple = (),
    device="cuda",
):
    """Random 3D-3D correspondence problems with known pose and inlier mask.

    Returns ``(p, q, T_gt, inlier_mask)`` with shapes ``batch + (n, 3)`` etc.,
    created on ``device`` (``generator`` must live there too). Outliers
    replace q with uniform random points in the scene bounding box. The same
    distribution as the JAX package's generator, not the same numbers: the
    two frameworks' random streams differ.
    """
    batch = tuple(batch)
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, **f32) * (hi - lo) + lo

    p = uniform(batch + (n, 3), -1.0, 1.0)
    p = p * torch.tensor([2.0, 2.0, 1.0], **f32) + torch.tensor([0.0, 0.0, 2.5], **f32)
    xi = torch.randn(batch + (6,), generator=generator, **f32) * motion_scale
    T = se3_exp(xi)
    q = se3_apply(T, p)
    q = q + noise * torch.randn(q.shape, generator=generator, **f32)
    out = torch.rand(batch + (n,), generator=generator, **f32) < outlier_frac
    q_out = uniform(q.shape, -2.0, 2.0) + torch.tensor([0.0, 0.0, 2.5], **f32)
    q = torch.where(out[..., None], q_out, q)
    return p, q, T, ~out


# --- Analytic scene: a back plane plus a few spheres -----------------------

# Scene constants chosen so TUM-like cameras (z forward) see everything.
_PLANE_Z = 3.0
_SPHERES = (
    # cx, cy, cz, r
    (0.0, 0.0, 2.2, 0.5),
    (-0.8, 0.4, 1.8, 0.3),
    (0.7, -0.5, 2.5, 0.4),
    (0.3, 0.6, 1.5, 0.25),
    (-0.5, -0.6, 2.8, 0.35),
)


def _raycast(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Closest hit of rays (o + s*d) against the analytic scene.

    ``dirs`` need not be normalized — the returned s is in units of ``dirs``
    (callers pass unit-z camera rays so s equals camera depth). Shapes:
    origins ``(..., 3)``, dirs ``(..., 3)`` → s ``(...)``, 0 when no hit.
    """
    big = 1e9

    # Plane z = _PLANE_Z.
    dz = dirs[..., 2]
    s_plane = (_PLANE_Z - origins[..., 2]) / torch.where(dz.abs() < 1e-9, 1e-9, dz)
    s_plane = torch.where((s_plane > 0.1) & (dz.abs() > 1e-9), s_plane, big)

    # Spheres: ||o + s d - c||^2 = r^2.
    spheres = torch.tensor(_SPHERES, dtype=dirs.dtype, device=dirs.device)
    oc = origins[..., None, :] - spheres[:, :3]  # (..., S, 3)
    d = dirs[..., None, :]
    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - spheres[:, 3] ** 2
    disc = b * b - 4.0 * a * c
    ok = disc > 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s0 = (-b - sq) / (2.0 * a)
    s1 = (-b + sq) / (2.0 * a)
    s_sph = torch.where(s0 > 0.1, s0, torch.where(s1 > 0.1, s1, big))
    s_sph = torch.where(ok, s_sph, big)
    s_sph = torch.amin(s_sph, dim=-1)

    s = torch.minimum(s_plane, s_sph)
    return torch.where(s < big * 0.5, s, 0.0)


def _hash_noise(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """Deterministic integer-lattice hash → [0, 1) (value noise, sharp).

    All in int32: the products wrap around by design and the shifts are
    arithmetic, so the values equal the JAX package's bit for bit."""
    ix, iy, iz = ix.to(torch.int32), iy.to(torch.int32), iz.to(torch.int32)
    h = ix * 374761393 + iy * 668265263 + iz * 2147483647
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) / 65535.0


def _texture(points: torch.Tensor) -> torch.Tensor:
    """Procedural grayscale texture with sharp, corner-rich detail.

    A blocky value-noise (piecewise-constant on a ~2.5 cm lattice) layered
    over low-frequency shading: the hard block edges give corner detectors
    dense, well-localized corners.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    ix = torch.floor(x * 40.0).to(torch.int32)
    iy = torch.floor(y * 40.0).to(torch.int32)
    iz = torch.floor(z * 40.0).to(torch.int32)
    blocks = _hash_noise(ix, iy, iz)
    coarse = _hash_noise(ix >> 3, iy >> 3, iz >> 3)
    v = 0.15 + 0.45 * blocks + 0.3 * coarse + 0.1 * torch.sin(7.1 * x) * torch.cos(5.3 * y)
    return torch.clamp(v, 0.0, 1.0)


def synthetic_depth_scene(cam: CameraIntrinsics, T_wc: torch.Tensor):
    """Render (depth, intensity) of the analytic scene from pose ``T_wc``.

    ``T_wc`` is world→camera ``(4, 4)``; the images are made on its device.
    Depth is metric, 0 where no surface is hit; intensity is a procedural
    texture evaluated at the hit points. Draws nothing.
    """
    R, t = matrix_to_rt(T_wc)
    center = -torch.einsum("ji,j->i", R, t)  # camera center in world
    uv = pixel_grid(cam, T_wc.dtype, T_wc.device)
    d_cam = torch.stack(
        [
            (uv[..., 0] - cam.cx) / cam.fx,
            (uv[..., 1] - cam.cy) / cam.fy,
            torch.ones_like(uv[..., 0]),
        ],
        dim=-1,
    )  # unit-z rays: ray parameter == camera depth
    d_world = torch.einsum("ji,hwj->hwi", R, d_cam)
    origins = center.expand(d_world.shape)
    depth = _raycast(origins, d_world)
    hits = origins + depth[..., None] * d_world
    intensity = torch.where(depth > 0, _texture(hits), 0.0)
    return depth, intensity


def _render_sequence(cam: CameraIntrinsics, poses: torch.Tensor):
    frames = [synthetic_depth_scene(cam, T) for T in poses]
    return torch.stack([f[0] for f in frames]), torch.stack([f[1] for f in frames])


# --- Kinect-realistic degradation -------------------------------------------
#
# Structured-light depth has a well documented error model (Khoshelham &
# Elberink 2012): quadratic-in-z random error, disparity-step quantization,
# and missing data at depth edges / borders.


def kinect_degrade(
    generator: torch.Generator | None,
    depth: torch.Tensor,
    noise_coeff: float = 1.425e-3,  # sigma_z = coeff * z^2 (K&E 2012)
    edge_gap: float = 0.04,  # occlusion-shadow holes at jumps > this (m)
    dropout_frac: float = 0.02,  # random speckle dropout blobs
    border: int = 8,  # invalid border band (px)
    f_times_b: float = 348.0,  # focal(580 px) * baseline(0.075 m) * 8 sub-steps
    noise: torch.Tensor | None = None,
    dropout_seed: int | torch.Tensor | None = None,
):
    """Degrade an analytic depth map with a Kinect-style sensor model.

    Applied per frame: (1) quadratic-in-z Gaussian noise, (2) disparity
    quantization (the Kinect measures 1/8-pixel disparity d = f·b/z, so
    depth resolution degrades as z²) plus the TUM PNG's 1/5000 m storage
    quantization, (3) holes: occlusion shadows at depth discontinuities,
    random speckle dropout, and an invalid border band. Returns depth with
    0 = invalid, like real TUM frames.

    The draws are ``noise`` (standard normals, the depth's shape) and
    ``dropout_seed`` (an integer in [0, 2^30)); what is not given is drawn
    from ``generator`` on the depth's device.
    """
    dev = depth.device
    if noise is None:
        noise = torch.randn(depth.shape, generator=generator, dtype=depth.dtype, device=dev)
    if dropout_seed is None:
        dropout_seed = torch.randint(0, 1 << 30, (), generator=generator, device=dev)
    valid = depth > 0

    # (1) quadratic-in-z noise.
    z = depth + noise_coeff * depth * depth * noise
    z = torch.clamp(z, min=0.0)

    # (2) disparity quantization then PNG quantization.
    disp = f_times_b / torch.clamp(z, min=1e-3)
    z = f_times_b / torch.clamp(torch.round(disp), min=1.0)
    z = torch.round(z * 5000.0) / 5000.0

    # (3a) occlusion shadows: a structured-light sensor loses the pixels
    # just past a depth jump (projector shadow). Flag pixels whose left/up
    # neighbor is much closer.
    dl = torch.diff(depth, dim=1, prepend=depth[:, :1]).abs()
    du = torch.diff(depth, dim=0, prepend=depth[:1]).abs()
    shadow = (dl > edge_gap) | (du > edge_gap)

    # (3b) blobby speckle dropout: threshold low-res value noise so holes
    # come in contiguous chunks (like real specular/absorbing surfaces).
    h, w = depth.shape
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    gy = (row // 4).expand(h, w)
    gx = (col // 4).expand(h, w)
    seed = torch.as_tensor(dropout_seed, device=dev).to(torch.int32)
    blob = _hash_noise(gx, gy, seed.expand(h, w)) < dropout_frac

    # (3c) border band.
    in_border = (row < border) | (row >= h - border) | (col < border) | (col >= w - border)

    keep = valid & ~shadow & ~blob & ~in_border
    return torch.where(keep, z, 0.0)


def _smoothed_walk(deltas: torch.Tensor, keep: float) -> torch.Tensor:
    """(F, 6) tangent draws → (F, 4, 4) world→camera poses from identity:
    velocities are the exponentially smoothed draws (``keep`` of the last
    velocity, the rest of the draw), each pose the last one moved by its
    velocity."""
    v = torch.zeros(6, dtype=deltas.dtype, device=deltas.device)
    T = torch.eye(4, dtype=deltas.dtype, device=deltas.device)
    poses = [T]
    for d in deltas[:-1]:
        v = keep * v + (1.0 - keep) * d
        T = se3_exp(v) @ T
        poses.append(T)
    return torch.stack(poses)


def handheld_trajectory(
    generator: torch.Generator | None,
    n_frames: int,
    trans_scale=0.03,
    rot_scale=0.025,
    deltas: torch.Tensor | None = None,
    device="cuda",
):
    """fr1/desk-like handheld motion: ~2–4 cm and ~1–2°/frame, smoothed.

    Returns (F, 4, 4) world→camera poses starting at identity. ``deltas``
    are the (F, 6) standard normals, drawn from ``generator`` if not given.
    """
    if deltas is None:
        deltas = torch.randn((n_frames, 6), generator=generator, dtype=torch.float32, device=device)
    scale = torch.tensor([trans_scale] * 3 + [rot_scale] * 3, dtype=deltas.dtype, device=deltas.device)
    return _smoothed_walk(deltas * scale, keep=0.7)


def synthetic_sequence_hard(
    cam: CameraIntrinsics,
    generator: torch.Generator | None,
    n_frames: int,
    trans_scale: float = 0.03,
    rot_scale: float = 0.025,
    deltas: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    dropout_seeds: torch.Tensor | None = None,
    device="cuda",
    **degrade_kwargs,
):
    """Hard-mode synthetic TUM: handheld motion + Kinect sensor model.

    Same motion statistics as fr1/desk, quantized/noisy/holey depth. Returns
    ``(poses, depths_degraded, intensities, depths_clean)``. The draws:
    ``deltas`` (F, 6), ``noise`` (F, H, W), ``dropout_seeds`` (F,).
    """
    poses = handheld_trajectory(generator, n_frames, trans_scale, rot_scale, deltas, device)
    depths_clean, intensities = _render_sequence(cam, poses)
    depths = torch.stack([
        kinect_degrade(
            generator, d,
            noise=None if noise is None else noise[i],
            dropout_seed=None if dropout_seeds is None else dropout_seeds[i],
            **degrade_kwargs,
        )
        for i, d in enumerate(depths_clean)
    ])
    return poses, depths, intensities, depths_clean


def synthetic_sequence(
    cam: CameraIntrinsics,
    generator: torch.Generator | None,
    n_frames: int,
    motion_scale: float = 0.02,
    deltas: torch.Tensor | None = None,
    device="cuda",
):
    """A smooth random camera trajectory + rendered (depth, intensity) frames.

    Returns ``(poses, depths, intensities)`` with poses ``(F, 4, 4)``
    (world→camera). Motion is a random walk in the tangent space, smoothed,
    so consecutive frames overlap heavily — the regime dense ICP assumes.
    ``deltas`` are the (F, 6) standard normals, drawn if not given.
    """
    if deltas is None:
        deltas = torch.randn((n_frames, 6), generator=generator, dtype=torch.float32, device=device)
    poses = _smoothed_walk(deltas * motion_scale, keep=0.8)
    depths, intensities = _render_sequence(cam, poses)
    return poses, depths, intensities
