"""The benchmark's traffic generators: synthetic correspondence problems and
hard-mode RGB-D sequences with exact ground truth.

Copied from rgbd_pose_estimation_tpu_torch/data/synthetic.py at commit
01a5bf9 (``synthetic_correspondences``, ``_smoothed_walk``,
``handheld_trajectory``, ``_raycast``, ``_hash_noise``, the depth half of
``synthetic_depth_scene`` and ``_render_sequence``, ``kinect_degrade``).
Rewritten where the benchmark needs it: rendering and degradation run over
a batch of frames in a few large calls instead of one frame at a time (the
same arithmetic a frame), and the intensity texture, which no cell uses, is
left out. A later change to the program does not move these inputs.

Every draw comes from the ``torch.Generator`` passed in, on the device the
data is made on; the same seed gives the same data.
"""

from __future__ import annotations

import torch

from benchmark.frozen.lie import se3_apply, se3_exp


def synthetic_correspondences(generator, n, outlier_frac, noise, motion_scale=0.5, batch=(), device="cuda"):
    """Random 3D-3D problems ``(p, q, T_gt, inlier_mask)``, shapes
    ``batch + (n, 3)``, ``batch + (4, 4)``, ``batch + (n,)``. Outliers replace
    q by uniform points in the scene's box."""
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

_PLANE_Z = 3.0
_SPHERES = (
    (0.0, 0.0, 2.2, 0.5),
    (-0.8, 0.4, 1.8, 0.3),
    (0.7, -0.5, 2.5, 0.4),
    (0.3, 0.6, 1.5, 0.25),
    (-0.5, -0.6, 2.8, 0.35),
)


def _raycast(origins, dirs):
    """Closest hit (in units of ``dirs``) of rays o + s d; 0 where none."""
    big = 1e9
    dz = dirs[..., 2]
    s_plane = (_PLANE_Z - origins[..., 2]) / torch.where(dz.abs() < 1e-9, 1e-9, dz)
    s_plane = torch.where((s_plane > 0.1) & (dz.abs() > 1e-9), s_plane, big)
    spheres = torch.tensor(_SPHERES, dtype=dirs.dtype, device=dirs.device)
    oc = origins[..., None, :] - spheres[:, :3]
    d = dirs[..., None, :]
    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - spheres[:, 3] ** 2
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s0 = (-b - sq) / (2.0 * a)
    s1 = (-b + sq) / (2.0 * a)
    s_sph = torch.where(s0 > 0.1, s0, torch.where(s1 > 0.1, s1, big))
    s_sph = torch.amin(torch.where(disc > 0, s_sph, big), dim=-1)
    s = torch.minimum(s_plane, s_sph)
    return torch.where(s < big * 0.5, s, 0.0)


def _hash_noise(ix, iy, iz):
    """Integer-lattice hash → [0, 1), in wrapping int32 arithmetic."""
    ix, iy, iz = ix.to(torch.int32), iy.to(torch.int32), iz.to(torch.int32)
    h = ix * 374761393 + iy * 668265263 + iz * 2147483647
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) / 65535.0


def render_depth(cam, poses, chunk=16):
    """Metric depth ``(F, H, W)`` of the analytic scene from world→camera
    ``poses`` ``(F, 4, 4)``; ``cam`` is ``(fx, fy, cx, cy, width, height)``.
    ``chunk`` frames a call."""
    fx, fy, cx, cy, width, height = cam
    dev, dt = poses.device, poses.dtype
    u = torch.arange(width, dtype=dt, device=dev)
    v = torch.arange(height, dtype=dt, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d_cam = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)], dim=-1)
    out = []
    for T in torch.split(poses, chunk):
        R, t = T[:, :3, :3], T[:, :3, 3]
        center = -torch.einsum("fji,fj->fi", R, t)
        d_world = torch.einsum("fji,hwj->fhwi", R, d_cam)
        origins = center[:, None, None, :].expand(d_world.shape)
        out.append(_raycast(origins, d_world))
    return torch.cat(out)


def kinect_degrade(generator, depth, noise_coeff=1.425e-3, edge_gap=0.04, dropout_frac=0.02,
                   border=8, f_times_b=348.0):
    """Kinect-style degradation of ``(F, H, W)`` analytic depth, a frame at a
    time in the arithmetic: quadratic-in-z noise, disparity and 1/5000 m
    quantisation, occlusion shadows, blob dropout, an invalid border."""
    dev = depth.device
    F, h, w = depth.shape
    noise = torch.randn(depth.shape, generator=generator, dtype=depth.dtype, device=dev)
    seeds = torch.randint(0, 1 << 30, (F,), generator=generator, device=dev)
    valid = depth > 0
    z = torch.clamp(depth + noise_coeff * depth * depth * noise, min=0.0)
    disp = f_times_b / torch.clamp(z, min=1e-3)
    z = f_times_b / torch.clamp(torch.round(disp), min=1.0)
    z = torch.round(z * 5000.0) / 5000.0
    dl = torch.diff(depth, dim=2, prepend=depth[:, :, :1]).abs()
    du = torch.diff(depth, dim=1, prepend=depth[:, :1]).abs()
    shadow = (dl > edge_gap) | (du > edge_gap)
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    gy = (row // 4).expand(h, w)
    gx = (col // 4).expand(h, w)
    seed = seeds.to(torch.int32)[:, None, None].expand(F, h, w)
    blob = _hash_noise(gx.expand(F, h, w), gy.expand(F, h, w), seed) < dropout_frac
    in_border = (row < border) | (row >= h - border) | (col < border) | (col >= w - border)
    keep = valid & ~shadow & ~blob & ~in_border
    return torch.where(keep, z, 0.0)


def _smoothed_walk(deltas, keep):
    v = torch.zeros(6, dtype=deltas.dtype, device=deltas.device)
    T = torch.eye(4, dtype=deltas.dtype, device=deltas.device)
    poses = [T]
    for d in deltas[:-1]:
        v = keep * v + (1.0 - keep) * d
        T = se3_exp(v) @ T
        poses.append(T)
    return torch.stack(poses)


def handheld_trajectory(generator, n_frames, trans_scale=0.03, rot_scale=0.025, device="cuda"):
    """fr1/desk-like handheld motion: ``(F, 4, 4)`` world→camera poses from
    identity, smoothed tangent steps of ``trans_scale`` m and ``rot_scale``
    rad standard deviation."""
    deltas = torch.randn((n_frames, 6), generator=generator, dtype=torch.float32, device=device)
    scale = torch.tensor([trans_scale] * 3 + [rot_scale] * 3, dtype=torch.float32, device=device)
    return _smoothed_walk(deltas * scale, keep=0.7)
