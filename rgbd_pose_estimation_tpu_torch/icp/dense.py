"""Dense projective point-to-plane ICP odometry (KinectFusion-style).

Counterpart of the JAX package's ``icp/dense.py``. Each Gauss-Newton
iteration is three device stages —

1. warp: transform every source vertex by the current pose and project it
   into the target camera (elementwise tensor arithmetic);
2. associate: gather target vertices / normals at the projected pixels, gate
   by distance / normal-agreement / depth validity, weight by a Huber robust
   kernel;
3. accumulate: the hand-written CUDA kernel (ops/icp_jtj.py) reduces the
   point-to-plane normal equations on the card; a 6x6 damped solve and an
   SE(3) retraction finish the iteration.

The pyramid is coarse-to-fine; iterations per level are fixed. A whole
multi-level track runs without one value read back to the host: every
decision on a value (too few associations → no step) is a ``torch.where``.
Pose convention: ``T`` maps source camera frame → target camera frame.

The settings keep the JAX package's semantics (one packed gather for nearest
association, source strides, re-association every k-th iteration) because the
results must agree; what each costs on a GPU is measured, not assumed.
"""

from __future__ import annotations

import typing

import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.data.geometry import (
    bilinear_sample,
    build_pyramid,
    downsample_intensity,
    nearest_sample,
    normal_map,
    photo_map,
    pixel_index,
    vertex_map,
)
from rgbd_pose_estimation_tpu_torch.ops.icp_jtj import icp_jtj_jtr
from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig


class IcpFrame(typing.NamedTuple):
    """Per-level vertex/normal maps of one RGB-D frame (finest first).

    ``photo`` is optionally the per-level ``(H_l, W_l, 3)`` stack
    ``[intensity, dI/du, dI/dv]`` (data/geometry.py::photo_map) consumed by
    the photometric residual; empty when tracking is depth-only.
    """

    vertices: tuple  # level → (H_l, W_l, 3)
    normals: tuple  # level → (H_l, W_l, 3)
    photo: tuple = ()  # level → (H_l, W_l, 3) or empty


def make_icp_frame(
    cam: CameraIntrinsics,
    depth: torch.Tensor,
    cfg: IcpConfig,
    intensity: torch.Tensor | None = None,
) -> IcpFrame:
    """Build the ICP pyramid for a depth image, on the depth's device.

    Pass ``intensity`` (H, W float in [0,1]) to enable the photometric
    term (cfg.photometric_weight > 0)."""
    depth = torch.where((depth >= cfg.min_depth) & (depth <= cfg.max_depth), depth, 0.0)
    pyr = build_pyramid(depth, cfg.levels)
    verts, norms, photos = [], [], []
    img = intensity
    for lvl, d in enumerate(pyr):
        c = cam.scaled(0.5**lvl)
        v = vertex_map(c, d)
        verts.append(v)
        norms.append(normal_map(v))
        if img is not None:
            photos.append(photo_map(img))
            img = downsample_intensity(img)
    return IcpFrame(vertices=tuple(verts), normals=tuple(norms), photo=tuple(photos))


def _level_iteration(
    cam_l: CameraIntrinsics, cfg: IcpConfig, src_v, src_n, tgt_v, tgt_n,
    src_ph=None, tgt_ph=None, level: int = 0,
):
    """Returns ``(step, rows)`` for one pyramid level: step(T, assoc) →
    (T', stats, assoc), and its first half alone, rows(T, assoc): the residual
    rows ``(p, q, n, w)`` that the step hands the accumulation kernel.

    With ``cfg.photometric_weight > 0`` and photo maps present, a DVO-style
    intensity residual r_I = I_tgt(π(Tp)) − I_src rides alongside point-to-
    plane. Its Jacobian has the same [a; p×a] structure with a = ∇I·dπ/dp,
    so BOTH residuals accumulate through the one JtJ kernel: the photometric
    rows are (p, q_virtual, a, w) with q_virtual chosen so the kernel's
    n·(p−q) reproduces r_I exactly.
    """

    stride = cfg.source_stride[level] if level < len(cfg.source_stride) else 1
    if stride > 1:
        # Thin the residual sample: the target maps stay full resolution.
        src_v = src_v[::stride, ::stride]
        src_n = src_n[::stride, ::stride]
        if src_ph is not None:
            src_ph = src_ph[::stride, ::stride]
    sv = src_v.reshape(-1, 3)
    sn = src_n.reshape(-1, 3)
    src_valid = (sv[:, 2] > 0) & (torch.sum(sn * sn, dim=-1) > 0.5)

    use_photo = (
        cfg.photometric_weight > 0.0
        and src_ph is not None
        and tgt_ph is not None
    )
    if use_photo and cfg.association != "nearest":
        raise NotImplementedError(
            "photometric term requires association='nearest'"
        )

    # For nearest association everything the step needs — vertex, normal,
    # and optionally intensity+gradient — is packed into ONE flat map and
    # gathered once per iteration.
    th, tw = tgt_v.shape[:2]
    if cfg.association == "nearest":
        packs = [tgt_v.reshape(-1, 3), tgt_n.reshape(-1, 3)]
        if use_photo:
            packs.append(tgt_ph.reshape(-1, 3))
        tgt_pack = torch.cat(packs, dim=-1)
    if use_photo:
        si = src_ph.reshape(-1, 3)[:, 0]  # source intensity

    def rows(T, assoc=None):
        """Warp, associate, gate and weight. ``assoc=None`` performs fresh
        association (the gather); passing the previous step's ``assoc``
        reuses it (standard ICP alternation: several minimize steps per
        association). Returns ``((p, q, n, w), geometric weights, assoc)``."""
        R, t = T[:3, :3], T[:3, 3]
        p = sv @ R.T + t  # source vertices in target frame
        n_src = sn @ R.T

        z = torch.clamp(p[:, 2], min=1e-6)
        u = cam_l.fx * p[:, 0] / z + cam_l.cx
        v = cam_l.fy * p[:, 1] / z + cam_l.cy

        if cfg.association == "nearest":
            if assoc is None:
                # A point at z <= 0 projects as far as 5e8·|x| pixels out:
                # pixel_index clamps before the cast to int32.
                ui = pixel_index(torch.round(u))
                vi = pixel_index(torch.round(v))
                in_b = (ui >= 0) & (ui < tw) & (vi >= 0) & (vi < th)
                idx = torch.clamp(vi, 0, th - 1) * tw + torch.clamp(ui, 0, tw - 1)
                g = tgt_pack[idx.long()]  # the ONE gather
                assoc = (g, in_b, ui, vi)
            g, in_b, ui, vi = assoc
            q, nt = g[:, 0:3], g[:, 3:6]
            q = torch.where(in_b[:, None], q, 0.0)
            nt = torch.where(in_b[:, None], nt, 0.0)
        else:
            uv = torch.stack([u, v], dim=-1)
            q, in_b = bilinear_sample(tgt_v, uv)
            nt, _ = nearest_sample(tgt_n, uv)

        diff = p - q
        dist2 = torch.sum(diff * diff, dim=-1)
        ncos = torch.sum(nt * n_src, dim=-1)
        r = torch.sum(nt * diff, dim=-1)

        valid = (
            src_valid
            & in_b
            & (p[:, 2] > 0)
            & (q[:, 2] > 0)
            & (torch.sum(nt * nt, dim=-1) > 0.5)
            & (dist2 < cfg.dist_threshold**2)
            & (ncos > cfg.normal_threshold)
        )
        # Huber weight on the point-to-plane residual.
        absr = torch.abs(r)
        w_rob = torch.where(
            absr <= cfg.huber_delta, 1.0, cfg.huber_delta / torch.clamp(absr, min=1e-12)
        )
        w = torch.where(valid, w_rob, 0.0)
        out = (p, q, nt, w)

        if use_photo:
            # First-order subpixel correction of the nearest-gathered
            # intensity, then the DVO chain a = ∇I · dπ/dp.
            ti, tgx, tgy = g[:, 6], g[:, 7], g[:, 8]
            du = u - ui.to(u.dtype)
            dv = v - vi.to(v.dtype)
            r_i = ti + tgx * du + tgy * dv - si
            ax = tgx * cam_l.fx / z
            ay = tgy * cam_l.fy / z
            az = -(tgx * cam_l.fx * p[:, 0] + tgy * cam_l.fy * p[:, 1]) / (z * z)
            a = torch.stack([ax, ay, az], dim=-1)
            a2 = torch.sum(a * a, dim=-1)
            valid_ph = (
                src_valid
                & in_b
                & (p[:, 2] > 0)
                & (q[:, 2] > 0)
                & (dist2 < cfg.dist_threshold**2)
                & (a2 > 1e-8)
            )
            abri = torch.abs(r_i)
            w_ph = torch.where(
                abri <= cfg.photo_huber,
                1.0,
                cfg.photo_huber / torch.clamp(abri, min=1e-12),
            )
            w_ph = torch.where(valid_ph, w_ph * cfg.photometric_weight, 0.0)
            # Virtual target point: the kernel computes n·(p − q), so pick
            # q_virt with a·(p − q_virt) = r_I.
            q_virt = p - (r_i / torch.clamp(a2, min=1e-8))[:, None] * a
            # Geometric and photometric rows go through ONE accumulation,
            # so every sum (the error and the weight included) covers both.
            out = (
                torch.cat([p, p]),
                torch.cat([q, q_virt]),
                torch.cat([nt, a]),
                torch.cat([w, w_ph]),
            )
        return tuple(x.contiguous() for x in out), w, assoc

    def step(T, assoc=None):
        """One GN iteration; ``assoc`` as in ``rows``. Returns
        ``(T_new, stats, assoc)``."""
        data, w, assoc = rows(T, assoc)
        JtJ, Jtr, err, wsum_all = icp_jtj_jtr(*data)
        # Overlap bookkeeping stays GEOMETRIC-only (keyframe policy signal).
        wsum = torch.sum(w) if use_photo else wsum_all

        H = JtJ + cfg.damping * torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
        # solve_ex neither checks its status on the host (which would stall
        # the stream once an iteration) nor raises on a singular matrix.
        delta = torch.linalg.solve_ex(H, -Jtr[:, None])[0][:, 0]
        # Guard: if almost nothing associated, take no step.
        delta = torch.where(wsum > 50.0, delta, torch.zeros_like(delta))
        T_new = se3_exp(delta) @ T
        stats = torch.stack([err, wsum])
        return T_new, stats, assoc

    return step, rows


def level_step(cam: CameraIntrinsics, cfg: IcpConfig, src: IcpFrame, tgt: IcpFrame, level: int):
    """``(step, rows)`` of pyramid level ``level`` of a frame pair (see
    :func:`_level_iteration`); ``cam`` is the full-resolution camera."""
    has_photo = len(src.photo) > 0 and len(tgt.photo) > 0
    return _level_iteration(
        cam.scaled(0.5**level), cfg, src.vertices[level], src.normals[level],
        tgt.vertices[level], tgt.normals[level],
        src.photo[level] if has_photo else None,
        tgt.photo[level] if has_photo else None,
        level=level,
    )


def icp_track(
    cam: CameraIntrinsics,
    cfg: IcpConfig,
    T_init: torch.Tensor,
    src: IcpFrame,
    tgt: IcpFrame,
):
    """Track source→target pose by coarse-to-fine projective ICP.

    Returns ``(T, stats)`` where stats is ``(2,)``: final [robust error sum,
    associated weight sum] at the finest level — the weight sum relative to
    the pixel count is the overlap signal keyframe selection uses. Both stay
    on the device; nothing here synchronises with it.
    """
    T = T_init
    stats = torch.zeros(2, dtype=T_init.dtype, device=T_init.device)
    reassoc = max(int(cfg.reassoc_every), 1)
    use_carry = reassoc > 1 and cfg.association == "nearest"
    for lvl in range(cfg.levels - 1, -1, -1):
        step, _ = level_step(cam, cfg, src, tgt, lvl)
        assoc = None
        for i in range(cfg.iters_per_level[lvl]):
            # Iteration i re-associates iff i % reassoc == 0; every other
            # one minimizes again over the association it was handed.
            fresh = not use_carry or i % reassoc == 0
            T, stats, assoc = step(T, None if fresh else assoc)
    return T, stats
