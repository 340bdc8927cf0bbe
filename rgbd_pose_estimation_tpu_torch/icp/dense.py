"""Dense projective point-to-plane ICP odometry (KinectFusion-style).

Counterpart of the JAX package's ``icp/dense.py``. Each Gauss-Newton
iteration is three stages —

1. warp: transform every source vertex by the current pose and project it
   into the target camera;
2. associate: gather target vertices / normals at the projected pixels, gate
   by distance / normal-agreement / depth validity, weight by a Huber robust
   kernel;
3. accumulate: reduce the point-to-plane normal equations; a 6x6 damped
   solve and an SE(3) retraction finish the iteration.

On the card, the depth-only step with nearest association (the bench's and
the odometry server's) runs stages 1-3 up to the solve as one hand-written
CUDA kernel (ops/icp_jtj.py::icp_assoc_jtj_jtr). The photometric and the
bilinear steps, and every step on the CPU, make stages 1-2 with tensor
arithmetic (ops/icp_jtj.py::icp_assoc_rows_reference) and accumulate with K4
(ops/icp_jtj.py::icp_jtj_jtr) or its plain version.

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
    build_pyramid,
    downsample_intensity,
    normal_map,
    photo_map,
    vertex_map,
)
from rgbd_pose_estimation_tpu_torch.ops.icp_jtj import (
    icp_assoc_jtj_jtr,
    icp_assoc_rows_reference,
    icp_jtj_jtr,
)
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
    (T', stats, assoc), and rows(T, assoc): the residual rows ``(p, q, n,
    w)`` of the step, in plain PyTorch (ops/icp_jtj.py::icp_assoc_rows_reference).

    On the card, a depth-only step with nearest association is ONE kernel
    (ops/icp_jtj.py::icp_assoc_jtj_jtr): the rows are made and accumulated
    in registers and never reach device memory; its ``assoc`` is the level's
    map of target pixels. Every other step (CPU tensors, the photometric term,
    bilinear association) makes the rows with ``rows`` and accumulates them
    with K4 (ops/icp_jtj.py::icp_jtj_jtr); its ``assoc`` is the tuple
    ``rows`` returns. ``rows`` takes that tuple too.

    With ``cfg.photometric_weight > 0`` and photo maps present, a DVO-style
    intensity residual r_I = I_tgt(π(Tp)) − I_src rides alongside point-to-
    plane. Its Jacobian has the same [a; p×a] structure with a = ∇I·dπ/dp,
    so BOTH residuals accumulate through the one JtJ kernel: the photometric
    rows are (p, q_virtual, a, w) with q_virtual chosen so the kernel's
    n·(p−q) reproduces r_I exactly.
    """

    stride = cfg.source_stride[level] if level < len(cfg.source_stride) else 1
    use_photo = (
        cfg.photometric_weight > 0.0
        and src_ph is not None
        and tgt_ph is not None
    )
    if use_photo and cfg.association != "nearest":
        raise NotImplementedError(
            "photometric term requires association='nearest'"
        )
    intrinsics = (cam_l.fx, cam_l.fy, cam_l.cx, cam_l.cy)
    thresholds = (cfg.dist_threshold, cfg.normal_threshold, cfg.huber_delta)
    fused = tgt_v.is_cuda and cfg.association == "nearest" and not use_photo
    if fused:
        accumulate = icp_assoc_jtj_jtr(src_v, src_n, tgt_v, tgt_n, stride, intrinsics, thresholds)

    # Thin the residual sample: the target maps stay full resolution.
    src_v = src_v[::stride, ::stride]
    src_n = src_n[::stride, ::stride]
    # What rows() needs at every step, made once a level. The fused step needs
    # none of it; on its levels rows() makes it at each call.
    if not fused:
        sv = src_v.reshape(-1, 3)
        sn = src_n.reshape(-1, 3)
        level_inputs = {
            "src_valid": (sv[:, 2] > 0) & (torch.sum(sn * sn, dim=-1) > 0.5),
            "bilinear": cfg.association != "nearest",
        }
        # For nearest association everything the step needs — vertex,
        # normal, and optionally intensity+gradient — is packed into ONE
        # flat map and gathered once per iteration.
        if cfg.association == "nearest":
            packs = [tgt_v.reshape(-1, 3), tgt_n.reshape(-1, 3)]
            if use_photo:
                packs.append(tgt_ph.reshape(-1, 3))
            level_inputs["tgt_pack"] = torch.cat(packs, dim=-1)
        if use_photo:
            si = src_ph[::stride, ::stride].reshape(-1, 3)[:, 0]  # source intensity
            level_inputs["photo"] = (si, cfg.photometric_weight, cfg.photo_huber)

    def rows(T, assoc=None):
        """Warp, associate, gate and weight. ``assoc=None`` performs fresh
        association (the gather); passing the previous call's ``assoc``
        reuses it (standard ICP alternation: several minimize steps per
        association). Returns ``((p, q, n, w), geometric weights, assoc)``."""
        if fused:
            return icp_assoc_rows_reference(
                T, src_v.reshape(-1, 3), src_n.reshape(-1, 3), tgt_v, tgt_n,
                intrinsics, thresholds, assoc)
        return icp_assoc_rows_reference(
            T, sv, sn, tgt_v, tgt_n, intrinsics, thresholds, assoc, **level_inputs)

    def step(T, assoc=None):
        """One GN iteration; ``assoc`` as in ``rows``. Returns
        ``(T_new, stats, assoc)``."""
        if fused:
            JtJ, Jtr, err, wsum, assoc = accumulate(T, assoc)
        else:
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


def level_step(
    cam: CameraIntrinsics, cfg: IcpConfig, src: IcpFrame, tgt: IcpFrame, level: int,
):
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
