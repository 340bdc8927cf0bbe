"""Point-to-plane JtJ/Jtr accumulation — the dense-ICP hot loop.

Counterpart of the JAX package's ``ops/icp_jtj.py``. Given per-pixel
associated data (source points already transformed into the target camera
frame, gathered target points/normals, robust weights), accumulate the 6x6
Gauss-Newton normal equations for the point-to-plane residual

    r_i = n_i · (p_i - q_i),   J_i = [n_i ; p_i × n_i]   (6-vector)

Augmented-Jacobian trick: append the residual and a constant-1 column to J;
the symmetric 8x8 product of the weighted J then yields *everything* —
``A[:6,:6] = JtJ``, ``A[:6, 6] = Jtr``, ``A[6, 6] = Σ w r²``, ``A[7, 7] =
Σ w`` — without ever materializing the (M, 8) Jacobian in device memory.

Two CUDA entries, one source (``csrc/icp_jtj.cu``; the note at its top says
what bounds each on the card and what the design does about it), each one
launch of one body: rows summed in registers, a row of 36 sums a block, and
the last block's sum of those rows, found by an integer ticket:

- :func:`icp_jtj_jtr` (K4) takes the rows ``p``, ``q``, ``n`` ``(M, 3)`` and
  ``w`` ``(M,)``. It replaces both Pallas forms of the JAX package, VPU and
  MXU; their ``(10, S, 128)`` packing is a TPU layout with no counterpart
  here. For CPU tensors it runs the plain version,
  :func:`icp_jtj_jtr_reference`.
- :func:`icp_assoc_jtj_jtr` is the fused nearest-association, depth-only
  Gauss-Newton step of ``icp/dense.py``: one kernel computes the rows itself
  (warp, project, nearest pixel, gather, gates, Huber weight — the math of
  :func:`icp_assoc_rows_reference`) and accumulates them with K4's sums, so
  the rows never reach device memory. Its plain version is
  :func:`icp_assoc_jtj_jtr_reference`, the rows followed by
  :func:`icp_jtj_jtr_reference`.

For CUDA tensors each launches its kernel or raises.
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.data.geometry import (
    bilinear_sample,
    nearest_sample,
    pixel_index,
)
from rgbd_pose_estimation_tpu_torch.ops import _build

_THREADS = 256  # threads a block, as in csrc/icp_jtj.cu
_PAIRS = 36  # upper triangle of the symmetric augmented 8x8
_sm_count = {}  # device index → streaming multiprocessors (asked once a device)
# K4's tickets: one int32 each, at 0 between launches, held by launches that
# run one after another. (device index, stream handle) → the ticket of eager
# launches on that stream, zeroed when made (never inside a capture);
# (device index, stream handle) → (capture id, ticket) of the CUDA-graph
# capture that stream records, zeroed by a node of that graph at each replay.
_tickets = {}
_captured = {}


def _blocks(M: int, dev) -> int:
    """Grid of K4 and of the fused step: a block per 256 rows, at most two
    per SM; the threads of a smaller grid take more rows in turn."""
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = _sm_count[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return min((M + _THREADS - 1) // _THREADS, 2 * sms)


def _ticket(dev) -> torch.Tensor:
    """K4's ticket for a launch on the current stream, the one
    :func:`_build.launch` launches on. Eager launches on one stream run one
    after another and share the stream's ticket, made at its first eager
    use. A launch recorded into a CUDA graph takes its capture's own, made
    at the capture's first launch on that stream: its zeroing is recorded
    too, so every replay starts from 0, and no other graph or stream holds
    it (replays of one graph run one after another)."""
    stream = torch.cuda.current_stream().cuda_stream
    key = (dev.index, stream)
    capture = _build.capture_id(stream)
    if capture:
        held = _captured.get(key)
        if held is None or held[0] != capture:
            held = _captured[key] = (capture, torch.zeros(1, dtype=torch.int32, device=dev))
        return held[1]
    ticket = _tickets.get(key)
    if ticket is None:
        # Host threads that launch on one stream share its ticket; of two
        # that make it at once, both take the one stored first.
        ticket = _tickets.setdefault(key, torch.zeros(1, dtype=torch.int32, device=dev))
    return ticket


def icp_jtj_jtr(p: torch.Tensor, q: torch.Tensor, n: torch.Tensor, w: torch.Tensor):
    """Accumulate the weighted point-to-plane normal equations.

    Args: ``p``, ``q``, ``n`` ``(M, 3)`` f32, ``w`` ``(M,)`` f32, any M ≥ 1.
    Returns ``(JtJ (6,6), Jtr (6,), err_sum, weight_sum)`` on the inputs'
    device; nothing is read back to the host. Rows of weight 0 are multiplied
    through like any other (a NaN there gives NaN). On the card the result is
    the same to the last bit from run to run.
    """
    if not p.is_cuda:
        return icp_jtj_jtr_reference(p, q, n, w)
    dev = p.device
    M = p.shape[0]
    if M < 1:
        raise ValueError("icp_jtj_jtr: no rows")
    _build.check_cuda_input("p", p, torch.float32, (M, 3), dev)
    _build.check_cuda_input("q", q, torch.float32, (M, 3), dev)
    _build.check_cuda_input("n", n, torch.float32, (M, 3), dev)
    _build.check_cuda_input("w", w, torch.float32, (M,), dev)
    blocks = _blocks(M, dev)
    # One allocation: the 8x8 result, then the blocks' (blocks, 36) partial rows.
    buf = torch.empty(64 + blocks * _PAIRS, dtype=torch.float32, device=dev)
    A = buf[:64].view(8, 8)
    _build.launch(
        "icp_jtj_jtr",
        p.data_ptr(), q.data_ptr(), n.data_ptr(), w.data_ptr(),
        buf.data_ptr() + 256, buf.data_ptr(), _ticket(dev).data_ptr(), M, blocks,
    )
    return A[:6, :6], A[:6, 6], A[6, 6], A[7, 7]


def icp_jtj_jtr_reference(p, q, n, w):
    """Plain PyTorch version of :func:`icp_jtj_jtr`: builds the (M, 8)
    augmented Jacobian and takes its weighted product."""
    j_rot = torch.linalg.cross(p, n, dim=-1)
    r = torch.sum(n * (p - q), dim=-1)
    one = torch.ones_like(w)
    J = torch.cat([n, j_rot, r[:, None], one[:, None]], dim=-1)  # (M, 8)
    A = torch.einsum("mi,mj->ij", J * w[:, None], J)
    return A[:6, :6], A[:6, 6], A[6, 6], A[7, 7]


# --------------------------------------------------------------------------
# The rows of one Gauss-Newton step, and the fused step
# --------------------------------------------------------------------------


def icp_assoc_rows_reference(
    T, sv, sn, tgt_v, tgt_n, intrinsics, thresholds, assoc=None, *,
    src_valid=None, tgt_pack=None, bilinear=False, photo=None,
):
    """Warp, associate, gate and weight: the rows one dense-ICP step hands
    the accumulation (the JAX package's ``icp/dense.py::_level_iteration``).

    Args:
      T: ``(4, 4)`` source → target pose.
      sv, sn: ``(M, 3)`` source vertices and normals (the strided sample).
      tgt_v, tgt_n: ``(th, tw, 3)`` target vertex and normal maps.
      intrinsics: ``(fx, fy, cx, cy)`` of the level.
      thresholds: ``(dist_threshold, normal_threshold, huber_delta)``.
      assoc: nearest association only: ``None`` associates afresh (the
        gather); the ``assoc`` an earlier call returned reuses its pixels.
      src_valid, tgt_pack: what a caller stepping many times at one level
        makes once — the source rows' validity, and the flat target map the
        nearest association gathers from, ``(th·tw, C)``: vertex, normal,
        then whatever else rides along; made here when not given.
      bilinear: bilinear association instead of nearest.
      photo: ``(source intensity (M,), weight, huber)`` adds the DVO-style
        photometric rows; ``tgt_pack`` then holds ``[I, dI/du, dI/dv]`` in
        columns 6:9. Needs nearest association.

    Returns ``((p, q, n, w), geometric weights (M,), assoc)``: with photo
    the rows are the geometric rows followed by the photometric ones. The
    nearest association's ``assoc`` is ``(gathered pack rows, in_bounds, ui,
    vi)``; bilinear returns ``None``.
    """
    fx, fy, cx, cy = intrinsics
    dist_threshold, normal_threshold, huber_delta = thresholds
    if src_valid is None:
        src_valid = (sv[:, 2] > 0) & (torch.sum(sn * sn, dim=-1) > 0.5)
    th, tw = tgt_v.shape[:2]
    R, t = T[:3, :3], T[:3, 3]
    p = sv @ R.T + t  # source vertices in target frame
    n_src = sn @ R.T

    z = torch.clamp(p[:, 2], min=1e-6)
    u = fx * p[:, 0] / z + cx
    v = fy * p[:, 1] / z + cy

    if not bilinear:
        if assoc is None:
            if tgt_pack is None:
                tgt_pack = torch.cat([tgt_v.reshape(-1, 3), tgt_n.reshape(-1, 3)], dim=-1)
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
        & (dist2 < dist_threshold**2)
        & (ncos > normal_threshold)
    )
    # Huber weight on the point-to-plane residual.
    absr = torch.abs(r)
    w_rob = torch.where(absr <= huber_delta, 1.0, huber_delta / torch.clamp(absr, min=1e-12))
    w = torch.where(valid, w_rob, 0.0)
    out = (p, q, nt, w)

    if photo is not None:
        si, photometric_weight, photo_huber = photo
        # First-order subpixel correction of the nearest-gathered
        # intensity, then the DVO chain a = ∇I · dπ/dp.
        ti, tgx, tgy = g[:, 6], g[:, 7], g[:, 8]
        du = u - ui.to(u.dtype)
        dv = v - vi.to(v.dtype)
        r_i = ti + tgx * du + tgy * dv - si
        ax = tgx * fx / z
        ay = tgy * fy / z
        az = -(tgx * fx * p[:, 0] + tgy * fy * p[:, 1]) / (z * z)
        a = torch.stack([ax, ay, az], dim=-1)
        a2 = torch.sum(a * a, dim=-1)
        valid_ph = (
            src_valid
            & in_b
            & (p[:, 2] > 0)
            & (q[:, 2] > 0)
            & (dist2 < dist_threshold**2)
            & (a2 > 1e-8)
        )
        abri = torch.abs(r_i)
        w_ph = torch.where(abri <= photo_huber, 1.0, photo_huber / torch.clamp(abri, min=1e-12))
        w_ph = torch.where(valid_ph, w_ph * photometric_weight, 0.0)
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


def icp_assoc_jtj_jtr_reference(
    T, src_v, src_n, tgt_v, tgt_n, stride, intrinsics, thresholds, assoc=None,
):
    """Plain PyTorch version of one call of :func:`icp_assoc_jtj_jtr`'s
    step: the rows of the source sample ``src_v[::stride, ::stride]``
    (:func:`icp_assoc_rows_reference`, nearest association, no photometric
    rows), then :func:`icp_jtj_jtr_reference`. Returns ``(JtJ, Jtr,
    err_sum, weight_sum, assoc)`` with the tuple ``assoc`` of
    :func:`icp_assoc_rows_reference`."""
    sv = src_v[::stride, ::stride].reshape(-1, 3)
    sn = src_n[::stride, ::stride].reshape(-1, 3)
    rows, _, assoc = icp_assoc_rows_reference(T, sv, sn, tgt_v, tgt_n, intrinsics, thresholds, assoc)
    return (*icp_jtj_jtr_reference(*rows), assoc)


def icp_assoc_jtj_jtr(src_v, src_n, tgt_v, tgt_n, stride: int, intrinsics, thresholds):
    """The fused nearest-association, depth-only Gauss-Newton step of one
    pyramid level, up to its normal equations.

    Args:
      src_v, src_n: ``(H, W, 3)`` f32 source vertex and normal maps; the
        sample is ``src_v[::stride, ::stride]``, M = ceil(H/stride) ·
        ceil(W/stride) rows.
      tgt_v, tgt_n: ``(th, tw, 3)`` f32 target maps.
      intrinsics: ``(fx, fy, cx, cy)`` of the level.
      thresholds: ``(dist_threshold, normal_threshold, huber_delta)``.

    Returns ``accumulate(T, assoc=None) → (JtJ (6,6), Jtr (6,), err_sum,
    weight_sum, assoc)`` for a ``(4, 4)`` f32 pose ``T`` on the maps'
    device: the sums of :func:`icp_jtj_jtr` over the rows
    :func:`icp_assoc_rows_reference` makes, nothing read back to the host.
    ``assoc=None`` associates afresh; passing the ``assoc`` of the previous
    call reuses its pixels (a carried step). What ``assoc`` holds is the
    route's own: on the card it is the level's ``(M,)`` int32 map of target
    pixels (-1 out of bounds), on the CPU the tuple of the plain version.

    For CUDA tensors the shapes are checked and the buffers allocated here,
    once a level; each call is one launch of the kernel. The sums of a call
    are views of one buffer that the next call of the same level overwrites,
    and a fresh call rewrites the association map in place: use a call's
    results (in stream order) before the next call. For CPU tensors each
    call runs :func:`icp_assoc_jtj_jtr_reference`.
    """
    maps = (src_v, src_n, tgt_v, tgt_n)
    if not tgt_v.is_cuda:
        return lambda T, assoc=None: icp_assoc_jtj_jtr_reference(
            T, *maps, stride, intrinsics, thresholds, assoc)
    return _FusedStep(maps, stride, intrinsics, thresholds)


class _FusedStep:
    """:func:`icp_assoc_jtj_jtr` on the card: one level's checked shapes,
    buffers and kernel arguments, and the launch."""

    def __init__(self, maps, stride, intrinsics, thresholds):
        src_v, src_n, tgt_v, tgt_n = maps
        dev = tgt_v.device
        H, W = src_v.shape[:2]
        th, tw = tgt_v.shape[:2]
        if stride < 1 or min(H, W, th, tw) < 1:
            raise ValueError(f"icp_assoc_jtj_jtr: stride {stride}, source {H}x{W}, target {th}x{tw}")
        for name, x, shape in (("src_v", src_v, (H, W, 3)), ("src_n", src_n, (H, W, 3)),
                               ("tgt_v", tgt_v, (th, tw, 3)), ("tgt_n", tgt_n, (th, tw, 3))):
            _build.check_cuda_input(name, x, torch.float32, shape, dev)
        M = -(-H // stride) * -(-W // stride)
        blocks = _blocks(M, dev)
        # The 8x8 result, then the blocks' (blocks, 36) partial rows; the
        # ticket starts at 0 and every launch leaves it at 0.
        buf = torch.empty(64 + blocks * _PAIRS, dtype=torch.float32, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.index = torch.empty(M, dtype=torch.int32, device=dev)
        fx, fy, cx, cy = intrinsics
        dist_threshold, normal_threshold, huber_delta = thresholds
        # The kernel reads the maps and writes buf, the ticket and the index
        # by address: this object keeps them alive.
        self.maps, self.device = maps, dev
        self.args = (
            src_v.data_ptr(), src_n.data_ptr(), tgt_v.data_ptr(), tgt_n.data_ptr(),
            self.index.data_ptr(), buf.data_ptr() + 256, buf.data_ptr(), self.ticket.data_ptr(),
            H, W, stride, th, tw, blocks,
            fx, fy, cx, cy, float(dist_threshold) ** 2, normal_threshold, huber_delta,
        )
        A = buf[:64].view(8, 8)
        self.result = (A[:6, :6], A[:6, 6], A[6, 6], A[7, 7], self.index)
        self.associated = False  # the index map holds pixels only after a fresh call

    def __call__(self, T, assoc=None):
        if (T.device != self.device or T.dtype != torch.float32 or T.shape != (4, 4)
                or not T.is_contiguous()):
            raise ValueError(f"icp_assoc_jtj_jtr: T must be a contiguous (4, 4) float32 tensor on "
                             f"{self.device}, got {tuple(T.shape)} {T.dtype} on {T.device}")
        if assoc is not None and (assoc is not self.index or not self.associated):
            raise ValueError("icp_assoc_jtj_jtr: assoc must be None or what this level's last call returned")
        _build.launch("icp_assoc_jtj_jtr", *self.args, T.data_ptr(), int(assoc is None))
        self.associated = True
        return self.result
