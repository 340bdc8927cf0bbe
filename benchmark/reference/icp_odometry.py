"""Plain reference of dense frame-to-keyframe ICP odometry (configuration 3).

Written from the method's description, in plain PyTorch, for the benchmark's
check: depth in sensor units → metres; a pyramid of 2x2 means of the valid
texels; vertex maps; normals from central differences, turned to face the
camera; coarse-to-fine projective point-to-plane Gauss-Newton with nearest
association (pixel rounded half to even), the source thinned by a stride a
level, fresh association every ``reassoc_every``-th iteration and the last
association reused between, distance, normal and validity gates, a Huber
weight, a damped 6x6 solve and a left update ``T ← exp(δ) T`` with
δ = [v, ω]; no step when the weight sum is 50 or less. The keyframe policy
and the pipelined order of a stream (a frame's track is dispatched before
the results of the ``pipeline_depth`` frames before it are read; a frame
starts from the pose of the previous dispatch when both track against the
same keyframe, else from the last read relative pose) follow the server's
documented behaviour.

Imports torch and numpy only. Every product of matrices goes through
:func:`benchmark.reference.precision.matmul`, so that the same code gives the
float32 reference and its TF32 control.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from benchmark.reference.precision import matmul


def depth_metres(depth_u16: np.ndarray, scale: float, device) -> torch.Tensor:
    d = torch.from_numpy(depth_u16.astype(np.int32)).to(device)
    return d.to(torch.float32) * scale


def _half(depth):
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    ok = (d > 0).to(d.dtype)
    s = (d * ok).sum(dim=(1, 3))
    n = ok.sum(dim=(1, 3))
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), 0.0)


def _vertices(cam, depth):
    fx, fy, cx, cy = cam
    h, w = depth.shape
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    return torch.stack([(u - cx) / fx * depth, (v - cy) / fy * depth, depth], dim=-1)


def _normals(vert):
    h, w, _ = vert.shape
    dx = vert[1:-1, 2:] - vert[1:-1, :-2]
    dy = vert[2:, 1:-1] - vert[:-2, 1:-1]
    n = torch.stack([
        dx[..., 1] * dy[..., 2] - dx[..., 2] * dy[..., 1],
        dx[..., 2] * dy[..., 0] - dx[..., 0] * dy[..., 2],
        dx[..., 0] * dy[..., 1] - dx[..., 1] * dy[..., 0],
    ], dim=-1)
    norm = torch.sqrt((n * n).sum(-1, keepdim=True))
    n = n / torch.clamp(norm, min=1e-12)
    c = vert[1:-1, 1:-1]
    n = torch.where((n * c).sum(-1, keepdim=True) > 0, -n, n)
    z = vert[..., 2]
    ok = ((z[1:-1, 1:-1] > 0) & (z[1:-1, 2:] > 0) & (z[1:-1, :-2] > 0) & (z[2:, 1:-1] > 0)
          & (z[:-2, 1:-1] > 0) & (norm[..., 0] > 1e-12))
    out = torch.zeros_like(vert)
    out[1:-1, 1:-1] = torch.where(ok[..., None], n, 0.0)
    return out


def make_frame(cam, depth, icp):
    """(vertex maps, normal maps) a level, finest first."""
    depth = torch.where((depth >= icp["min_depth"]) & (depth <= icp["max_depth"]), depth, 0.0)
    verts, norms = [], []
    for lvl in range(icp["levels"]):
        if lvl:
            depth = _half(depth)
        s = 0.5**lvl
        v = _vertices(tuple(c * s for c in cam), depth)
        verts.append(v)
        norms.append(_normals(v))
    return verts, norms


def _exp(delta):
    """SE(3) exponential of δ = [v, ω], in float64, as float32 (4, 4)."""
    d = delta.to(torch.float64)
    v, w = d[:3], d[3:]
    th = torch.linalg.norm(w)
    zero = torch.zeros((), dtype=torch.float64, device=d.device)
    W = torch.stack([torch.stack([zero, -w[2], w[1]]), torch.stack([w[2], zero, -w[0]]),
                     torch.stack([-w[1], w[0], zero])])
    I = torch.eye(3, dtype=torch.float64, device=d.device)
    small = th < 1e-8
    t = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0, torch.sin(t) / t)
    b = torch.where(small, 0.5, (1 - torch.cos(t)) / t**2)
    c = torch.where(small, 0.0, (t - torch.sin(t)) / t**3)
    W2 = torch.where(small, zero, 1.0) * (W @ W)
    R, V = I + a * W + b * W2, I + b * W + c * W2
    T = torch.eye(4, dtype=torch.float64, device=d.device)
    T[:3, :3], T[:3, 3] = R, V @ v
    return T.to(torch.float32)


def _step(cam_l, icp, stride, src_v, src_n, tgt_v, tgt_n, T, assoc, precision):
    fx, fy, cx, cy = cam_l
    th, tw, _ = tgt_v.shape
    s = src_v[::stride, ::stride].reshape(-1, 3)
    m = src_n[::stride, ::stride].reshape(-1, 3)
    src_ok = (s[:, 2] > 0) & ((m * m).sum(-1) > 0.5)
    R, t = T[:3, :3], T[:3, 3]
    p = matmul(s, R.T.contiguous(), precision) + t
    u_n = matmul(m, R.T.contiguous(), precision)
    if assoc is None:
        z = torch.clamp(p[:, 2], min=1e-6)
        u = torch.round(fx * p[:, 0] / z + cx)
        v = torch.round(fy * p[:, 1] / z + cy)
        inb = (u >= 0) & (u < tw) & (v >= 0) & (v < th)
        assoc = torch.where(inb, v.clamp(0, th - 1).long() * tw + u.clamp(0, tw - 1).long(), -1)
    hit = assoc >= 0
    ix = assoc.clamp(min=0)
    q = torch.where(hit[:, None], tgt_v.reshape(-1, 3)[ix], 0.0)
    n = torch.where(hit[:, None], tgt_n.reshape(-1, 3)[ix], 0.0)
    d = p - q
    r = (n * d).sum(-1)
    ok = (src_ok & hit & (p[:, 2] > 0) & (q[:, 2] > 0) & ((n * n).sum(-1) > 0.5)
          & ((d * d).sum(-1) < icp["dist_threshold"] ** 2) & ((n * u_n).sum(-1) > icp["normal_threshold"]))
    ar = r.abs()
    hub = icp["huber_delta"]
    w = torch.where(ok, torch.where(ar <= hub, 1.0, hub / torch.clamp(ar, min=1e-12)), 0.0)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)
    wJ = (J * w[:, None]).T.contiguous()
    JtJ = matmul(wJ, J, precision)
    Jtr = matmul(wJ, r[:, None].contiguous(), precision)[:, 0]
    wsum = w.sum()
    H = JtJ + icp["damping"] * torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    delta = torch.linalg.solve_ex(H.double(), -Jtr.double())[0].float()
    delta = torch.where(wsum > 50.0, delta, 0.0)
    return matmul(_exp(delta), T, precision), wsum, assoc


def track(cam, icp, T_init, src, tgt, precision="float32"):
    """Source→target pose of one frame pair; returns (T, finest weight sum)."""
    T, wsum = T_init, torch.zeros((), device=T_init.device)
    k = max(int(icp["reassoc_every"]), 1)
    for lvl in range(icp["levels"] - 1, -1, -1):
        s = 0.5**lvl
        cam_l = tuple(c * s for c in cam)
        stride = icp["source_stride"][lvl] if lvl < len(icp["source_stride"]) else 1
        assoc = None
        for i in range(icp["iters_per_level"][lvl]):
            T, wsum, assoc = _step(cam_l, icp, stride, src[0][lvl], src[1][lvl], tgt[0][lvl],
                                   tgt[1][lvl], T, None if i % k == 0 else assoc, precision)
    return T, wsum


def inverse(T):
    """Inverse of a rigid (4, 4) pose, in float64."""
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def odometry_stream(cam, icp, keyframe, depth_scale, frames_u16, pipeline_depth, device,
                    precision="float32"):
    """World→camera pose (float64 (4, 4)) and keyframe index of each frame of
    one stream, in the order a pipelined server returns them."""
    kfs = []  # (index, pose, frame, ref_w)
    poses, kf_of = {}, {}
    last_rel = np.eye(4)
    pending = collections.deque()
    last = None

    def new_kf(i, pose, frame, ref_w):
        nonlocal last_rel
        kfs.append((i, pose, frame, ref_w))
        last_rel = np.eye(4)

    def resolve(i, kf, frame, T, wsum, ref_w):
        nonlocal last_rel
        T_rel = T.double().cpu().numpy()
        pose = inverse(inverse(kf[1]) @ T_rel)
        poses[i], kf_of[i] = pose, kf[0]
        last_rel = T_rel
        overlap = float(wsum) / max(kf[3], 1e-6)
        if ((overlap < keyframe["min_inlier_ratio"] or i - kf[0] >= keyframe["max_interval"])
                and len(kfs) < keyframe["max_keyframes"]):
            new_kf(i, pose, frame, ref_w)

    for i, d16 in enumerate(frames_u16):
        frame = make_frame(cam, depth_metres(d16, depth_scale, device), icp)
        ref_w = float(((frame[1][0] ** 2).sum(-1) > 0.5).sum())
        if not kfs:
            poses[i], kf_of[i] = np.eye(4), i
            new_kf(i, np.eye(4), frame, ref_w)
            continue
        kf = kfs[-1]
        if last is not None and last[0] is kf:
            T_init = last[1]
        else:
            T_init = torch.tensor(last_rel, dtype=torch.float32, device=device)
        T, wsum = track(cam, icp, T_init, frame, kf[2], precision)
        pending.append((i, kf, frame, T, wsum, ref_w))
        last = (kf, T)
        while len(pending) > max(1, pipeline_depth):
            resolve(*pending.popleft())
    while pending:
        resolve(*pending.popleft())
    return poses, kf_of
