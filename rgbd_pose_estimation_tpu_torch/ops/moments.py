"""Minimal-set moments for RANSAC hypothesis generation.

Counterpart of the JAX package's ``ops/moments.py``. The Horn hypothesis
solver does not need the sampled POINTS — only their MOMENTS:

    sum_p = Σ_{i∈sample} p_i          (3)
    sum_q = Σ_{i∈sample} q_i          (3)
    sum_o = Σ_{i∈sample} p_i q_iᵀ     (9)   [outer products]

so one kernel turns the ``(K, m)`` sampled indices straight into the
``(16, K)`` structure-of-arrays block that
``solvers.absolute_orientation.horn_from_moments`` consumes, and the
``(K, m, 3)`` gathered point tensors are never built.

The CUDA kernel is ``csrc/moments.cu`` (it replaces the JAX package's Pallas
kernel ``_moments_kernel``; the note at the top of the source says what
bounds it on the card and what its design does about that). For CUDA
tensors :func:`minimal_moments` launches it or raises; for CPU tensors it
runs the plain version, :func:`minimal_moments_reference`.
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.ops import _build


def minimal_moments(idx: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-sample moments for K minimal sets.

    Args: ``idx`` (K, m) int32 correspondence indices (distinct within a
    row, each < N), ``p``/``q`` (N, 3) f32; any K, m, N ≥ 1. Returns
    ``(16, K)`` f32: rows 0-2 Σp, 3-5 Σq, 6-14 Σ p⊗q (row-major: p_a q_b at
    6 + a*3 + b), 15 the sample count m.
    """
    if not p.is_cuda:
        return minimal_moments_reference(idx, p, q)
    dev = p.device
    K, m = idx.shape
    N = p.shape[0]
    if min(K, m, N) < 1:
        raise ValueError(f"minimal_moments: empty problem K={K} m={m} N={N}")
    _build.check_cuda_input("idx", idx, torch.int32, (K, m), dev)
    _build.check_cuda_input("p", p, torch.float32, (N, 3), dev)
    _build.check_cuda_input("q", q, torch.float32, (N, 3), dev)
    out = torch.empty((16, K), dtype=torch.float32, device=dev)
    _build.launch(
        "minimal_moments",
        idx.data_ptr(), p.data_ptr(), q.data_ptr(), out.data_ptr(), K, m, N,
    )
    return out


def minimal_moments_reference(idx, p, q) -> torch.Tensor:
    """Plain PyTorch version of :func:`minimal_moments`: the same (16, K)
    moments by gathering. The sums run over the sample in the order
    j = 0..m-1, products rounded before they are added — the kernel's
    arithmetic exactly, so the two agree to the last bit."""
    ix = idx.long()
    pm = p[ix]  # (K, m, 3)
    qm = q[ix]
    K, m = idx.shape
    sp, sq = pm[:, 0], qm[:, 0]
    so = pm[:, 0, :, None] * qm[:, 0, None, :]
    for j in range(1, m):
        sp = sp + pm[:, j]
        sq = sq + qm[:, j]
        so = so + pm[:, j, :, None] * qm[:, j, None, :]
    cnt = torch.full((K, 1), float(m), dtype=p.dtype, device=p.device)
    return torch.cat([sp, sq, so.reshape(K, 9), cnt], dim=-1).T.contiguous()
