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

The CUDA kernel is ``csrc/icp_jtj.cu`` (it replaces both Pallas forms of the
JAX package, VPU and MXU; the note at the top of the source says what bounds
it on the card and what its design does about that). It takes ``p``, ``q``,
``n`` as ``(M, 3)`` and ``w`` as ``(M,)`` — what the tracker has in hand —
with no padding rule; the JAX package's ``(10, S, 128)`` packing is a TPU
layout and has no counterpart here. For CUDA tensors :func:`icp_jtj_jtr`
launches the kernel or raises; for CPU tensors it runs the plain version,
:func:`icp_jtj_jtr_reference`.
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.ops import _build

_THREADS = 256  # threads a block, as in csrc/icp_jtj.cu
_PAIRS = 36  # upper triangle of the symmetric augmented 8x8
_sm_count = {}  # device index → streaming multiprocessors (asked once a device)


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
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = _sm_count[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min((M + _THREADS - 1) // _THREADS, 2 * sms)
    # One allocation: the 8x8 result, then the blocks' (blocks, 36) partial rows.
    buf = torch.empty(64 + blocks * _PAIRS, dtype=torch.float32, device=dev)
    A = buf[:64].view(8, 8)
    _build.launch(
        "icp_jtj_jtr",
        p.data_ptr(), q.data_ptr(), n.data_ptr(), w.data_ptr(),
        buf.data_ptr() + 256, buf.data_ptr(), M, blocks,
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
