"""Measurement variants of the 3D-3D MSAC scorer.

Counterpart of the variants of the JAX repository's ``tools/msac_opt.py``,
which hold the production scorer against other forms of the same function.
Each takes ``(K, 4, 4)`` poses, ``(N, 3)`` p and q and the threshold τ, and
returns per pose ``Σ_n min(e_kn, τ²)`` and, except D, the inlier count
``Σ_n [e_kn < τ²]``:

- :func:`variant_A` (T1) — the exact scorer's function,
  e = |R p + t − q|², on K3's pose-stationary kernel
  (``csrc/msac_exact.cuh``, entry in ``csrc/msac_variants.cu``) with the
  poses a thread holds as an argument, the counterpart of the TPU tool's KT
  sweep;
- :func:`variant_D` (T5) — A without the count;
- :func:`variant_C` (T2) — the 17-term quad form e = feat_k · pn_n of
  ``ops/ransac_score.py::_quad_features`` in f32 on the CUDA cores (K2's
  kernel with its flags turned: operands not rounded, min instead of clip,
  a count; ``csrc/quad_score.cu``);
- :func:`variant_M` (T3) — the same function on the tensor cores, 3xTF32
  (``csrc/quad_mma.cu``);
- :func:`quad_fused_cuda_cores` — K2's function (``Σ_n clip(e_kn, 0, τ²)``
  on bf16-rounded operands, no count) on K2's first, CUDA-core design
  (``csrc/quad_score.cu``), kept beside the tensor-core kernel that the
  estimator launches so that the two are timed on one card;
- :func:`variant_X` — the library route: ``torch.matmul`` of the quad form,
  then clamp and sums. Never a kernel of this package and never on a path;
  the tools time it beside the kernels.

C, M and X equal A only for orthonormal rotations (the quad form uses
|R p| = |p|); for other poses they differ from A by design.

Each kernel's wrapper launches it for CUDA tensors or raises; the plain
versions beside them (``*_reference``; for C and M on the features,
:func:`quad_C_reference`, :func:`quad_M_reference`) serve CPU tensors only.
"""

from __future__ import annotations

import contextlib

import torch

from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import (
    _quad_features,
    _quad_scores_reference,
    _score_packed_reference,
    pack_poses,
)

POSES_PER_THREAD = (1, 2, 4)
# K3's own choice at the harness's K = 32768 (csrc/msac_exact.cuh,
# estimator_poses_per_thread).
K3_POSES_PER_THREAD = 4


def _check_poses(name, poses, p, q):
    dev = poses.device
    K, N = poses.shape[0], p.shape[0]
    if min(K, N) < 1:
        raise ValueError(f"{name}: empty problem K={K} N={N}")
    _build.check_cuda_input("poses", poses, torch.float32, (K, 12), dev)
    _build.check_cuda_input("p", p, torch.float32, (N, 3), dev)
    _build.check_cuda_input("q", q, torch.float32, (N, 3), dev)
    return K, N


def _check_poses_per_thread(poses_per_thread: int) -> None:
    if poses_per_thread not in POSES_PER_THREAD:
        raise ValueError(f"poses_per_thread must be one of {POSES_PER_THREAD}, got {poses_per_thread}")


def _packed(T):
    """``(K, 4, 4)`` poses packed to ``(K, 12)``; packed rows pass as they are."""
    return T if T.dim() == 2 else pack_poses(T)


def variant_A(T, p, q, tau: float, poses_per_thread: int = K3_POSES_PER_THREAD):
    """T1: exact f32 MSAC score and inlier count, both ``(K,)``, with
    ``poses_per_thread`` (P) poses in the registers of each thread: a
    block of 256 threads scores 32·P poses. ``T`` is ``(K, 4, 4)`` or packed
    ``(K, 12)`` (``pack_poses``)."""
    _check_poses_per_thread(poses_per_thread)
    poses = _packed(T)
    if not poses.is_cuda:
        return variant_A_reference(T, p, q, tau)
    K, N = _check_poses("variant_A", poses, p, q)
    msac = torch.empty((K,), dtype=torch.float32, device=poses.device)
    count = torch.empty((K,), dtype=torch.float32, device=poses.device)
    _build.launch(
        "msac_variant_a", poses.data_ptr(), p.data_ptr(), q.data_ptr(),
        msac.data_ptr(), count.data_ptr(), K, N, float(tau) ** 2, poses_per_thread,
    )
    return msac, count


def variant_A_reference(T, p, q, tau: float):
    """Plain PyTorch version of :func:`variant_A` (builds (K, N, 3))."""
    return _score_packed_reference(_packed(T), p, q, tau)


def variant_D(T, p, q, tau: float, poses_per_thread: int = K3_POSES_PER_THREAD):
    """T5: :func:`variant_A`'s score alone, ``(K,)``."""
    _check_poses_per_thread(poses_per_thread)
    poses = _packed(T)
    if not poses.is_cuda:
        return variant_D_reference(T, p, q, tau)
    K, N = _check_poses("variant_D", poses, p, q)
    msac = torch.empty((K,), dtype=torch.float32, device=poses.device)
    _build.launch(
        "msac_variant_d", poses.data_ptr(), p.data_ptr(), q.data_ptr(),
        msac.data_ptr(), K, N, float(tau) ** 2, poses_per_thread,
    )
    return msac


def variant_D_reference(T, p, q, tau: float):
    return variant_A_reference(T, p, q, tau)[0]


def _min_count(e, tau: float):
    """Row sums of min(e, τ²) and [e < τ²]; torch.clamp keeps NaN."""
    tau2 = tau * tau
    return torch.sum(torch.clamp(e, max=tau2), dim=1), torch.sum((e < tau2).to(torch.float32), dim=1)


def _quad_launch(name, feat, pn, tau: float):
    dev = feat.device
    K, N = feat.shape[0], pn.shape[1]
    if min(K, N) < 1:
        raise ValueError(f"{name}: empty problem K={K} N={N}")
    _build.check_cuda_input("feat", feat, torch.float32, (K, 17), dev)
    _build.check_cuda_input("pn", pn, torch.float32, (17, N), dev)
    msac = torch.empty((K,), dtype=torch.float32, device=dev)
    count = torch.empty((K,), dtype=torch.float32, device=dev)
    _build.launch(
        name, feat.data_ptr(), pn.data_ptr(), msac.data_ptr(), count.data_ptr(),
        K, N, float(tau) ** 2,
    )
    return msac, count


def variant_C(T, p, q, tau: float):
    """T2: the f32 quad form on the CUDA cores, ``(msac, count)``."""
    return quad_C(*_quad_features(T, p, q), tau)


def quad_C(feat, pn, tau: float):
    """T2 on prebuilt f32 operands ``feat (K, 17)``, ``pn (17, N)``."""
    if not feat.is_cuda:
        return quad_C_reference(feat, pn, tau)
    return _quad_launch("msac_variant_c", feat, pn, tau)


def quad_C_reference(feat, pn, tau: float):
    """The 17 terms of every entry added in feature order, as the TPU
    kernel does; builds (K, N)."""
    e = feat[:, 0:1] * pn[0:1, :]
    for f in range(1, feat.shape[1]):
        e = e + feat[:, f : f + 1] * pn[f : f + 1, :]
    return _min_count(e, tau)


def variant_M(T, p, q, tau: float):
    """T3: the f32 quad form on the tensor cores (3xTF32), ``(msac, count)``."""
    return quad_M(*_quad_features(T, p, q), tau)


def quad_M(feat, pn, tau: float):
    """T3 on prebuilt f32 operands ``feat (K, 17)``, ``pn (17, N)``."""
    if not feat.is_cuda:
        return quad_M_reference(feat, pn, tau)
    return _quad_launch("msac_variant_m", feat, pn, tau)


def quad_fused_cuda_cores(feat, pn, tau: float):
    """K2's ranking scores ``(K,)`` on prebuilt f32 operands ``feat (K, 17)``,
    ``pn (17, N)``, by its CUDA-core design; the plain version is K2's,
    ``ops.ransac_score._quad_scores_reference``."""
    if not feat.is_cuda:
        return _quad_scores_reference(feat, pn, tau)
    dev = feat.device
    K, N = feat.shape[0], pn.shape[1]
    if min(K, N) < 1:
        raise ValueError(f"quad_fused_cuda_cores: empty problem K={K} N={N}")
    _build.check_cuda_input("feat", feat, torch.float32, (K, 17), dev)
    _build.check_cuda_input("pn", pn, torch.float32, (17, N), dev)
    out = torch.empty((K,), dtype=torch.float32, device=dev)
    _build.launch("quad_fused_cuda_cores", feat.data_ptr(), pn.data_ptr(), out.data_ptr(),
                  K, N, float(tau) ** 2)
    return out


@contextlib.contextmanager
def _full_f32_matmul():
    """Matrix products in full f32 inside the block (TF32 off), whatever
    the process set; the settings are restored after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def quad_M_reference(feat, pn, tau: float):
    """One full-f32 matrix product, then the epilogue; builds (K, N)."""
    with _full_f32_matmul():
        e = feat @ pn
    return _min_count(e, tau)


def variant_X(T, p, q, tau: float, precision: str | None = None):
    """The library route of the quad form: ``torch.matmul``, clamp, sums.

    ``precision=None``: bf16 operands (PyTorch's bf16 product also returns
    bf16, so each entry is rounded to bf16 before the epilogue);
    ``"highest"``: f32 with TF32 off. Builds the (K, N) matrix in device
    memory; it is the yardstick of T2 and T3, never their fallback."""
    return quad_X(*_quad_features(T, p, q), tau, precision)


def quad_X(feat, pn, tau: float, precision: str | None = None):
    """:func:`variant_X` on prebuilt f32 operands ``feat (K, 17)``, ``pn (17, N)``."""
    if precision not in (None, "highest"):
        raise ValueError(f"precision must be None or 'highest', got {precision!r}")
    if precision is None:
        e = (feat.bfloat16() @ pn.bfloat16()).float()
    else:
        with _full_f32_matmul():
            e = feat @ pn
    return _min_count(e, tau)
