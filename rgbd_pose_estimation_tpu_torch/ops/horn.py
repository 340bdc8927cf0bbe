"""Launchers of the 3D-3D estimator's Horn kernels (``csrc/horn.cu``).

Two kernels run Horn's eigen solve (``csrc/horn.cuh``) one problem a
thread, in registers:

- :func:`horn_hypotheses` — the K hypotheses from the ``(16, K)`` moments
  that ``ops/moments.py::minimal_moments`` writes, one launch; its plain
  version is ``solvers/absolute_orientation.py::horn_from_moments_reference``;
- :func:`horn_refit_3d3d` — the estimator's whole refit (``rounds`` weighted
  Horn solves on the hard inliers of the current pose, then the final
  inliers) in one launch of one block; its plain version is
  ``ransac/engine.py::_refit_3d3d_reference``.

Both launch on PyTorch's current stream and read nothing back. They take
CUDA tensors only: the callers run the plain versions for CPU tensors.
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.ops import _build


def horn_hypotheses(mom: torch.Tensor, iters: int) -> torch.Tensor:
    """``(K, 4, 4)`` f32 poses from ``(16, K)`` f32 moments, ``iters`` block
    power steps each."""
    dev = mom.device
    K = mom.shape[-1]
    if K < 1 or iters < 0:
        raise ValueError(f"horn_hypotheses: K={K} iters={iters}")
    _build.check_cuda_input("mom", mom, torch.float32, (16, K), dev)
    out = torch.empty((K, 4, 4), dtype=torch.float32, device=dev)
    _build.launch("horn_hypotheses", mom.data_ptr(), out.data_ptr(), K, iters)
    return out


def horn_refit_3d3d(T0, p, q, tau2: float, rounds: int, min_inliers: int):
    """The refit from the pose ``T0`` ``(4, 4)`` on ``p``, ``q`` ``(N, 3)``
    f32. Returns ``(pose (4, 4) f32, inlier mask (N,) bool, count () f32,
    valid () bool)``."""
    dev = p.device
    N = p.shape[0]
    if rounds < 0:
        raise ValueError(f"horn_refit_3d3d: rounds={rounds}")
    T0, p, q = T0.contiguous(), p.contiguous(), q.contiguous()
    _build.check_cuda_input("T0", T0, torch.float32, (4, 4), dev)
    _build.check_cuda_input("p", p, torch.float32, (N, 3), dev)
    _build.check_cuda_input("q", q, torch.float32, (N, 3), dev)
    pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
    mask = torch.empty((N,), dtype=torch.bool, device=dev)
    num = torch.empty((), dtype=torch.float32, device=dev)
    valid = torch.empty((), dtype=torch.bool, device=dev)
    _build.launch(
        "horn_refit_3d3d",
        p.data_ptr(), q.data_ptr(), T0.data_ptr(), pose.data_ptr(), mask.data_ptr(),
        num.data_ptr(), valid.data_ptr(), N, rounds, float(tau2), int(min_inliers),
    )
    return pose, mask, num, valid
