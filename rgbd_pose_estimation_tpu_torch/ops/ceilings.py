"""Arithmetic-ceiling probes of the card (kernels ``csrc/ceilings.cu``).

Counterparts of two TPU kernels of the JAX repository's measurement
harnesses. Each returns an array; the tools (``tools/msac_opt.py``,
``tools/roofline.py``) time it and turn the time into TFLOP/s with the
reference's accounting:

- :func:`msac_op_mix` (T4, ``tools/msac_opt.py::variant_E_ceiling``) — the
  exact MSAC scorer's op mix on register-resident values, no memory traffic
  and no reduction; 23 flops an element and iteration;
- :func:`fma_chain` (T6, ``tools/roofline.py::ceiling_vpu``) — 256 chained
  fused multiply-adds an element; 2·256 flops an element.

Beside them :func:`empty_kernel`, a kernel that does nothing: the floor of
a launch, timed beside the kernels that are bound by theirs.

For CUDA tensors each launches its kernel or raises; the plain versions
(``*_reference``) serve CPU tensors only and give the kernels' exact bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ops import _build

OP_MIX_TAU2 = 0.0025
OP_MIX_FLOPS = 23  # an element and iteration, as the TPU tool counts them
OP_MIX_REPS = 64  # the harness's iterations: compiled into the kernel
FMA_REPS = 256
FMA_SCALE = 0.9999847412109375  # 1 - 2^-16
FMA_SHIFT = 1.52587890625e-05  # 2^-16: a = 1 is the chain's fixed point


@functools.lru_cache(maxsize=8)
def _op_mix_constants(reps: int, device: str) -> torch.Tensor:
    """``f32(1 + 1e-6 i)`` for i < reps: the TPU kernel's per-iteration
    constant, rounded from the double as JAX rounds a Python float. Made
    once per (reps, device); read-only."""
    cs = (1.0 + 1e-6 * np.arange(reps, dtype=np.float64)).astype(np.float32)
    return torch.from_numpy(cs).to(device)


def msac_op_mix(x: torch.Tensor, reps: int = 64) -> torch.Tensor:
    """T4 on ``x`` (R, N) f32, R ≥ 3: every element (r, n) runs ``reps``
    iterations of the scorer's op mix on (x[0, n], x[1, n], x[2, n]) and
    returns acc + cnt; (R, N). On the card ``OP_MIX_REPS`` iterations run
    an instance with the count compiled in, any other count a generic one."""
    if x.dim() != 2 or x.shape[0] < 3 or reps < 1:
        raise ValueError(f"msac_op_mix: expected (R >= 3, N) and reps >= 1, got {tuple(x.shape)}, {reps}")
    if not x.is_cuda:
        return msac_op_mix_reference(x, reps)
    R, N = x.shape
    _build.check_cuda_input("x", x, torch.float32, (R, N), x.device)
    cs = _op_mix_constants(reps, str(x.device))
    out = torch.empty_like(x)
    _build.launch(
        "msac_op_mix_ceiling", x.data_ptr(), cs.data_ptr(), out.data_ptr(),
        R, N, reps, OP_MIX_TAU2,
    )
    return out


def msac_op_mix_reference(x: torch.Tensor, reps: int = 64) -> torch.Tensor:
    """Plain PyTorch version of :func:`msac_op_mix`: the same operations in
    the same order, each rounded on its own."""
    cs = _op_mix_constants(reps, str(x.device))
    px, py, pz = x[0:1], x[1:2], x[2:3]
    acc = torch.zeros_like(x)
    cnt = torch.zeros_like(x)
    for i in range(reps):
        c = cs[i]
        s = c * px + c * py + c * pz + c
        ex, ey, ez = s - px, s - py, s - pz
        e = ex * ex + ey * ey + ez * ez
        acc = acc + torch.clamp(e, max=OP_MIX_TAU2)
        cnt = cnt + (e < OP_MIX_TAU2).to(torch.float32)
    return acc + cnt


def fma_chain(x: torch.Tensor) -> torch.Tensor:
    """T6: ``FMA_REPS`` chained ``a = a·FMA_SCALE + FMA_SHIFT`` on every
    element of ``x`` (f32, any shape); an input of ones returns ones."""
    if not x.is_cuda:
        return fma_chain_reference(x)
    _build.check_cuda_input("x", x, torch.float32, tuple(x.shape), x.device)
    if x.numel() >= 2**31:
        raise ValueError("fma_chain: more than 2^31 - 1 elements")
    out = torch.empty_like(x)
    _build.launch(
        "fma_chain_ceiling", x.data_ptr(), out.data_ptr(), x.numel(), FMA_SCALE, FMA_SHIFT,
    )
    return out


def fma_chain_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fma_chain` (a multiply and an add,
    each rounded: on the fixed point the same values)."""
    a = x
    for _ in range(FMA_REPS):
        a = a * FMA_SCALE + FMA_SHIFT
    return a


def empty_kernel(blocks: int) -> None:
    """Launch ``blocks`` blocks of 256 threads that do nothing, on the
    current CUDA stream. There is nothing to compute, so there is no plain
    version: without a card it raises."""
    if blocks < 1:
        raise ValueError(f"empty_kernel: blocks must be >= 1, got {blocks}")
    _build.launch("empty_kernel", blocks)
