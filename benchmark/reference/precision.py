"""The references' matrix product, in the precision a run asks for.

``float32`` is true float32 (TF32 off). ``tf32`` rounds both operands to
TF32 (10 explicit mantissa bits, round to nearest even) and multiplies in
float32, as the tensor cores do: the control one precision step below the
configurations' float32. Emulated by bit arithmetic, so that it reads the
same on the CPU and on the card.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    keep_lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + keep_lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    if precision == "tf32":
        return to_tf32(a) @ to_tf32(b)
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b
