"""Closed-form, branchless real-root solvers for cubic/quartic polynomials.

Counterpart of the JAX package's ``core/poly.py``: support code for the
batched P3P minimal solver (``solvers/p3p.py``). Everything is mask-based —
complex roots come back as ``valid=False`` with finite dummy values — so the
functions run over thousands of RANSAC minimal sets with ``torch.where``
only: no boolean indexing, no branch on a tensor's value, nothing read back
to the host.

Roots are polished with a couple of Newton steps at the end, which buys back
the f32 accuracy the closed forms lose to cancellation.

The branches ``disc >= 0`` are taken on f32 values that cancel. Another
compiler (fused multiply-add or not) rounds them differently, so next to a
double root two implementations of these same lines may flag a root pair
differently; away from one they agree.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root, sign-preserving."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_cubic_real(c2, c1, c0):
    """Real roots of z^3 + c2 z^2 + c1 z + c0, batched.

    Returns ``(roots, valid)`` with shapes ``(..., 3)``; invalid slots hold a
    copy of a valid root (so downstream max/min reductions stay correct
    without NaN handling).
    """
    # Depress: z = t - c2/3  →  t^3 + p t + q.
    shift = c2 / 3.0
    p = c1 - c2 * c2 / 3.0
    q = c0 - c1 * c2 / 3.0 + 2.0 * c2 * c2 * c2 / 27.0

    # Discriminant of the depressed cubic.
    disc = -4.0 * p * p * p - 27.0 * q * q
    three_real = disc >= 0.0

    # --- Three-real-roots branch (trigonometric method), needs p < 0. ---
    p_neg = torch.clamp(p, max=-_EPS)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = torch.acos(arg) / 3.0
    k = torch.arange(3, dtype=p.dtype, device=p.device)
    t_trig = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0)

    # --- One-real-root branch (Cardano via cbrt), numerically stable form. ---
    # t = cbrt(-q/2 + sqrt(q^2/4 + p^3/27)) + cbrt(-q/2 - sqrt(...))
    rad = torch.clamp(q * q / 4.0 + p * p * p / 27.0, min=0.0)
    sq = torch.sqrt(rad)
    u = _cbrt(-q / 2.0 + sq)
    v = _cbrt(-q / 2.0 - sq)
    t_single = u + v

    roots = torch.where(
        three_real[..., None], t_trig, t_single[..., None]
    ) - shift[..., None]
    valid = torch.cat(
        [
            torch.ones_like(three_real[..., None]),
            three_real[..., None].expand(three_real.shape + (2,)),
        ],
        dim=-1,
    )
    # Replace invalid slots with root 0 (always valid).
    roots = torch.where(valid, roots, roots[..., :1])

    # Newton polish of every root.
    for _ in range(2):
        f = ((roots + c2[..., None]) * roots + c1[..., None]) * roots + c0[..., None]
        df = (3.0 * roots + 2.0 * c2[..., None]) * roots + c1[..., None]
        roots = roots - f / torch.where(torch.abs(df) < _EPS, _EPS, df)
    return roots, valid


def solve_quartic_real(a4, a3, a2, a1, a0, newton_iters: int = 3):
    """Real roots of a4 x^4 + a3 x^3 + a2 x^2 + a1 x + a0, batched (Ferrari).

    Returns ``(roots, valid)`` with shapes ``(..., 4)``. Leading coefficients
    near zero are clamped (the caller's validity masking must reject such
    degenerate problems). Complex root pairs are flagged invalid and given
    finite dummy values.
    """
    a4_safe = torch.where(torch.abs(a4) < _EPS, _EPS, a4)
    b = a3 / a4_safe
    c = a2 / a4_safe
    d = a1 / a4_safe
    e = a0 / a4_safe

    # Depress: x = y - b/4  →  y^4 + p y^2 + q y + r.
    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

    # Resolvent cubic: z^3 + 2p z^2 + (p^2 - 4r) z - q^2 = 0.
    # It always has a real root >= 0 (value at 0 is -q^2 <= 0).
    zr, zv = solve_cubic_real(2.0 * p, p * p - 4.0 * r, -q * q)
    # Largest valid real root (max is safe: invalid slots duplicate root 0).
    z = torch.amax(torch.where(zv, zr, -math.inf), dim=-1)
    z = torch.clamp(z, min=0.0)

    sqrt_z = torch.sqrt(torch.clamp(z, min=0.0))
    # Guard q / sqrt_z when z ~ 0: then q ~ 0 too (resolvent at 0 = -q^2),
    # and the quartic factors as biquadratic; use the limit form.
    tiny_z = sqrt_z < 1e-8
    qz = torch.where(tiny_z, 0.0, q / torch.where(tiny_z, 1.0, sqrt_z))

    # y^2 - sqrt_z y + (p + z)/2 + qz/2 = 0  and  y^2 + sqrt_z y + (p+z)/2 - qz/2 = 0
    half = (p + z) / 2.0
    c1q = half + qz / 2.0
    c2q = half - qz / 2.0

    disc1 = z / 4.0 - c1q  # ((sqrt_z)/2)^2 - c1q
    disc2 = z / 4.0 - c2q
    s1 = torch.sqrt(torch.clamp(disc1, min=0.0))
    s2 = torch.sqrt(torch.clamp(disc2, min=0.0))

    y = torch.stack(
        [
            sqrt_z / 2.0 + s1,
            sqrt_z / 2.0 - s1,
            -sqrt_z / 2.0 + s2,
            -sqrt_z / 2.0 - s2,
        ],
        dim=-1,
    )
    valid = torch.cat(
        [
            (disc1 >= 0.0)[..., None].expand(disc1.shape + (2,)),
            (disc2 >= 0.0)[..., None].expand(disc2.shape + (2,)),
        ],
        dim=-1,
    )
    roots = y - (b / 4.0)[..., None]
    # Keep invalid slots finite.
    roots = torch.where(valid, roots, 0.0)

    # Newton polish on the *original* quartic (restores f32 accuracy).
    A4, A3, A2, A1, A0 = (
        a4[..., None],
        a3[..., None],
        a2[..., None],
        a1[..., None],
        a0[..., None],
    )
    for _ in range(newton_iters):
        f = (((A4 * roots + A3) * roots + A2) * roots + A1) * roots + A0
        df = ((4.0 * A4 * roots + 3.0 * A3) * roots + 2.0 * A2) * roots + A1
        step = f / torch.where(torch.abs(df) < _EPS, _EPS, df)
        # Don't let a huge step (near-critical point) fling a root away.
        roots = roots - torch.clamp(step, -1e3, 1e3)
    return roots, valid
