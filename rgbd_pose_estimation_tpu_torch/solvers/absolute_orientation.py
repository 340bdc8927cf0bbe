"""3D-3D absolute orientation (rigid registration) solvers, batched.

Counterpart of the JAX package's ``solvers/absolute_orientation.py``. Given
corresponding point sets P, Q find the rigid transform T with Q ≈ R P + t.

Three interchangeable backends:

- :func:`kabsch` — classic SVD of the 3x3 cross-covariance with the
  determinant-sign reflection fix (Arun 1987 / Kabsch).
- :func:`umeyama` — Umeyama 1991 similarity variant, optionally estimating a
  global scale; with ``with_scale=False`` it equals Kabsch.
- :func:`horn_quaternion` — Horn 1987 quaternion form: the optimal rotation is
  the top eigenvector of a symmetric 4x4 built from the cross-covariance,
  extracted with a fixed-iteration block power method — elementwise
  arithmetic only, no SVD/eigh. It is what the RANSAC engine uses for its
  hypotheses (through :func:`horn_from_moments`) and for its refit.

All solvers accept optional per-point weights (used for hard inlier masks in
RANSAC refits), operate on ``(..., N, 3)`` tensors and never branch on
tensor values in Python, so none of them synchronises with the device.

The Horn path keeps the component-wise (structure-of-arrays) arithmetic of
the JAX package line for line. That is what makes parity with it to 1e-5
possible; in eager PyTorch each of those lines is one small launch on the
card (a few hundred per solve). The RANSAC engine's two Horn solves do not
run it on CUDA tensors: :func:`horn_from_moments` launches one kernel
(``ops/horn.py``) that runs the same arithmetic one hypothesis a thread,
and the engine's refit launches its twin. :func:`horn_quaternion` and
:func:`horn_rotation_directions` (P3P, the point+normal solver) stay eager.
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.core.lie import rt_to_matrix
from rgbd_pose_estimation_tpu_torch.ops import horn as horn_kernels


def _weighted_stats(p, q, weights):
    """Shared preamble: weighted centroids and 3x3 cross-covariance H."""
    if weights is None:
        weights = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    cp = torch.sum(p * w, dim=-2) / wsum
    cq = torch.sum(q * w, dim=-2) / wsum
    pc = p - cp[..., None, :]
    qc = q - cq[..., None, :]
    # H = sum_i w_i * pc_i qc_i^T  — a (..., 3, 3) batched matmul.
    H = torch.einsum("...ni,...nj->...ij", pc * w, qc)
    return cp, cq, pc, qc, H, weights, wsum[..., 0]


def _svd_rotation(H):
    """R = V diag(1, 1, det(V Uᵀ)) Uᵀ from the SVD of H; also returns the
    singular values and the determinant sign."""
    U, S, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    d = torch.linalg.det(V @ Ut)
    D = torch.zeros_like(H)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = d
    return V @ D @ Ut, S, d


def kabsch(p: torch.Tensor, q: torch.Tensor, weights=None) -> torch.Tensor:
    """Rigid transform T (``(..., 4, 4)``) minimizing Σ w_i ||R p_i + t − q_i||².

    SVD-based with the det-sign fix: R = V diag(1, 1, det(V Uᵀ)) Uᵀ, which
    guards against reflections on degenerate/noisy minimal sets.
    """
    cp, cq, _, _, H, _, _ = _weighted_stats(p, q, weights)
    R, _, _ = _svd_rotation(H)
    t = cq - torch.einsum("...ij,...j->...i", R, cp)
    return rt_to_matrix(R, t)


def umeyama(p: torch.Tensor, q: torch.Tensor, weights=None, with_scale=False):
    """Umeyama 1991: similarity transform (R, t, s) with optional scale.

    Returns ``(T, s)`` where T is the rigid part ``(..., 4, 4)`` built with
    scaled translation so that ``q ≈ s · R p + t``. With ``with_scale=False``
    s is identically 1 and the result equals :func:`kabsch`.
    """
    cp, cq, pc, _, H, weights, wsum = _weighted_stats(p, q, weights)
    R, S, d = _svd_rotation(H)
    if with_scale:
        var_p = torch.sum(weights * torch.sum(pc * pc, dim=-1), dim=-1)
        # trace(D S) with the reflection-corrected sign on the smallest sv.
        trDS = S[..., 0] + S[..., 1] + d * S[..., 2]
        s = trDS / torch.clamp(var_p, min=1e-12)
    else:
        s = torch.ones(H.shape[:-2], dtype=p.dtype, device=p.device)
    t = cq - s[..., None] * torch.einsum("...ij,...j->...i", R, cp)
    return rt_to_matrix(R, t), s


def horn_quaternion(
    p: torch.Tensor, q: torch.Tensor, weights=None, iters: int = 12
) -> torch.Tensor:
    """Batched absolute orientation (Horn 1987), structure-of-arrays form.

    The optimal rotation quaternion is the eigenvector of the symmetric 4x4
    N matrix with the largest eigenvalue, extracted by a shifted/squared
    power method — no SVD, no eigh, no host branching. All per-problem
    algebra is spelled out on COMPONENT tensors of shape ``batch`` (see the
    module docstring). ``iters=12`` after 3 squarings recovers the rotation
    to f32 precision on non-degenerate sets.
    """
    if weights is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    else:
        w = weights
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]  # (..., N)
    qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]

    def wmean(x):
        return torch.sum(w * x, dim=-1) / wsum

    cpx, cpy, cpz = wmean(px), wmean(py), wmean(pz)
    cqx, cqy, cqz = wmean(qx), wmean(qy), wmean(qz)
    pcx = px - cpx[..., None]
    pcy = py - cpy[..., None]
    pcz = pz - cpz[..., None]
    qcx = qx - cqx[..., None]
    qcy = qy - cqy[..., None]
    qcz = qz - cqz[..., None]

    def hsum(a, b):
        return torch.sum(w * a * b, dim=-1)

    sxx, sxy, sxz = hsum(pcx, qcx), hsum(pcx, qcy), hsum(pcx, qcz)
    syx, syy, syz = hsum(pcy, qcx), hsum(pcy, qcy), hsum(pcy, qcz)
    szx, szy, szz = hsum(pcz, qcx), hsum(pcz, qcy), hsum(pcz, qcz)

    return _horn_from_components(
        (cpx, cpy, cpz),
        (cqx, cqy, cqz),
        (sxx, sxy, sxz, syx, syy, syz, szx, szy, szz),
        iters,
    )


def horn_rotation_directions(
    vp: torch.Tensor, vq: torch.Tensor, weights=None, iters: int = 12
) -> torch.Tensor:
    """Best rotation aligning direction sets: vq_i ≈ R vp_i, NO centroiding.

    The SVD-free path for Wahba's problem: identical Horn N-matrix eigen
    machinery as :func:`horn_quaternion`, fed the raw (uncentered)
    direction correlation Σ w vp_a vq_b. Returns ``(..., 3, 3)`` proper
    rotations.
    """
    if weights is None:
        w = torch.ones(vp.shape[:-1], dtype=vp.dtype, device=vp.device)
    else:
        w = weights
    px, py, pz = vp[..., 0], vp[..., 1], vp[..., 2]
    qx, qy, qz = vq[..., 0], vq[..., 1], vq[..., 2]

    def hsum(a, b):
        return torch.sum(w * a * b, dim=-1)

    cov = (
        hsum(px, qx), hsum(px, qy), hsum(px, qz),
        hsum(py, qx), hsum(py, qy), hsum(py, qz),
        hsum(pz, qx), hsum(pz, qy), hsum(pz, qz),
    )
    zero = torch.zeros_like(cov[0])
    T = _horn_from_components((zero, zero, zero), (zero, zero, zero), cov, iters)
    return T[..., :3, :3]


def horn_from_moments(mom: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Horn solve directly from per-sample moment sums (no point arrays).

    ``mom`` is the ``(16, K)`` output of ``ops.moments.minimal_moments``:
    rows 0-2 Σp, 3-5 Σq, 6-14 Σ p qᵀ (row-major), 15 the count. The
    centered cross-covariance follows from the moments alone:

        H_ab = Σ p_a q_b − (Σ p_a)(Σ q_b) / n

    which feeds the same component-of-arrays eigen path as
    :func:`horn_quaternion`. This is the RANSAC engine's hypothesis path.

    For a CUDA tensor it is one launch of ``horn_hypotheses_kernel``
    (``ops/horn.py``, one hypothesis a thread); for a CPU tensor the plain
    version, :func:`horn_from_moments_reference`, runs.
    """
    if mom.is_cuda:
        return horn_kernels.horn_hypotheses(mom, iters)
    return horn_from_moments_reference(mom, iters)


def horn_from_moments_reference(mom: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Plain PyTorch version of :func:`horn_from_moments`: the same
    arithmetic, component-wise, on any device."""
    n = torch.clamp(mom[15], min=1e-12)
    inv = 1.0 / n
    cpx, cpy, cpz = mom[0] * inv, mom[1] * inv, mom[2] * inv
    cqx, cqy, cqz = mom[3] * inv, mom[4] * inv, mom[5] * inv
    sxx = mom[6] - mom[0] * mom[3] * inv
    sxy = mom[7] - mom[0] * mom[4] * inv
    sxz = mom[8] - mom[0] * mom[5] * inv
    syx = mom[9] - mom[1] * mom[3] * inv
    syy = mom[10] - mom[1] * mom[4] * inv
    syz = mom[11] - mom[1] * mom[5] * inv
    szx = mom[12] - mom[2] * mom[3] * inv
    szy = mom[13] - mom[2] * mom[4] * inv
    szz = mom[14] - mom[2] * mom[5] * inv
    return _horn_from_components(
        (cpx, cpy, cpz),
        (cqx, cqy, cqz),
        (sxx, sxy, sxz, syx, syy, syz, szx, szy, szz),
        iters,
    )


def _horn_from_components(cp, cq, cov, iters: int):
    """Shared Horn eigen path from centroids + centered covariance
    components (all ``batch``-shaped SoA tensors)."""
    cpx, cpy, cpz = cp
    cqx, cqy, cqz = cq
    sxx, sxy, sxz, syx, syy, syz, szx, szy, szz = cov

    # Horn's symmetric 4x4 N matrix, 10 unique components.
    a00 = sxx + syy + szz
    a01 = syz - szy
    a02 = szx - sxz
    a03 = sxy - syx
    a11 = sxx - syy - szz
    a12 = sxy + syx
    a13 = szx + sxz
    a22 = -sxx + syy - szz
    a23 = syz + szy
    a33 = -sxx - syy + szz

    def frob(m):
        a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = m
        s = (
            a00 * a00 + a11 * a11 + a22 * a22 + a33 * a33
            + 2.0 * (a01 * a01 + a02 * a02 + a03 * a03
                     + a12 * a12 + a13 * a13 + a23 * a23)
        )
        return torch.sqrt(s)

    # Scale-normalize the N matrix first: the optimal quaternion is invariant
    # to positive scaling of H, and unnormalized entries grow like coord², so
    # the squaring cascade below would overflow f32 (inf * 0 → NaN) for
    # points beyond ~1e2 — e.g. the RANSAC engine's far-away pad sentinels.
    nf = 1.0 / (frob((a00, a01, a02, a03, a11, a12, a13, a22, a23, a33)) + 1e-30)
    a00, a01, a02, a03 = a00 * nf, a01 * nf, a02 * nf, a03 * nf
    a11, a12, a13 = a11 * nf, a12 * nf, a13 * nf
    a22, a23, a33 = a22 * nf, a23 * nf, a33 * nf

    # Shift by the Frobenius norm (=1 now) so the largest eigenvalue dominates
    # in magnitude, then square 3 times (each squaring doubles eigen-contrast).
    sh = torch.ones_like(a00)
    a00, a11, a22, a33 = a00 + sh, a11 + sh, a22 + sh, a33 + sh

    def sym_square(m):
        a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = m
        b00 = a00 * a00 + a01 * a01 + a02 * a02 + a03 * a03
        b01 = a00 * a01 + a01 * a11 + a02 * a12 + a03 * a13
        b02 = a00 * a02 + a01 * a12 + a02 * a22 + a03 * a23
        b03 = a00 * a03 + a01 * a13 + a02 * a23 + a03 * a33
        b11 = a01 * a01 + a11 * a11 + a12 * a12 + a13 * a13
        b12 = a01 * a02 + a11 * a12 + a12 * a22 + a13 * a23
        b13 = a01 * a03 + a11 * a13 + a12 * a23 + a13 * a33
        b22 = a02 * a02 + a12 * a12 + a22 * a22 + a23 * a23
        b23 = a02 * a03 + a12 * a13 + a22 * a23 + a23 * a33
        b33 = a03 * a03 + a13 * a13 + a23 * a23 + a33 * a33
        return (b00, b01, b02, b03, b11, b12, b13, b22, b23, b33)

    m = (a00, a01, a02, a03, a11, a12, a13, a22, a23, a33)
    for _ in range(3):
        m = sym_square(m)
        inv = 1.0 / torch.clamp(frob(m), min=1e-20)
        m = tuple(x * inv for x in m)
    a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = m

    # BLOCK power iteration (orthonormal 2-vector subspace) + closed-form
    # 2x2 Rayleigh-Ritz. A single-vector power method fails on NEAR-COLLINEAR
    # minimal sets: 3 centered points are rank<=2 so N's eigenvalues come as
    # +/-(s1+s2), +/-(s1-s2); when s2/s1 is small the shifted contrast
    # (l2+1)/(l1+1) approaches 1 and the top two eigenvectors stay mixed.
    # The 2D dominant SUBSPACE, however, converges at contrast
    # (l3+1)/(l1+1) — nearly instant after the squarings — and the v1-vs-v2
    # split inside it is then solved EXACTLY by the 2x2 symmetric
    # eigenproblem (stable atan2 form), so no amount of eigen-gap collapse
    # between l1 and l2 hurts.
    def matvec(v0, v1, v2, v3):
        u0 = a00 * v0 + a01 * v1 + a02 * v2 + a03 * v3
        u1 = a01 * v0 + a11 * v1 + a12 * v2 + a13 * v3
        u2 = a02 * v0 + a12 * v1 + a22 * v2 + a23 * v3
        u3 = a03 * v0 + a13 * v1 + a23 * v2 + a33 * v3
        return u0, u1, u2, u3

    def normalize(v0, v1, v2, v3):
        inv = torch.rsqrt(
            torch.clamp(v0 * v0 + v1 * v1 + v2 * v2 + v3 * v3, min=1e-40)
        )
        return v0 * inv, v1 * inv, v2 * inv, v3 * inv

    one = torch.ones_like(a00)
    va = normalize(one, 0.1 * one, 0.2 * one, 0.3 * one)
    vb = normalize(0.2 * one, -0.7 * one, 0.6 * one, -0.4 * one)
    for _ in range(iters):
        va = normalize(*matvec(*va))
        ub = matvec(*vb)
        # Gram-Schmidt: keep vb orthogonal to va so the pair spans the
        # dominant 2D subspace instead of both collapsing onto v1.
        dot = sum(a * b for a, b in zip(va, ub))
        vb = normalize(*[b - dot * a for a, b in zip(va, ub)])

    # Rayleigh-Ritz: project m onto span{va, vb} -> [[ra, rb], [rb, rc]].
    ua = matvec(*va)
    ub = matvec(*vb)
    ra = sum(a * u for a, u in zip(va, ua))
    rb = sum(b * u for b, u in zip(vb, ua))
    rc = sum(b * u for b, u in zip(vb, ub))
    # Top eigenvector of the 2x2 via the half-angle form: direction
    # (cos t, sin t) with 2t = atan2(2b, a-c) picks the larger eigenvalue
    # branch; exact up to f32 roundoff of the projected entries.
    t = 0.5 * torch.atan2(2.0 * rb, ra - rc)
    ct, st = torch.cos(t), torch.sin(t)
    v0, v1, v2, v3 = (ct * a + st * b for a, b in zip(va, vb))

    # Rotation matrix from the (w, x, y, z) quaternion, componentwise.
    ww, xx, yy, zz = v0 * v0, v1 * v1, v2 * v2, v3 * v3
    wx, wy, wz = v0 * v1, v0 * v2, v0 * v3
    xy, xz, yz = v1 * v2, v1 * v3, v2 * v3
    r00 = ww + xx - yy - zz
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = ww - xx + yy - zz
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = ww - xx - yy + zz

    tx = cqx - (r00 * cpx + r01 * cpy + r02 * cpz)
    ty = cqy - (r10 * cpx + r11 * cpy + r12 * cpz)
    tz = cqz - (r20 * cpx + r21 * cpy + r22 * cpz)

    # One relayout at the very end: components → (..., 4, 4).
    zero = torch.zeros_like(tx)
    rows = [
        torch.stack([r00, r01, r02, tx], dim=-1),
        torch.stack([r10, r11, r12, ty], dim=-1),
        torch.stack([r20, r21, r22, tz], dim=-1),
        torch.stack([zero, zero, zero, torch.ones_like(tx)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)
