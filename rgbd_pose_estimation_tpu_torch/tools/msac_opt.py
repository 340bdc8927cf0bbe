"""MSAC scorer variants on the card: what each form of the function costs.

Counterpart of the JAX repository's ``tools/msac_opt.py``. It prints:

- two ceilings of the CUDA cores: the f32 multiply-add chain (T6,
  ``roofline.ceiling_vpu``) and the exact scorer's op mix on
  register-resident values with no memory traffic and no reduction (T4,
  :func:`variant_E_ceiling`), both at the reference's accounting;
- the parity of the quad-form variants C (T2), M (T3), X and X-highest
  against the exact plain scorer, on orthonormal poses from ``se3_exp``
  (the quad form assumes |R p| = |p|; other poses make C and M differ from
  A by design);
- the timing table at K = 4096 and 32768 poses × N = 2048 correspondences:
  A (T1) at every poses-per-thread, C, D (T5), M, X and X-highest, in µs, in
  TFLOP/s at the exact scorer's accounting of 23·K·N flops, and as a share
  of the measured multiply-add ceiling.

Each time is a graph-chained slope (``roofline.timeit_chain``) of the
kernel on its prebuilt input, fed back through ``x + 1e-30·msac``: packed
(K, 12) poses for A and D, the (K, 17) quad features for C, M and X (built
once, outside the chain: in the reference XLA fuses their build into the
program, here it would be a dozen eager kernels a call). That small
elementwise pass orders the calls and is part of every row, as in the
reference. A row that fails prints FAILED with the reason, and the table
goes on.

Run on a machine with one CUDA card:

    python -m rgbd_pose_estimation_tpu_torch.tools.msac_opt
"""

from __future__ import annotations

import functools

import torch

from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.ops import ceilings
from rgbd_pose_estimation_tpu_torch.ops.msac_variants import (
    K3_POSES_PER_THREAD,
    POSES_PER_THREAD,
    quad_C,
    quad_M,
    quad_X,
    variant_A,
    variant_C,
    variant_D,
    variant_M,
    variant_X,
)
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import (
    _quad_features,
    pack_poses,
    score_poses_3d3d_reference,
)
from rgbd_pose_estimation_tpu_torch.tools.roofline import (
    ceiling_vpu,
    device_line,
    require_cuda,
    timeit_chain,
)

TAU = 0.05
N_POINTS = 2048


def variant_E_ceiling(N: int = 2048, reps: int = 64) -> float:
    """TFLOP/s of T4, the exact scorer's op mix on an (8, N) array for
    ``reps`` iterations, at 23 flops an element and iteration."""
    x = torch.ones((8, N), device="cuda")
    s = timeit_chain(functools.partial(ceilings.msac_op_mix, reps=reps), x)
    return ceilings.OP_MIX_FLOPS * reps * 8 * N / s / 1e12


def problem(K: int, N: int = N_POINTS, seed: int = 0):
    """Orthonormal poses ``se3_exp(0.3·randn(K, 6))`` and standard normal
    p, q (N, 3), made on the card from ``seed``."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    T = se3_exp(0.3 * torch.randn((K, 6), generator=g, device="cuda"))
    p = torch.randn((N, 3), generator=g, device="cuda")
    q = torch.randn((N, 3), generator=g, device="cuda")
    return T, p, q


def _chunked_reference(T, p, q, tau, chunk=4096):
    parts = [score_poses_3d3d_reference(T[i : i + chunk], p, q, tau) for i in range(0, T.shape[0], chunk)]
    return torch.cat([m for m, _ in parts]), torch.cat([c for _, c in parts])


QUAD_VARIANTS = {
    "C": variant_C,
    "M": variant_M,
    "X": variant_X,
    "X-highest": functools.partial(variant_X, precision="highest"),
}


def parity(T, p, q, tau: float = TAU) -> dict:
    """name → (max relative msac error, max count difference) of each quad
    variant against the exact plain scorer."""
    m_ref, c_ref = _chunked_reference(T, p, q, tau)
    out = {}
    for name, fn in QUAD_VARIANTS.items():
        m, c = fn(T, p, q, tau)
        ok = ~torch.isnan(m_ref)
        rel = torch.abs(m - m_ref)[ok] / (m_ref[ok] + 1e-9)
        out[name] = (float(rel.max()), float(torch.abs(c - c_ref)[ok].max()))
    return out


def timing_rows(T, p, q, tau: float = TAU):
    """(row name, step, first input) of the timing table: each step maps
    its input (packed poses, or quad features) to a tensor of its shape."""
    poses = pack_poses(T)
    feat, pn = _quad_features(T, p, q)

    def on_poses(fn, **kw):
        def step(P):
            out = fn(P, p, q, tau, **kw)
            m = out[0] if isinstance(out, tuple) else out
            return P + 1e-30 * m[:, None]

        return step, poses

    def on_features(fn, **kw):
        def step(f):
            return f + 1e-30 * fn(f, pn, tau, **kw)[0][:, None]

        return step, feat

    rows = [(f"A poses/thread={P}" + (" (K3's large-K choice)" if P == K3_POSES_PER_THREAD else ""),
             *on_poses(variant_A, poses_per_thread=P)) for P in POSES_PER_THREAD]
    rows += [
        ("C quad f32, CUDA cores", *on_features(quad_C)),
        (f"D no count, poses/thread={K3_POSES_PER_THREAD}", *on_poses(variant_D)),
        ("M quad 3xTF32, tensor cores", *on_features(quad_M)),
        ("X library bf16 torch.matmul", *on_features(quad_X)),
        ("X-highest library f32 torch.matmul, TF32 off", *on_features(quad_X, precision="highest")),
    ]
    return rows


def time_table(K: int, N: int = N_POINTS, tau: float = TAU, **timing):
    """name → seconds a call (None where the row failed) at K × N."""
    T, p, q = problem(K, N)
    out = {}
    for name, step, x0 in timing_rows(T, p, q, tau):
        try:
            out[name] = timeit_chain(step, x0, **timing)
        except Exception as ex:  # noqa: BLE001 - the table says which row failed and why
            print(f"| {name} | FAILED {type(ex).__name__}: {str(ex)[:300]} |", flush=True)
            out[name] = None
    return out


def main():
    require_cuda()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {device_line()} | "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    vpu = ceiling_vpu()
    print(f"f32 FMA ceiling (T6): {vpu:.2f} TFLOP/s", flush=True)
    opceil = variant_E_ceiling()
    print(f"Op-issue ceiling of the A op mix (T4; 23-flop accounting, register-resident, no "
          f"reduction): {opceil:.2f} TFLOP/s = {opceil / vpu * 100:.0f}% of the FMA ceiling", flush=True)

    for K in (4096, 32768):
        T, p, q = problem(K)
        for name, (rel, cnt) in parity(T, p, q).items():
            print(f"{name} parity K={K}: msac max rel {rel:.2e}, count max diff {cnt:.0f}", flush=True)
        flops = 23 * K * N_POINTS
        print(f"\nK={K} N={N_POINTS}")
        print("| variant | time | TFLOP/s (23·K·N) | % FMA ceiling |")
        print("|---|---|---|---|")
        for name, s in time_table(K).items():
            if s is not None:
                tf = flops / s / 1e12
                print(f"| {name} | {s * 1e6:.1f} us | {tf:.2f} | {tf / vpu * 100:.0f}% |", flush=True)
        print()


if __name__ == "__main__":
    main()
