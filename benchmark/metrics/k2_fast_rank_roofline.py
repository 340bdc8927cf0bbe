"""k2_fast_rank_roofline: K2's share of its roofline, in %.

Kernel: ``quad_bf16_mma_kernel`` (``ops/csrc/quad_bf16_mma.cu``, launched by
``ops/ransac_score.py::best_pose_3d3d``). Σ bound time ÷ Σ device time of its
launches in the traced sub-window. Bound by its operations: the
(K, 17) x (17, N) product at the bf16 tensor-core peak, plus its epilogue
(clip, clip, add: 3 f32 operations an entry) at the f32 peak. N is the
correspondences padded to a multiple of 128, as the estimator scores them.
"""

from benchmark.harness.readers import roofline_pct

KERNEL = "quad_bf16_mma_kernel"
TERMS = 17  # terms of the bilinear form of a squared residual


def seconds_of_ops(K: int, N: int, peaks: dict) -> float:
    return 2 * TERMS * K * N / peaks["bf16_flops_per_s"] + 3 * K * N / peaks["f32_flops_per_s"]


def bytes_per_call(K: int, N: int) -> int:
    """The (K, 17) features and (17, N) columns read, the K sums written."""
    return 4 * (TERMS * K + TERMS * N + K)


def read(ctx):
    c, pk = ctx["counts"], ctx["peaks"]
    K, N = c["K"], c["N_padded"]
    bound = max(seconds_of_ops(K, N, pk), bytes_per_call(K, N) / pk["hbm_bytes_per_s"])
    return roofline_pct(ctx, KERNEL, bound)
