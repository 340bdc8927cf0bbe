"""k1_moments_roofline: K1's share of its roofline, in %.

Kernel: ``minimal_moments_kernel`` (``ops/csrc/moments.cu``, launched by
``ops/moments.py::minimal_moments``). Σ bound time ÷ Σ device time of its
launches in the traced sub-window; bound by its bytes at the HBM peak.
"""

from benchmark.harness.readers import roofline_pct

KERNEL = "minimal_moments_kernel"


def bytes_per_call(K: int, m: int, N: int) -> int:
    """The (K, m) int32 indices read, the (16, K) f32 moments written, and
    the N rows of p and q (3 floats each) that the gathers touch, once."""
    return 4 * (m * K + 16 * K) + 24 * N


def ops_per_call(K: int, m: int) -> int:
    """f32 operations: per sampled correspondence 3 + 3 sums and 9 products
    with their 9 sums."""
    return 24 * m * K


def read(ctx):
    c, pk = ctx["counts"], ctx["peaks"]
    bound = max(bytes_per_call(c["K"], c["sample_size"], c["N"]) / pk["hbm_bytes_per_s"],
                ops_per_call(c["K"], c["sample_size"]) / pk["f32_flops_per_s"])
    return roofline_pct(ctx, KERNEL, bound)
