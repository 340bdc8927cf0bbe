"""icp_fused_step_roofline: the fused ICP step's share of its roofline, in %.

Kernel: ``icp_assoc_kernel`` (``ops/csrc/icp_jtj.cu``, launched by
``ops/icp_jtj.py::icp_assoc_jtj_jtr``). Σ bound time ÷ Σ device time of its
launches in the traced sub-window. The step is bound by its bytes: each
byte it needs read once and each output written once, at the HBM peak. Its
operations (about 150 a sample) take under a tenth of that time at the f32
peak and are not counted.
"""

from benchmark.harness.readers import roofline_pct

KERNEL = "icp_assoc_kernel"


def bytes_per_call(samples: int, valid_samples: float) -> float:
    """A source sample's vertex and normal (24 B) and its association map
    entry, written when fresh and read when carried (4 B); the target's
    vertex and normal gathered for each sample with a valid depth (24 B);
    the pose T (12 floats read) and the 8x8 sums written."""
    return 28 * samples + 24 * valid_samples + 4 * 12 + 4 * 64


def read(ctx):
    levels = ctx["counts"]["fused_step_levels"]
    track = sum(lv["calls"] * bytes_per_call(lv["samples"], lv["valid_samples"]) for lv in levels)
    calls = sum(lv["calls"] for lv in levels)
    return roofline_pct(ctx, KERNEL, track / calls / ctx["peaks"]["hbm_bytes_per_s"])
