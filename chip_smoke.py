"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; takes no arguments and no network. It
builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at the shapes of the main paths,
drives the main paths through the entry points a user calls, and shows
through the launch counters that each path went through its kernels:

- the 3D-3D RANSAC frame-pair estimator at the bench size, K = 32768
  hypotheses x N = 2048 correspondences (phases ``estimate``, ``adaptive``);
- dense projective ICP at 640x480, three levels, at the dense and the
  config-3 settings (``icp_track``), and the dense odometry server
  ``DenseOdometry`` over a rendered sequence, synchronous and pipelined
  (``odometry``).

Every phase prints one JSON line; any failed check raises, so the exit code
is non-zero and the last line is missing.

Last lines of a good run: the card's name and power limit as ``nvidia-smi``
gives them, one ``{"kernels": [...]}`` line (per kernel: launches on the main
path, error against the plain version, time, plain version's time, the
card's bound for the same work, the library call's time where one exists),
and ``{"ok": true, "device": {...}}``.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

_ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(_ROOT))

import numpy as np

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.data.synthetic import (
    synthetic_correspondences,
    synthetic_depth_scene,
    synthetic_sequence,
)
from rgbd_pose_estimation_tpu_torch.icp.dense import (
    icp_track,
    level_step,
    make_icp_frame,
)
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops import ransac_score as rs
from rgbd_pose_estimation_tpu_torch.ops.icp_jtj import (
    icp_jtj_jtr,
    icp_jtj_jtr_reference,
)
from rgbd_pose_estimation_tpu_torch.ops.moments import (
    minimal_moments,
    minimal_moments_reference,
)
from rgbd_pose_estimation_tpu_torch.ransac.engine import (
    _estimate_from_samples,
    estimate_pose_3d3d,
    estimate_pose_3d3d_adaptive,
    pad_correspondences_3d3d,
)
from rgbd_pose_estimation_tpu_torch.ransac.prosac import sample_minimal_sets
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import (
    horn_from_moments,
    horn_quaternion,
)
from rgbd_pose_estimation_tpu_torch.utils.config import (
    IcpConfig,
    KeyframeConfig,
    RansacConfig,
    load_yaml_config,
)

DEV = "cuda"

# The bench problem (bench.py of the JAX package): the metric of record is
# RANSAC hypotheses per second at this size.
K, N, M, TAU = 32768, 2048, 3, 0.05
CFG = RansacConfig(num_hypotheses=K, threshold=TAU, refit_rounds=2, solver="horn")
POSE_TOL = 0.05  # max |pose - ground truth|, the bench's accuracy gate

# The dense-ICP rows of the bench: one 640x480 frame pair of the analytic
# scene, three levels, at the dense setting and at config 3's. K4 launches a
# track: one per Gauss-Newton iteration.
CAM = CameraIntrinsics(525.0, 525.0, 319.5, 239.5, 640, 480)
XI_GT = [0.01, -0.008, 0.005, 0.01, -0.012, 0.008]
ICP_DENSE = IcpConfig(downscale=1, source_stride=(1, 1, 1), reassoc_every=1,
                      iters_per_level=(5, 7, 10))
ICP_CONFIG3 = IcpConfig(downscale=1, source_stride=(4, 4, 2), reassoc_every=2,
                        iters_per_level=(3, 4, 6))
K4_LAUNCHES = {"dense": 22, "config3": 13}

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def generator(seed):
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    return g


def time_ms(fn, reps=20, inner=5, warmup=3):
    """Median over ``reps`` of the time of one call, from CUDA events around
    ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def chunked(fn, T, chunk=4096):
    """A plain version that builds a (K, N, ...) tensor, applied over K in
    chunks so that it fits beside the other phases."""
    outs = [fn(T[i : i + chunk]) for i in range(0, T.shape[0], chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def max_abs_err(out, ref):
    """Max |out - ref| where ref is not NaN; NaN must sit at the same places."""
    nan_ref = torch.isnan(ref)
    if not torch.equal(torch.isnan(out), nan_ref):
        raise AssertionError("NaN does not propagate as in the plain version")
    return float((out.double() - ref.double())[~nan_ref].abs().max())


def assert_close(out, ref, rtol, atol, what):
    ok = ~torch.isnan(ref)
    o, r = out.double()[ok], ref.double()[ok]
    bad = (o - r).abs() > atol + rtol * r.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol={rtol} atol={atol}; max abs err {float((o - r).abs().max())}"
        )


# ---------------------------------------------------------------------------
# Each kernel against its plain version
# ---------------------------------------------------------------------------


def check_moments(idx, p, q):
    """K1. rtol 1e-6 / atol 1e-6: m = 3 addends; kernel and plain version
    round the products and add in the same order, so 0 is expected."""
    out = minimal_moments(idx, p, q)
    ref = minimal_moments_reference(idx, p, q)
    torch.cuda.synchronize()
    assert_close(out, ref, 1e-6, 1e-6, "minimal_moments")
    return max_abs_err(out, ref)


def quad_scores_f64(feat, pn):
    """K2's function in float64 from the same bf16-rounded operands."""
    fb, pb = feat.bfloat16().double(), pn.bfloat16().double()
    return chunked(lambda f: torch.clamp(f @ pb, 0.0, TAU * TAU).sum(1), fb, 8192)


def check_quad(T, p, q):
    """K2 against float64, rtol 1e-3. The 17 terms of an entry are of order
    |p|² ~ 10-50 and cancel to residuals near τ² = 2.5e-3, and the kernel
    sums them in another order than any matrix product does: an f32 plain
    version is no more right than the kernel, so both are held to the f64
    value of the same rounded operands. Entries err by ~1e-6 absolute, up
    to ~1e-3 of a small entry; the (K,) sums of N clipped entries much less."""
    feat, pn = rs._quad_features(T, p, q)
    out = rs._quad_scores(feat, pn, TAU)
    ref = quad_scores_f64(feat, pn)
    plain = rs._quad_scores_reference(feat, pn, TAU)
    torch.cuda.synchronize()
    assert_close(out, ref, 1e-3, 0.0, "score_poses_3d3d_quad_fused vs f64")
    assert_close(plain, ref, 1e-3, 0.0, "score_poses_3d3d_quad (plain) vs f64")
    return max_abs_err(out, ref)


def check_exact(T, p, q):
    """K3. Scores rtol 1e-5 (N f32 terms summed in another order). Counts
    are equal except where a residual sits within f32 rounding of τ²: a
    difference of at most 1, on at most 0.1% of the poses."""
    m_out, c_out = rs.score_poses_3d3d(T, p, q, TAU)
    m_ref, c_ref = chunked(lambda t: rs.score_poses_3d3d_reference(t, p, q, TAU), T)
    torch.cuda.synchronize()
    assert_close(m_out, m_ref, 1e-5, 0.0, "score_poses_3d3d msac")
    diff = (c_out - c_ref).abs()
    if float(diff.max()) > 1 or float((diff > 0).float().mean()) > 1e-3:
        raise AssertionError(
            f"score_poses_3d3d counts: max diff {float(diff.max())}, "
            f"{int((diff > 0).sum())} of {diff.numel()} poses differ"
        )
    if bool(torch.isnan(c_out).any()):
        raise AssertionError("score_poses_3d3d: a count is NaN")
    return max_abs_err(m_out, m_ref)


def icp_scene(cfg, cam=CAM, intensity=False):
    """The bench's frame pair as pyramids: source (camera at T_gt), target
    (camera at identity), and T_gt. The track's answer is inv(T_gt)."""
    T_gt = se3_exp(torch.tensor(XI_GT, device=DEV))
    da, ia = synthetic_depth_scene(cam, torch.eye(4, device=DEV))
    db, ib = synthetic_depth_scene(cam, T_gt)
    fa = make_icp_frame(cam, da, cfg, ia if intensity else None)
    fb = make_icp_frame(cam, db, cfg, ib if intensity else None)
    return fb, fa, T_gt


def flat8(res):
    """(JtJ, Jtr, err, wsum) → the 44 numbers in one vector."""
    JtJ, Jtr, err, wsum = res
    return torch.cat([JtJ.reshape(-1), Jtr, err.reshape(1), wsum.reshape(1)])


def jtj_f64(p, q, n, w):
    """K4's function in float64 from the same f32 inputs, and beside every
    entry the sum of its terms' absolute values: the scale of what f32
    rounding can do to that entry."""
    p, q, n, w = (x.double() for x in (p, q, n, w))
    r = torch.sum(n * (p - q), dim=-1, keepdim=True)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1), r, torch.ones_like(r)], dim=-1)
    Jw = J * w[:, None]
    A, S = Jw.T @ J, Jw.abs().T @ J.abs()
    return (flat8((X[:6, :6], X[:6, 6], X[6, 6], X[7, 7])) for X in (A, S))


def assert_within(out, ref, bound, what):
    ok = ~torch.isnan(ref)
    if not torch.equal(torch.isnan(out), ~ok):
        raise AssertionError(f"{what}: NaN does not sit where float64 has it")
    over = (out.double() - ref)[ok].abs() - bound[ok]
    if bool((over > 0).any()):
        raise AssertionError(f"{what}: {int((over > 0).sum())} entries beyond their bound, "
                             f"worst by {float(over.max())}")


def check_icp_jtj(p, q, n, w):
    """K4 against float64 and against its plain version. Every entry is a sum
    of M products; kernel and plain version add them in different orders, so
    each is held to float64 of the same inputs within 1e-4 of the sum of the
    entry's absolute terms (f32 rounding, ~6e-8 a step, over a tree of
    additions and the residual's own cancellation n·(p−q)), and the two to
    each other within twice that. Run twice, the kernel must give the same
    bits. Returns max |kernel − plain| and the kernel's largest share of its
    bound's scale."""
    out, again = flat8(icp_jtj_jtr(p, q, n, w)), flat8(icp_jtj_jtr(p, q, n, w))
    plain = flat8(icp_jtj_jtr_reference(p, q, n, w))
    ref, scale = jtj_f64(p, q, n, w)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("icp_jtj_jtr: two runs on the same input differ")
    bound = 1e-4 * scale + 1e-30
    assert_within(out, ref, bound, f"icp_jtj_jtr vs f64, M={p.shape[0]}")
    assert_within(plain, ref, bound, f"icp_jtj_jtr (plain) vs f64, M={p.shape[0]}")
    assert_within(out, plain.double(), 2 * bound, f"icp_jtj_jtr vs plain, M={p.shape[0]}")
    ok = ~torch.isnan(ref)
    share = float(((out.double() - ref)[ok].abs() / (scale[ok] + 1e-30)).max())
    return {"max_abs_err_vs_plain": max_abs_err(out, plain), "max_err_vs_f64_over_abs_sum": share}


def kernel_icp_jtj():
    """K4 at every size a 640x480 track gives it, on the rows of real
    association steps (started from identity, so residuals are those of a
    first iteration), then ragged sizes, zero weights and a NaN row.
    Returns (checks, the record of the main path's largest shape)."""
    checks, rows_by_name = [], {}
    eye = torch.eye(4, device=DEV)
    photo_cfg = IcpConfig(downscale=1, source_stride=(4, 4, 2), reassoc_every=2,
                          iters_per_level=(3, 4, 6), photometric_weight=0.5)
    for cfg, name, intensity in ((ICP_DENSE, "dense", False), (ICP_CONFIG3, "config3", False),
                                 (photo_cfg, "config3+photometric", True)):
        src, tgt, _ = icp_scene(cfg, intensity=intensity)
        for level in (range(3) if not intensity else (0,)):
            rows = level_step(CAM, cfg, src, tgt, level)[1](eye)[0]
            rows_by_name[f"{name} level {level}"] = rows
            checks.append({"rows": f"{name} level {level}", "M": rows[0].shape[0],
                           "weight_sum": float(rows[3].sum()),
                           **check_icp_jtj(*rows)})
    sizes = sorted({c["M"] for c in checks})
    if sizes != [4800, 19200, 38400, 76800, 307200]:
        raise AssertionError(f"unexpected K4 sizes {sizes}")

    p, q, n, w = rows_by_name["dense level 0"]
    first = int(torch.nonzero(w > 0)[0])
    for what, sl in (("ragged M=1000", slice(first, first + 1000)), ("M=1", slice(first, first + 1))):
        checks.append({"rows": what, **check_icp_jtj(
            *(x[sl].contiguous() for x in (p, q, n, w)))})
    g = generator(41)
    rnd = [torch.randn((3001, 3), generator=g, device=DEV) for _ in range(3)]
    rnd.append(torch.rand(3001, generator=g, device=DEV))
    checks.append({"rows": "random M=3001", **check_icp_jtj(*rnd)})

    p, q, n, w = (x.clone() for x in rows_by_name["config3 level 0"])
    zeros = flat8(icp_jtj_jtr(p, q, n, torch.zeros_like(w)))
    if not bool((zeros == 0).all()):
        raise AssertionError("icp_jtj_jtr: zero weights do not give exact zeros")
    checks.append({"rows": "all weights zero", "max_abs_err_vs_plain": 0.0})
    w[7] = 0.0
    p[7, 1] = float("nan")  # a zero-weight row is multiplied through, not skipped
    nan_err = check_icp_jtj(p, q, n, w)
    if not bool(torch.isnan(flat8(icp_jtj_jtr(p, q, n, w))).any()):
        raise AssertionError("icp_jtj_jtr: a NaN in a zero-weight row was skipped")
    checks.append({"rows": "one NaN row of weight 0", **nan_err})

    def timings(rows):
        p, q, n, w = rows
        M = p.shape[0]
        r = torch.sum(n * (p - q), dim=-1, keepdim=True)
        J = torch.cat([n, torch.linalg.cross(p, n, dim=-1), r, torch.ones_like(r)], dim=-1)
        Jw = J * w[:, None]
        alone = [{"name": "icp_jtj_jtr", "device_ms": None}]
        set_device_ms(alone, profile_device(lambda: [icp_jtj_jtr(p, q, n, w) for _ in range(20)]))
        return {
            "M": M,
            "ms": time_ms(lambda: icp_jtj_jtr(p, q, n, w)),
            "device_ms": alone[0]["device_ms"],
            "plain_ms": time_ms(lambda: icp_jtj_jtr_reference(p, q, n, w)),
            # One library product on the Jacobian built beforehand. The port
            # never calls it.
            "library_ms": time_ms(lambda: torch.einsum("mi,mj->ij", Jw, J)),
            # ten f32 a row read once, the 44 results written once
            "bytes": 40 * M + 4 * 44,
            "op_seconds": 87 * M / PEAK_F32_FLOPS,
        }

    by_size = [timings(rows_by_name[k]) for k in
               ("dense level 0", "dense level 1", "dense level 2", "config3 level 1")]
    record = {
        "name": "icp_jtj_jtr",
        "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/icp_jtj.cu",
        "replaces": "rgbd_pose_estimation_tpu/ops/icp_jtj.py:173",
        "shape": "M=19200 (config 3, level 0)",
        **timings(rows_by_name["config3 level 0"]),
    }
    del record["M"]
    err = next(c["max_abs_err_vs_plain"] for c in checks if c["rows"] == "config3 level 0")
    return checks, record, err, by_size


def hypotheses(seed, k, n):
    """A bench-like problem, its minimal sets and the hypotheses solved from
    them, with pose 3 made NaN (a degenerate minimal set's outcome)."""
    g = generator(seed)
    p, q, _, _ = synthetic_correspondences(g, n=n, outlier_frac=0.4, noise=0.003)
    idx = sample_minimal_sets(g, n, k, M)
    pp, qq = pad_correspondences_3d3d(p, q, ((n + 127) // 128) * 128)
    T = horn_from_moments(minimal_moments(idx, pp, qq), iters=4)
    T[3] = float("nan")
    return idx, pp, qq, T


def phase_kernels():
    """Returns the per-kernel records of the main-path shapes."""
    checks = []
    # Ragged shapes: K not a multiple of 256, N not a multiple of 128 (the
    # scorers see N = 200 unpadded here, and the sentinel-padded 256 below).
    idx, pp, qq, T = hypotheses(11, 1000, 200)
    checks.append({
        "shape": "K=1000 N=200",
        "minimal_moments": check_moments(idx, pp[:200].contiguous(), qq[:200].contiguous()),
        "score_poses_3d3d_quad_fused": check_quad(T, pp[:200].contiguous(), qq[:200].contiguous()),
        "score_poses_3d3d": check_exact(T, pp[:200].contiguous(), qq[:200].contiguous()),
    })
    checks.append({
        "shape": "K=1000 N=256 (56 pad sentinels)",
        "score_poses_3d3d_quad_fused": check_quad(T, pp, qq),
        "score_poses_3d3d": check_exact(T, pp, qq),
    })

    # Main-path shapes.
    idx, p, q, T = hypotheses(12, K, N)
    feat, pn = rs._quad_features(T, p, q)
    top = max(16, K // 1024)
    T_top = T[:top].contiguous()
    packed_top = rs.pack_poses(T_top)  # what best_pose_3d3d hands the kernel
    fb16, pb16 = feat.bfloat16(), pn.bfloat16()
    err = {
        "minimal_moments": check_moments(idx, p, q),
        "score_poses_3d3d_quad_fused": check_quad(T, p, q),
        "score_poses_3d3d": check_exact(T_top, p, q),
    }
    err_exact_all = check_exact(T, p, q)
    checks.append({"shape": f"K={K} N={N}", **err, "score_poses_3d3d[all K]": err_exact_all})

    tau2 = TAU * TAU
    f32 = PEAK_F32_FLOPS
    records = [
        {
            "name": "minimal_moments",
            "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/moments.cu",
            "replaces": "rgbd_pose_estimation_tpu/ops/moments.py:110",
            "ms": time_ms(lambda: minimal_moments(idx, p, q)),
            "plain_ms": time_ms(lambda: minimal_moments_reference(idx, p, q)),
            "library_ms": None,
            "bytes": 4 * (M * K + 16 * K) + 24 * N,
            "op_seconds": 24 * M * K / f32,
        },
        {
            "name": "score_poses_3d3d_quad_fused",
            "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/quad_score.cu",
            "replaces": "rgbd_pose_estimation_tpu/ops/ransac_score.py:279",
            "ms": time_ms(lambda: rs._quad_scores(feat, pn, TAU)),
            "plain_ms": time_ms(lambda: rs._quad_scores_reference(feat, pn, TAU), inner=1),
            # One bf16 tensor-core product, then clamp and sum: what a user
            # of the library alone would write. The port never calls it.
            "library_ms": time_ms(
                lambda: torch.clamp((fb16 @ pb16).float(), 0.0, tau2).sum(1), inner=1
            ),
            "bytes": 4 * (17 * K + 17 * N + K),
            # the product at the bf16 tensor-core peak, the clip-and-sum
            # epilogue (3 operations an entry) at the f32 peak
            "op_seconds": 2 * 17 * K * N / PEAK_BF16_FLOPS + 3 * K * N / f32,
        },
        {
            "name": "score_poses_3d3d",
            "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/score3d.cu",
            "replaces": "rgbd_pose_estimation_tpu/ops/ransac_score.py:107",
            "shape": f"K={top} finalists",
            "ms": time_ms(lambda: rs._score_packed(packed_top, p, q, TAU)),
            "plain_ms": time_ms(lambda: rs._score_packed_reference(packed_top, p, q, TAU)),
            "library_ms": None,
            "bytes": 4 * (12 * top + 6 * N + 2 * top),
            "op_seconds": 23 * top * N / f32,
        },
    ]
    icp_checks, icp_record, err["icp_jtj_jtr"], icp_by_size = kernel_icp_jtj()
    checks += icp_checks
    records.append(icp_record)
    for rec in records + icp_by_size:
        byte_ms = rec.pop("bytes") / PEAK_BYTES_S * 1e3
        op_ms = rec.pop("op_seconds") * 1e3
        rec["bound_ms"] = max(byte_ms, op_ms)
        rec["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    for rec in records:
        rec["route"] = "cuda"
        rec["max_abs_err"] = err[rec["name"]]
    # The exact scorer over all K (impl="exact"): not on the main path.
    exact_all = {
        "ms": time_ms(lambda: rs.score_poses_3d3d(T, p, q, TAU), inner=1),
        "plain_ms": time_ms(
            lambda: chunked(lambda t: rs.score_poses_3d3d_reference(t, p, q, TAU), T),
            reps=20, inner=1, warmup=1,
        ),
        "bound_ms": 23 * K * N / f32 * 1e3,
        "bound_by": "operations",
        "max_abs_err": err_exact_all,
    }
    emit("kernels", names=[r["name"] for r in records], checks=checks,
         main_path_shapes=records, score_poses_3d3d_all_K=exact_all,
         icp_jtj_jtr_by_size=icp_by_size)
    return records


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------


def pose_error(res, T_gt):
    if not bool(res.valid):
        raise AssertionError("estimate flagged invalid")
    if res.pose.shape != (4, 4) or not bool(torch.isfinite(res.pose).all()):
        raise AssertionError("pose is not a finite (4, 4) matrix")
    err = float((res.pose - T_gt).abs().max())
    if err >= POSE_TOL:
        raise AssertionError(f"pose error {err} >= {POSE_TOL}")
    return err


ESTIMATE_KERNELS = ("minimal_moments", "score_poses_3d3d_quad_fused", "score_poses_3d3d")


def phase_estimate():
    p, q, T_gt, _ = synthetic_correspondences(
        generator(0), n=N, outlier_frac=0.4, noise=0.003
    )
    # Warm-up request: builds the PROSAC windows (a host loop over K, cached)
    # and loads every PyTorch kernel the path uses.
    pose_error(estimate_pose_3d3d(generator(1), p, q, CFG), T_gt)
    torch.cuda.synchronize()

    requests = 5
    times, errs = [], []
    _build.reset_launch_counts()
    for i in range(requests):
        g = generator(100 + i)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = estimate_pose_3d3d(g, p, q, CFG)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
        errs.append(pose_error(res, T_gt))
    counts = _build.launch_counts()
    for name in ESTIMATE_KERNELS:
        if counts[name] != requests:
            raise AssertionError(
                f"{name}: {counts[name]} launches in {requests} estimates, expected one each"
            )
    ms = statistics.median(times)
    emit(
        "estimate", K=K, N=N, requests=requests,
        ms_per_estimate=ms, ms_samples=times,
        ransac_hypotheses_per_s=K / (ms * 1e-3),
        pose_max_err=max(errs),
        launches_per_estimate={k: counts[k] / requests for k in ESTIMATE_KERNELS},
    )
    return counts, (p, q, T_gt)


def track_once(cam, cfg, src, tgt, T_gt, launches):
    """One track from identity: the bench's accuracy gate, the launch
    counter, and the same bits from a second run. Returns the pose error."""
    eye = torch.eye(4, device=DEV)
    _build.reset_launch_counts()
    T, stats = icp_track(cam, cfg, eye, src, tgt)
    torch.cuda.synchronize()
    n = _build.launch_counts()["icp_jtj_jtr"]
    if n != launches:
        raise AssertionError(f"icp_track: {n} icp_jtj_jtr launches, expected {launches}")
    err = float((T @ T_gt - eye).abs().max())
    if not bool(torch.isfinite(T).all()) or not err < POSE_TOL:
        raise AssertionError(f"icp_track: pose error {err} >= {POSE_TOL}")
    if not bool(torch.isfinite(stats).all()) or float(stats[1]) <= 50.0:
        raise AssertionError(f"icp_track: stats {stats.tolist()}")
    # The second run must give the same bits, and wait for the device
    # nowhere: PyTorch raises at any call of its own that synchronises.
    torch.cuda.set_sync_debug_mode("error")
    try:
        T2, _ = icp_track(cam, cfg, eye, src, tgt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(T, T2):
        raise AssertionError("icp_track: two runs on the same frames differ")
    return err, stats.tolist()


def phase_icp_track():
    """The two dense-ICP rows of the bench at 640x480, three levels, then a
    short run of each remaining branch of the step (photometric rows,
    bilinear association) at 160x120. Returns ms per track by setting."""
    eye = torch.eye(4, device=DEV)
    out, ms_by_name = {}, {}
    for name, cfg in (("dense", ICP_DENSE), ("config3", ICP_CONFIG3)):
        src, tgt, T_gt = icp_scene(cfg)
        err, stats = track_once(CAM, cfg, src, tgt, T_gt, K4_LAUNCHES[name])
        ms = time_ms(lambda: icp_track(CAM, cfg, eye, src, tgt), reps=9, inner=1, warmup=1)
        ms_by_name[name] = ms
        out[name] = {
            "source_stride": cfg.source_stride, "reassoc_every": cfg.reassoc_every,
            "iters_per_level": cfg.iters_per_level, "icp_jtj_jtr_launches": K4_LAUNCHES[name],
            "pose_max_err": err, "stats": stats,
            "ms_per_track": ms, "frames_per_s": 1e3 / ms,
        }
    small = CAM.scaled(0.25)
    for name, cfg, intensity in (
        ("photometric_160x120", IcpConfig(photometric_weight=0.5), True),
        ("bilinear_160x120", IcpConfig(association="bilinear"), False),
    ):
        src, tgt, T_gt = icp_scene(cfg, small, intensity)
        err, stats = track_once(small, cfg, src, tgt, T_gt, sum(cfg.iters_per_level))
        out[name] = {"pose_max_err": err, "stats": stats}
    emit("icp_track", width=CAM.width, height=CAM.height, levels=3, **out)
    return ms_by_name


# Bounds of the odometry phase. 12 frames of smooth motion (0.8 cm, 0.5 deg a
# frame), every pose chained through keyframes: the JAX package's own test
# holds a 15-frame run at 160x120 to 1 cm ATE; here, at 640x480, camera centres
# are held to 2 mm frame by
# frame without alignment, and rotations entry by entry.
ODOMETRY_FRAMES = 12
CENTER_TOL_M = 0.002
ROTATION_TOL = 0.002
STREAM_TOL = 1e-2  # stream vs process where keyframe adoption lags: the JAX package's bound


def phase_odometry():
    """The dense odometry server at 640x480 with config 3's settings, fed
    host arrays as a user feeds it: synchronous, pipelined, pipelined with
    stacked transfers, and with uint16 depth. Returns the launch counts of
    the synchronous run (the main path)."""
    cfg = load_yaml_config(_ROOT / "configs" / "config3_dense_icp_odometry.yaml")
    frames = ODOMETRY_FRAMES
    poses_gt, depths, _ = synthetic_sequence(
        CAM, generator(31), frames, motion_scale=0.008, device=DEV)
    gt = poses_gt.cpu().numpy()
    depths_np = [d.cpu().numpy() for d in depths]
    depths_u16 = [np.asarray(d * 5000.0, np.uint16) for d in depths_np]

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    def serve(feed, kf_cfg=cfg.keyframe, n=frames):
        odo = DenseOdometry(CAM, cfg.icp, kf_cfg)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        feed(odo)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _build.launch_counts()
        traj = odo.trajectory()
        if traj.shape != (n, 4, 4) or not np.isfinite(traj).all():
            raise AssertionError("odometry: poses are not finite (frames, 4, 4)")
        c_err = float(np.abs(centers(traj) - centers(gt[:n])).max())
        r_err = float(np.abs(traj[:, :3, :3] - gt[:n, :3, :3]).max())
        if c_err >= CENTER_TOL_M or r_err >= ROTATION_TOL:
            raise AssertionError(f"odometry: centre error {c_err} m, rotation error {r_err}")
        return {"odo": odo, "traj": traj, "frames_per_s": n / seconds, "counts": counts,
                "center_err_m": c_err, "rotation_err": r_err}

    def sync(ds):
        return lambda odo: [odo.process(d) for d in ds]

    def stream(ds, **kw):
        def feed(odo):
            poses = odo.process_stream(iter(ds), **kw)
            got = [next(poses)[0]]  # the first frame founds keyframe 0 ...
            odo.keyframes[0].ref_weight_value()  # ... whose mass is read back once
            # From here on the server may wait for its events only: PyTorch
            # raises at any call of its own that waits for the stream.
            torch.cuda.set_sync_debug_mode("error")
            try:
                got += [i for i, _ in poses]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if got != list(range(len(ds))):
                raise AssertionError(f"process_stream yielded frames {got}")
        return feed

    serve(sync(depths_np[:3]), n=3)  # warm-up: loads every library kernel the path uses
    runs = {
        "process": serve(sync(depths_np)),
        "process_stream(pipeline_depth=2)": serve(stream(depths_np, pipeline_depth=2)),
        "process_stream(h2d_batch=4)": serve(stream(depths_np, h2d_batch=4, pipeline_depth=2)),
        "process, uint16 depth": serve(sync(depths_u16)),
    }
    ref = runs["process"]["traj"]
    for name, run in runs.items():
        run["max_diff_vs_process"] = float(np.abs(run["traj"] - ref).max())
        if run["max_diff_vs_process"] >= STREAM_TOL:
            raise AssertionError(f"{name} differs from process by {run['max_diff_vs_process']}")
    # With one keyframe for the whole run nothing lags, so the pipelined
    # server must give the synchronous server's poses: every track starts
    # from the same numbers (on the device instead of from the host) and the
    # kernels are repeatable. A pose read before its copy has landed fails here.
    one_kf = KeyframeConfig(min_inlier_ratio=0.0, max_interval=10**6)
    a = serve(sync(depths_np), one_kf)
    b = serve(stream(depths_np, pipeline_depth=2), one_kf)
    strict = float(np.abs(a["traj"] - b["traj"]).max())
    if strict > 1e-6 or len(a["odo"].keyframes) != 1 or len(b["odo"].keyframes) != 1:
        raise AssertionError(f"process_stream vs process without keyframe lag: {strict}")

    main = runs["process"]
    tracked = frames - 1
    if main["counts"]["icp_jtj_jtr"] != tracked * K4_LAUNCHES["config3"]:
        raise AssertionError(f"odometry: {main['counts']['icp_jtj_jtr']} icp_jtj_jtr launches "
                             f"over {tracked} tracked frames")
    emit(
        "odometry", frames=frames, width=CAM.width, height=CAM.height,
        icp=vars(cfg.icp), keyframe=vars(cfg.keyframe),
        runs={name: {"frames_per_s": r["frames_per_s"], "keyframes": len(r["odo"].keyframes),
                     "center_err_m": r["center_err_m"], "rotation_err": r["rotation_err"],
                     "max_diff_vs_process": r["max_diff_vs_process"]}
              for name, r in runs.items()},
        icp_jtj_jtr_launches_per_frame=main["counts"]["icp_jtj_jtr"] / frames,
        stream_vs_process_one_keyframe=strict,
    )
    return main["counts"]


# Substring of each hand-written kernel's name in a profiler trace.
DEVICE_NAMES = {
    "minimal_moments": ("minimal_moments_kernel",),
    "score_poses_3d3d_quad_fused": ("quad_score_kernel",),
    "score_poses_3d3d": ("score3d_kernel",),
    "icp_jtj_jtr": ("icp_jtj_partial_kernel", "icp_jtj_finish_kernel"),
}


def profile_device(fn):
    """Run ``fn`` once under the profiler. Returns (kernel name, launches,
    device microseconds) of everything that ran on the card; empty where the
    profiler cannot trace it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((ev.key, ev.count, dev_us))
    return rows


def device_summary(rows):
    if not rows:
        return {"cuda_kernel_launches": None, "device_busy_ms": None, "by_kernel_ms": None}
    by_name = {}  # kernel names cut to their first words; templates merge
    for key, count, dev_us in rows:
        entry = by_name.setdefault(key[:72], [0, 0.0])
        entry[0] += count
        entry[1] += dev_us / 1e3
    return {
        "cuda_kernel_launches": sum(r[1] for r in rows),
        "device_busy_ms": sum(r[2] for r in rows) / 1e3,
        "by_kernel_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]),
    }


def set_device_ms(records, rows):
    """``device_ms`` of each record whose kernels ran in this profile: the
    device time of all its kernels for one launch of the wrapper."""
    for rec in records:
        names = DEVICE_NAMES[rec["name"]]
        launches = sum(r[1] for r in rows if names[0] in r[0])
        if launches:
            total_us = sum(r[2] for r in rows if any(nm in r[0] for nm in names))
            rec["device_ms"] = total_us / launches / 1e3


def phase_stages(p, q, records, track_ms):
    """Where an estimate's time goes: each layer alone, synchronous, through
    the same public functions the engine calls (it is eager PyTorch around
    the three kernels, so most of this is the launching of small kernels).
    Then one estimate and one config-3 track under the profiler, for the
    device's side of them; each record gets its kernel's time on the device
    (``device_ms``, None where the profiler saw no device activity; K4's
    record has its own, taken alone at the record's shape)."""
    g = generator(7)
    idx = sample_minimal_sets(g, N, K, M)
    mom = minimal_moments(idx, p, q)
    T = horn_from_moments(mom, iters=4)
    w = (torch.rand(N, generator=g, device="cuda") < 0.6).float()
    stages = {
        "sample_minimal_sets": lambda: sample_minimal_sets(g, N, K, M),
        "minimal_moments (K1)": lambda: minimal_moments(idx, p, q),
        "horn_from_moments iters=4": lambda: horn_from_moments(mom, iters=4),
        "best_pose_3d3d (features, K2, finalists, K3)": lambda: rs.best_pose_3d3d(
            T, p, q, TAU, return_pose=True
        ),
        "refit round (residuals + horn_quaternion iters=12)": lambda: horn_quaternion(
            p, q, weights=w
        ),
    }
    out = {name: time_ms(fn, reps=20, inner=1, warmup=2) for name, fn in stages.items()}

    # Device-side view of one estimate, and of one config-3 track.
    rows = profile_device(lambda: estimate_pose_3d3d(generator(8), p, q, CFG))
    src, tgt, _ = icp_scene(ICP_CONFIG3)
    eye = torch.eye(4, device=DEV)
    track_rows = profile_device(lambda: icp_track(CAM, ICP_CONFIG3, eye, src, tgt))
    in_estimate = [rec for rec in records if rec["name"] in ESTIMATE_KERNELS]
    for rec in in_estimate:
        rec["device_ms"] = None
    set_device_ms(in_estimate, rows)
    track = device_summary(track_rows)
    # K4's record keeps its time alone at one shape; the track's mean over its
    # 13 launches (3 at M = 19200, 10 at M = 4800) stands here.
    in_track = [{"name": "icp_jtj_jtr", "device_ms": None}]
    set_device_ms(in_track, track_rows)
    track["icp_jtj_jtr_device_ms_per_launch"] = in_track[0]["device_ms"]
    if track["device_busy_ms"] is not None:
        track["ms_per_track"] = track_ms
        track["idle_share"] = 1.0 - track["device_busy_ms"] / track_ms

    # The layers of one config-3 Gauss-Newton step at level 0, each alone.
    step, step_rows = level_step(CAM, ICP_CONFIG3, src, tgt, 0)
    data = step_rows(eye)[0]
    JtJ, Jtr, _, _ = icp_jtj_jtr(*data)
    H = JtJ + 1e-6 * torch.eye(6, device=DEV)
    depth, _ = synthetic_depth_scene(CAM, eye)
    step_ms = {
        "make_icp_frame 640x480, 3 levels": lambda: make_icp_frame(CAM, depth, ICP_CONFIG3),
        "level closure (strided views, packed target map)": lambda: level_step(
            CAM, ICP_CONFIG3, src, tgt, 0),
        "warp + associate + weights (19200 rows)": lambda: step_rows(eye),
        "icp_jtj_jtr (K4)": lambda: icp_jtj_jtr(*data),
        "solve_ex 6x6": lambda: torch.linalg.solve_ex(H, -Jtr[:, None]),
        "se3_exp + compose": lambda: se3_exp(Jtr) @ eye,
        "whole step": lambda: step(eye),
    }
    step_out = {name: time_ms(fn, reps=20, inner=1, warmup=2) for name, fn in step_ms.items()}
    emit("stages", synchronous_ms=out, profiled_estimate=device_summary(rows),
         config3_step_synchronous_ms=step_out, profiled_config3_track=track)


def phase_adaptive(p, q, T_gt):
    res = estimate_pose_3d3d_adaptive(generator(9), p, q, CFG)
    err = pose_error(res, T_gt)
    emit("adaptive", num_hypotheses=res.num_hypotheses, pose_max_err=err,
         num_inliers=float(res.num_inliers))


def phase_reference():
    """The estimator on the card against the same estimator on the CPU (its
    plain versions), from the same correspondences and minimal sets, at a
    small size. 2e-3: the two rank with different summation orders, and
    near-tied hypotheses share one refit basin to that tolerance."""
    g = generator(21)
    p, q, T_gt, _ = synthetic_correspondences(g, n=200, outlier_frac=0.4, noise=0.003)
    cfg = RansacConfig(num_hypotheses=512, threshold=TAU, refit_rounds=2)
    idx = sample_minimal_sets(g, 200, 512, M)
    on_card = _estimate_from_samples(idx, p, q, cfg)
    on_cpu = _estimate_from_samples(idx.cpu(), p.cpu(), q.cpu(), cfg)
    diff = float((on_card.pose.cpu() - on_cpu.pose).abs().max())
    agree = float((on_card.inlier_mask.cpu() == on_cpu.inlier_mask).float().mean())
    if diff > 2e-3 or agree < 0.99 or bool(on_card.valid) != bool(on_cpu.valid):
        raise AssertionError(f"card vs CPU: pose diff {diff}, inlier masks agree {agree}")

    # A small track (80x60, two levels) on the card against the same track on
    # the CPU, which runs K4's plain version. 2e-4: the normal equations are
    # summed in another order, and a nearest-pixel association that flips at
    # a rounding boundary moves one row of thousands.
    cam = CameraIntrinsics(80.0, 80.0, 39.5, 29.5, 80, 60)
    icfg = IcpConfig(levels=2, iters_per_level=(4, 6))
    src, tgt, T_icp = icp_scene(icfg, cam)
    T_card, stats_card = icp_track(cam, icfg, torch.eye(4, device=DEV), src, tgt)
    on_host = [type(f)(*(tuple(x.cpu() for x in level) for level in f)) for f in (src, tgt)]
    T_cpu, stats_cpu = icp_track(cam, icfg, torch.eye(4), *on_host)
    track_diff = float((T_card.cpu() - T_cpu).abs().max())
    track_err = float((T_card @ T_icp - torch.eye(4, device=DEV)).abs().max())
    if track_diff > 2e-4 or track_err >= POSE_TOL:
        raise AssertionError(f"icp_track card vs CPU: pose diff {track_diff}, error {track_err}")
    emit("reference", pose_max_diff=diff, inlier_mask_agreement=agree,
         pose_max_err=pose_error(on_card, T_gt),
         icp_track_pose_max_diff=track_diff, icp_track_pose_max_err=track_err,
         icp_track_stats=[stats_card.tolist(), stats_cpu.tolist()])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0)

    records = phase_kernels()
    counts, (p, q, T_gt) = phase_estimate()
    track_ms = phase_icp_track()
    odometry_counts = phase_odometry()
    phase_stages(p, q, records, track_ms["config3"])
    phase_adaptive(p, q, T_gt)
    phase_reference()

    # Launches on each kernel's own main path: the estimates for K1-K3, the
    # synchronous odometry run for K4, each counted from zero.
    for rec in records:
        path = counts if rec["name"] in ESTIMATE_KERNELS else odometry_counts
        rec["launches"] = path[rec["name"]]
        if rec["launches"] < 1:
            raise AssertionError(f"{rec['name']} was not launched by the main path")
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
