"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; takes no arguments and no network. It
builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at the shapes of the main path,
drives the main path (the 3D-3D RANSAC frame-pair estimator at the bench
size, K = 32768 hypotheses x N = 2048 correspondences) through the entry
points a user calls, and shows through the launch counters that the path
went through every kernel. Every phase prints one JSON line; any failed
check raises, so the exit code is non-zero and the last line is missing.

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

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_correspondences
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.ops import ransac_score as rs
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
from rgbd_pose_estimation_tpu_torch.utils.config import RansacConfig

# The bench problem (bench.py of the JAX package): the metric of record is
# RANSAC hypotheses per second at this size.
K, N, M, TAU = 32768, 2048, 3, 0.05
CFG = RansacConfig(num_hypotheses=K, threshold=TAU, refit_rounds=2, solver="horn")
POSE_TOL = 0.05  # max |pose - ground truth|, the bench's accuracy gate

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def generator(seed):
    g = torch.Generator(device="cuda")
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
    for rec in records:
        byte_ms = rec.pop("bytes") / PEAK_BYTES_S * 1e3
        op_ms = rec.pop("op_seconds") * 1e3
        rec["bound_ms"] = max(byte_ms, op_ms)
        rec["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
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
         main_path_shapes=records, score_poses_3d3d_all_K=exact_all)
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
    for name, n in counts.items():
        if n != requests:
            raise AssertionError(
                f"{name}: {n} launches in {requests} estimates, expected one each"
            )
    ms = statistics.median(times)
    emit(
        "estimate", K=K, N=N, requests=requests,
        ms_per_estimate=ms, ms_samples=times,
        ransac_hypotheses_per_s=K / (ms * 1e-3),
        pose_max_err=max(errs),
        launches_per_estimate={k: v / requests for k, v in counts.items()},
    )
    return counts, (p, q, T_gt)


# Substring of each hand-written kernel's name in a profiler trace.
DEVICE_NAMES = {
    "minimal_moments": "minimal_moments_kernel",
    "score_poses_3d3d_quad_fused": "quad_score_kernel",
    "score_poses_3d3d": "score3d_kernel",
}


def phase_stages(p, q, records):
    """Where an estimate's time goes: each layer alone, synchronous, through
    the same public functions the engine calls (it is eager PyTorch around
    the three kernels, so most of this is the launching of small kernels).
    Then one estimate under the profiler, for the device's side of it; each
    record gets its kernel's time on the device (``device_ms``, None where
    the profiler saw no device activity)."""
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

    # Device-side view of one estimate, where the profiler can trace the card.
    device = {"cuda_kernel_launches": None, "device_busy_ms": None, "by_kernel_ms": None}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        estimate_pose_3d3d(generator(8), p, q, CFG)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((ev.key, ev.count, dev_us))
    for rec in records:
        mine = [r for r in rows if DEVICE_NAMES[rec["name"]] in r[0]]
        rec["device_ms"] = sum(r[2] for r in mine) / sum(r[1] for r in mine) / 1e3 if mine else None
    if rows:
        by_name = {}  # kernel names cut to their first words; templates merge
        for key, count, dev_us in rows:
            entry = by_name.setdefault(key[:72], [0, 0.0])
            entry[0] += count
            entry[1] += dev_us / 1e3
        top_rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        device = {
            "cuda_kernel_launches": sum(r[1] for r in rows),
            "device_busy_ms": sum(r[2] for r in rows) / 1e3,
            "by_kernel_ms": dict(top_rows),
        }
    emit("stages", synchronous_ms=out, profiled_estimate=device)


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
    emit("reference", pose_max_diff=diff, inlier_mask_agreement=agree,
         pose_max_err=pose_error(on_card, T_gt))


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
    phase_stages(p, q, records)
    phase_adaptive(p, q, T_gt)
    phase_reference()

    for rec in records:
        rec["launches"] = counts[rec["name"]]
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
