"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; takes no arguments and no network. It
builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at the shapes of the main paths,
drives the main paths through the entry points a user calls, and shows
through the launch counters that each path went through its kernels:

- the 3D-3D RANSAC frame-pair estimator at the bench size, K = 32768
  hypotheses x N = 2048 correspondences (phases ``estimate``, ``adaptive``);
- the 2D-3D (P3P) RANSAC estimator at the config-2 size, K = 2048 minimal
  samples (8192 root poses) x N = 1024 correspondences, on the bench's clean
  row and on a 30%-contaminated problem, its adaptive wrapper, and the
  point+normal estimator at K = 2048 pairs x N = 2048 (``estimate_2d3d``,
  ``stages_2d3d``);
- dense projective ICP at 640x480, three levels, at the dense and the
  config-3 settings, one launch of the fused step kernel a Gauss-Newton
  step (``icp_track``), and the dense odometry server ``DenseOdometry`` over a rendered sequence, synchronous and
  pipelined (``odometry``); the photometric and bilinear steps, which still
  accumulate through K4, at 160x120;
- the frame-pair model ``FramePairEstimator`` (configurations 1 and 2) at
  640x480 through the FAST+BRIEF detector on the card: config 1's and the
  default (Horn) 3D-3D estimators and config 2's 2D-3D estimator, from host
  images to a pose, with detection and matching held against the CPU
  (``frame_pair``);
- the keyframe SLAM model ``Slam`` (configuration 4's backend) over 32
  frames at 640x480: tracking, ICP-verified loop closures and the pose graph
  (``slam``);
- configuration 5 on one card (``ba``): a 64-frame 640x480 TUM-format
  sequence written to disk and read back through the port's readers and
  prefetcher, ``Slam.optimize(bundle_adjust=True)`` over it (loop closure,
  the pose graph, the BA build and the Schur-complement solve), then
  ``ba_solve`` at O = 98,304 observations (cost, truth, bit-equal reruns,
  card against CPU, no wait for the stream);
- the distributed layer on a mesh of one rank, a real NCCL group of world
  size 1 (``distributed``): each sharded function against its single-device
  twin at the shapes above (K3 through ``score_poses_3d3d_sharded``, K4
  through ``icp_jtj_sharded``, the fused ICP step through
  ``icp_verify_sharded`` on phase ``ba``'s loop candidates, the replicated
  and the landmark-blocked BA at O = 98,304 with the all-to-all relayout,
  the ring similarity), the bytes a blocked CG iteration reduces, the
  sharded ``Slam.optimize(bundle_adjust=True, mesh=)`` against the call
  without mesh, configuration 5 as one call (``distributed_slam`` over
  phase ``ba``'s 64 frames: its ATE within 1.5 mm of the Slam's, a bit-equal
  rerun, no observation dropped, 22 fused steps a tracked frame and a
  verified candidate; ``sequence_parallel_odometry`` with the mesh
  bit-equal to without), and ``dryrun_multichip(1)`` with its
  configuration-5 tail;
- the command line a user starts the system with, ``cli/main.py``'s
  ``main(argv)`` in this process (``cli``): ``synth`` writes a 64-frame
  640x480 directory, then ``pair`` (configurations 1 and 2), ``odom`` with
  the pose graph (configuration 3, 4's backend) and ``eval``, ``odom
  --resume`` across its checkpoint, ``ba`` in one process (configuration 5 on
  a 1 x 1 mesh) with ``--fail-at-iter`` and ``--resume``, ``slam``
  (configuration 5 in one command; the file of a direct ``distributed_slam``
  call byte for byte; ``--mesh-devices 2`` on one card raises before any
  rank starts); each command's kernel launches counted exactly;
- ``sequence_parallel_odometry`` over the first 32 of those frames, four
  chunks in four host threads and one after another, stitched by the anchor
  pose graph (``sequence_parallel``);
- the repository's remaining entry points: the ICP experiments
  ``tools/reassoc_exp.py`` and ``tools/photometric_exp.py`` at full width
  (the 10-frame 640x480 hard-mode sequence, config 3's stride; every
  accuracy loop's launches counted exactly, each table's track times as
  CUDA-graph slopes) and the readiness kit ``tools/verify_dataset.py`` on
  phase ``cli``'s directory and a byteswapped copy of it (``tools``);
- the scaling harness ``eval/scaling.py`` at its defaults on the one card:
  the step mode (K3's launches counted) and the slam mode (``scaling``);
- ``entry.py``'s flagship step (the 3D-3D estimate at K = 1024 x N = 512):
  one call with no wait for the stream, K1, K2, K3 and the two Horn kernels
  once each, then the call captured in a CUDA graph and replayed
  (``entry``);
- the measurement harness, ``tools/msac_opt.py`` and ``tools/roofline.py``
  of the port: the MSAC variants T1, T2, T3, T5 and the ceiling probes T4,
  T6 against their plain versions, then the msac timing table at K = 4096
  and 32768 x N = 2048 and the measured ceilings, graph-chained, with T4
  also at (8, 131072), and its SASS issue floor
  (``msac_opt``).

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
from rgbd_pose_estimation_tpu_torch.core.lie import rt_to_matrix, se3_apply, se3_exp
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
from rgbd_pose_estimation_tpu_torch.eval.ate import ate_rmse
from rgbd_pose_estimation_tpu_torch.features import frontend, tpu_detect
from rgbd_pose_estimation_tpu_torch.graph import pose_graph
from rgbd_pose_estimation_tpu_torch.models.frame_pair import FramePairEstimator
from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry
from rgbd_pose_estimation_tpu_torch.models.slam import Slam
from rgbd_pose_estimation_tpu_torch.ops import _build, ceilings
from rgbd_pose_estimation_tpu_torch.ops import msac_variants as mv
from rgbd_pose_estimation_tpu_torch.ops import ransac_score as rs
from rgbd_pose_estimation_tpu_torch.ops import icp_jtj
from rgbd_pose_estimation_tpu_torch.ops.icp_jtj import (
    icp_assoc_jtj_jtr,
    icp_assoc_jtj_jtr_reference,
    icp_assoc_rows_reference,
    icp_jtj_jtr,
    icp_jtj_jtr_reference,
)
from rgbd_pose_estimation_tpu_torch.ops.moments import (
    minimal_moments,
    minimal_moments_reference,
)
from rgbd_pose_estimation_tpu_torch.ransac.engine import (
    _best_root_pose,
    _estimate_2d3d_from_samples,
    _estimate_from_samples,
    _minimal_rays,
    _pack_root_poses,
    _refit_3d3d,
    _refit_3d3d_reference,
    estimate_pose_2d3d,
    estimate_pose_2d3d_adaptive,
    estimate_pose_3d3d,
    estimate_pose_3d3d_adaptive,
    estimate_pose_3d3d_normals,
    pad_correspondences_3d3d,
    pad_points_obs_2d3d,
)
from rgbd_pose_estimation_tpu_torch.ransac.prosac import sample_minimal_sets
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import (
    horn_from_moments,
    horn_from_moments_reference,
)
from rgbd_pose_estimation_tpu_torch.solvers.p3p import p3p
from rgbd_pose_estimation_tpu_torch.solvers.pnp import pnp_refine
from rgbd_pose_estimation_tpu_torch.utils.config import (
    IcpConfig,
    KeyframeConfig,
    PipelineConfig,
    RansacConfig,
    load_yaml_config,
)

DEV = "cuda"
SMI = None  # the card's name and power limit as nvidia-smi gives them (set by main)

# The bench problem (bench.py of the JAX package): the metric of record is
# RANSAC hypotheses per second at this size.
K, N, M, TAU = 32768, 2048, 3, 0.05
CFG = RansacConfig(num_hypotheses=K, threshold=TAU, refit_rounds=2, solver="horn")
POSE_TOL = 0.05  # max |pose - ground truth|, the bench's accuracy gate

# The 2D-3D row of the bench (config 2): K2D minimal samples, so
# 4 * K2D P3P root poses, against the first N2D rows of the bench problem
# moved 4 units down the optical axis and projected exactly. Its settings
# come from configs/config2_ransac_pnp_pair.yaml. K5 launches once an estimate.
K2D, N2D = 2048, 1024
K2D_LARGE = 32768  # samples of the large case that shows K5's rate
NORMALS_TOL = 0.02  # the point+normal estimator's gate (the JAX package's test)

# The dense-ICP rows of the bench: one 640x480 frame pair of the analytic
# scene, three levels, at the dense setting and at config 3's. Each
# Gauss-Newton step of a track is one launch of the fused step kernel
# (icp_assoc_jtj_jtr); K4 (icp_jtj_jtr) is launched by the photometric and
# bilinear steps only.
CAM = CameraIntrinsics(525.0, 525.0, 319.5, 239.5, 640, 480)
XI_GT = [0.01, -0.008, 0.005, 0.01, -0.012, 0.008]
ICP_DENSE = IcpConfig(downscale=1, source_stride=(1, 1, 1), reassoc_every=1,
                      iters_per_level=(5, 7, 10))
ICP_CONFIG3 = IcpConfig(downscale=1, source_stride=(4, 4, 2), reassoc_every=2,
                        iters_per_level=(3, 4, 6))
STEPS_PER_TRACK = {"dense": 22, "config3": 13}
# Device launches of one config-3 track when every step made its rows in
# PyTorch and accumulated them with K4, counted under torch.profiler on an
# H100 80GB HBM3 at 700 W: what the fused step's count is set beside.
UNFUSED_LAUNCHES_PER_TRACK = {"config3": 2115}
# Operations of the fused step a sample, counted from its source: warp 33,
# projection 8, gates 36, Huber weight 3, row 14, the 36 weighted pair sums 80.
ASSOC_OPS = 174

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
    """K1 bit for bit: kernel and plain version round the products and add
    them in the same order, starting from the sample's first row."""
    out = minimal_moments(idx, p, q)
    ref = minimal_moments_reference(idx, p, q)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"minimal_moments {tuple(idx.shape)}: not the plain version's bits")
    return max_abs_err(out, ref)


# Sample sizes K1 is checked at: its instances m = 1..8 (the engines use 3)
# and, above them, the chunked one (m = 11: a chunk of 8 and one of 3).
MOMENTS_M = (1, 2, 3, 4, 5, 8, 11)
K1_THREADS = 128  # threads a block of moments.cu
HORN_THREADS = 128  # threads a block of horn.cu's hypotheses kernel


def check_moments_by_m(k=1000, n=200):
    """K1 at every checked sample size m, at a ragged K, bit for bit."""
    g = generator(21)
    p = torch.randn((n, 3), generator=g, device=DEV)
    q = torch.randn((n, 3), generator=g, device=DEV)
    for m in MOMENTS_M:
        idx = torch.rand((k, n), generator=g, device=DEV).argsort(dim=1)[:, :m]
        check_moments(idx.to(torch.int32).contiguous(), p, q)
    return {"K": k, "N": n, "m": list(MOMENTS_M), "bit_equal": True}


def quad_scores_f64(feat, pn):
    """K2's function in float64 from the same bf16-rounded operands."""
    fb, pb = feat.bfloat16().double(), pn.bfloat16().double()
    return chunked(lambda f: torch.clamp(f @ pb, 0.0, TAU * TAU).sum(1), fb, 8192)


def check_quad(T, p, q, needs_nan_pose=True):
    """K2 against float64, rtol 1e-3: the tensor-core kernel, its plain
    version, and the CUDA-core design kept beside it. The 17 terms of an
    entry are of order |p|² ~ 10-50 and cancel to residuals near τ² = 2.5e-3,
    and the kernels sum them in another order than any matrix product does
    (the tensor cores' f32 additions in an order of their own): an f32 plain
    version is no more right than a kernel, so all are held to the f64 value
    of the same rounded operands. Entries err by ~1e-6 absolute, up to ~1e-3
    of a small entry; the (K,) sums of N clipped entries much less. A NaN
    pose (the problem must have one when ``needs_nan_pose``) must score NaN,
    and only it; a rerun must give the same bits."""
    feat, pn = rs._quad_features(T, p, q)
    out = rs._quad_scores(feat, pn, TAU)
    again = rs._quad_scores(feat, pn, TAU)
    cuda_cores = mv.quad_fused_cuda_cores(feat, pn, TAU)
    ref = quad_scores_f64(feat, pn)
    plain = rs._quad_scores_reference(feat, pn, TAU)
    torch.cuda.synchronize()
    nan_pose = torch.isnan(feat).any(dim=1)
    if (needs_nan_pose and not bool(nan_pose.any())) or not torch.equal(torch.isnan(out), nan_pose):
        raise AssertionError("score_poses_3d3d_quad_fused: NaN does not sit at the NaN pose alone")
    if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("score_poses_3d3d_quad_fused: two runs on the same input differ")
    assert_close(out, ref, 1e-3, 0.0, "score_poses_3d3d_quad_fused vs f64")
    assert_close(cuda_cores, ref, 1e-3, 0.0, "quad_fused_cuda_cores vs f64")
    assert_close(plain, ref, 1e-3, 0.0, "score_poses_3d3d_quad (plain) vs f64")
    return max_abs_err(out, ref)


def check_quad_winner(T, p, q):
    """The fast pass decides which finalists get the exact re-score: the
    winner of best_pose_3d3d with the tensor-core K2 must be the CUDA-core
    design's, or tie with it in exact score within 1e-5 relative."""
    new_i, new_s = rs.best_pose_3d3d(T, p, q, TAU)
    kept = rs._quad_scores
    rs._quad_scores = mv.quad_fused_cuda_cores
    try:
        old_i, old_s = rs.best_pose_3d3d(T, p, q, TAU)
    finally:
        rs._quad_scores = kept
    rel = abs(float(new_s) - float(old_s)) / abs(float(old_s))
    if int(new_i) != int(old_i) and rel > 1e-5:
        raise AssertionError(f"best_pose_3d3d: winner {int(new_i)} (score {float(new_s)}) against "
                             f"the CUDA-core design's {int(old_i)} ({float(old_s)})")
    return {"same_winner": int(new_i) == int(old_i), "exact_score_rel_diff": rel}


def check_exact(T, p, q):
    """K3. Scores rtol 1e-5 (N f32 terms summed in another order). Counts
    are equal except where a residual sits within f32 rounding of τ²: a
    difference of at most 1, on at most 0.1% of the poses. A second run must
    give the same bits, and a NaN pose must score NaN with count 0 (and only
    a NaN pose NaN)."""
    m_out, c_out = rs.score_poses_3d3d(T, p, q, TAU)
    m_again, c_again = rs.score_poses_3d3d(T, p, q, TAU)
    m_ref, c_ref = chunked(lambda t: rs.score_poses_3d3d_reference(t, p, q, TAU), T)
    torch.cuda.synchronize()
    what = f"score_poses_3d3d K={T.shape[0]} N={p.shape[0]}"
    if not (torch.equal(m_out.view(torch.int32), m_again.view(torch.int32))
            and torch.equal(c_out, c_again)):
        raise AssertionError(f"{what}: two runs on the same input differ")
    nan_pose = torch.isnan(T.reshape(T.shape[0], -1)).any(dim=1)
    if not torch.equal(torch.isnan(m_out), nan_pose) or bool((c_out[nan_pose] != 0).any()):
        raise AssertionError(f"{what}: a NaN pose does not score NaN with count 0, or another does")
    assert_close(m_out, m_ref, 1e-5, 0.0, f"{what} msac")
    diff = (c_out - c_ref).abs()
    if float(diff.max()) > 1 or float((diff > 0).float().mean()) > 1e-3:
        raise AssertionError(
            f"{what} counts: max diff {float(diff.max())}, "
            f"{int((diff > 0).sum())} of {diff.numel()} poses differ"
        )
    if bool(torch.isnan(c_out).any()):
        raise AssertionError(f"{what}: a count is NaN")
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
    each other within twice that. Run twice back to back, the kernel must
    give the same bits. Returns max |kernel − plain| and the kernel's largest
    share of its bound's scale."""
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


def check_icp_jtj_graphs(rows_a, rows_b, calls=16):
    """K4 recorded into two CUDA graphs of ``calls`` launches each, on rows
    of different grids: every launch of every replay gives the eager call's
    bits, with the second graph replayed before the first, then each after
    the other, then the two at once on two streams, so that their launches
    run on the card together. Before each replay the results are set to
    NaN: a launch whose last block never summed shows. Each capture holds a
    ticket of its own, zeroed by a node of its graph at every replay; the
    capture stream has run no eager K4."""
    eager = [flat8(icp_jtj_jtr(*rows)).clone() for rows in (rows_a, rows_b)]
    graphs, results = [], []
    for rows in (rows_a, rows_b):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            results.append([icp_jtj_jtr(*rows) for _ in range(calls)])
        graphs.append(graph)

    def poison(i):
        for res in results[i]:
            for x in res:
                x.fill_(float("nan"))

    replays = []  # (graph, the outputs of its launches after the replay)
    for i in (1, 0, 0, 1, 1, 0):
        poison(i)
        graphs[i].replay()
        replays.append((i, [flat8(res).clone() for res in results[i]]))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for _ in range(5):
        for i, stream in enumerate(streams):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                poison(i)
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                graphs[i].replay()
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                replays.append((i, [flat8(res).clone() for res in results[i]]))
            torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    differ = [n for n, (i, outs) in enumerate(replays)
              if not all(torch.equal(o.view(torch.int32), eager[i].view(torch.int32)) for o in outs)]
    if differ:
        raise AssertionError(f"icp_jtj_jtr: CUDA-graph replays {differ} of {len(replays)} differ "
                             f"from the eager call")
    return {"rows": f"two CUDA graphs of {calls} launches, M={rows_a[0].shape[0]} and "
                    f"{rows_b[0].shape[0]}: the second replayed first, one after the other, "
                    f"two streams at once", "replays": len(replays), "bit_equal_to_eager": True}


def kernel_icp_jtj():
    """K4 at every size of the rows of a 640x480 track (the photometric
    step's rows among them), on the rows of real association steps (started
    from identity, so residuals are those of a first iteration), then ragged
    sizes, zero weights, a NaN row and CUDA-graph replays. Timings by size:
    K4 alone on the device beside an empty kernel of its grid.
    Returns (checks, the record of the main path's shape, its error, the
    records at the other sizes)."""
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
    checks.append(check_icp_jtj_graphs(rows_by_name["config3 level 0"], rows_by_name["dense level 0"]))

    def timings(rows):
        p, q, n, w = rows
        M = p.shape[0]
        r = torch.sum(n * (p - q), dim=-1, keepdim=True)
        J = torch.cat([n, torch.linalg.cross(p, n, dim=-1), r, torch.ones_like(r)], dim=-1)
        Jw = J * w[:, None]
        blocks = icp_jtj._blocks(M, p.device)
        calls = profile_device(lambda: [icp_jtj_jtr(p, q, n, w) for _ in range(20)])
        return {
            "M": M,
            "ms": time_ms(lambda: icp_jtj_jtr(p, q, n, w)),
            "device_ms": device_ms_alone("icp_jtj_jtr", lambda: icp_jtj_jtr(p, q, n, w)),
            # every kernel the card ran for 20 calls, over 20
            "device_kernels_per_call": sum(r[1] for r in calls) / 20 if calls else None,
            # The floor of its launch: as many blocks that do nothing.
            "blocks": blocks,
            "empty_kernel_device_ms": device_ms_alone("empty_kernel", lambda: ceilings.empty_kernel(blocks)),
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
        # the finest level of the bilinear 160x120 track has as many rows
        "shape": "M=19200 (rows of config 3, level 0)",
        **timings(rows_by_name["config3 level 0"]),
    }
    del record["M"]
    err = next(c["max_abs_err_vs_plain"] for c in checks if c["rows"] == "config3 level 0")
    return checks, record, err, by_size


def assoc_from_index(index, tgt_v, tgt_n):
    """The plain version's association tuple for the fused kernel's map of
    target pixels: the gathered [vertex, normal] rows, the in-bounds mask and
    the pixel (read by the photometric rows only)."""
    tw = tgt_v.shape[1]
    pack = torch.cat([tgt_v.reshape(-1, 3), tgt_n.reshape(-1, 3)], dim=-1)
    idx = index.clamp(min=0)
    return pack[idx.long()], index >= 0, idx % tw, idx // tw


def fused_level(cfg, src, tgt, level, stride=None):
    """The fused step of one pyramid level (its kernel's wrapper) and what it
    was built from: (maps, stride, intrinsics, thresholds)."""
    cam = CAM.scaled(0.5**level)
    stride = cfg.source_stride[level] if stride is None else stride
    inputs = ((src.vertices[level], src.normals[level], tgt.vertices[level], tgt.normals[level]),
              stride, (cam.fx, cam.fy, cam.cx, cam.cy),
              (cfg.dist_threshold, cfg.normal_threshold, cfg.huber_delta))
    maps, stride, intr, thr = inputs
    return icp_assoc_jtj_jtr(*maps, stride, intr, thr), inputs


def source_rows(inputs):
    maps, stride, _, _ = inputs
    return maps[0][::stride, ::stride].reshape(-1, 3), maps[1][::stride, ::stride].reshape(-1, 3)


def check_icp_assoc(acc, inputs, T, what, carried_over=None):
    """The fused step at pose ``T``, fresh, or carried over the association
    map ``carried_over`` of an earlier fresh call. Its 8x8 is held to float64
    of the rows that its OWN association gives (made in plain PyTorch), within
    K4's bound (1e-4 of each entry's sum of absolute terms): the kernel
    projects with fused multiply-adds where the plain version rounds each
    operation, so a projection within rounding of a pixel boundary may land
    next door. Its association map may differ from the plain version's on
    at most 0.1% of the samples; where none differs (always on a carried
    step, which reuses the map) the 8x8 is also held to the plain version
    within twice the bound. A rerun must give the same bits and a carried
    step must leave the map as it was. Returns (record, the map)."""
    maps, stride, intr, thr = inputs
    tw = maps[2].shape[1]
    if carried_over is None:
        out, index = flat8(acc(T)[:4]).clone(), acc.index.clone()
        again, index_again = flat8(acc(T)[:4]).clone(), acc.index.clone()
        *plain, (_, in_b, ui, vi) = icp_assoc_jtj_jtr_reference(T, *maps, stride, intr, thr)
        index_plain = torch.where(in_b, vi * tw + ui, -1)
    else:
        index = carried_over
        out = flat8(acc(T, acc.index)[:4]).clone()
        again, index_again = flat8(acc(T, acc.index)[:4]).clone(), acc.index.clone()
        *plain, _ = icp_assoc_jtj_jtr_reference(
            T, *maps, stride, intr, thr, assoc_from_index(index, maps[2], maps[3]))
        index_plain = index
    plain = flat8(plain)
    rows = icp_assoc_rows_reference(T, *source_rows(inputs), maps[2], maps[3], intr, thr,
                                    assoc_from_index(index, maps[2], maps[3]))[0]
    ref, scale = jtj_f64(*rows)
    torch.cuda.synchronize()
    M = index.numel()
    if not (torch.equal(out.view(torch.int32), again.view(torch.int32))
            and torch.equal(index, index_again)):
        raise AssertionError(f"icp_assoc_jtj_jtr {what}: two runs differ")
    differ = int((index != index_plain).sum())
    if differ > 1e-3 * M:
        raise AssertionError(f"icp_assoc_jtj_jtr {what}: {differ} of {M} associations differ")
    bound = 1e-4 * scale + 1e-30
    assert_within(out, ref, bound, f"icp_assoc_jtj_jtr vs f64, {what}")
    if differ == 0:
        assert_within(out, plain.double(), 2 * bound, f"icp_assoc_jtj_jtr vs plain, {what}")
    ok = ~torch.isnan(ref)
    return {
        "rows": what, "M": M, "associations_differ": differ,
        "weight_sum": float(out[-1]),
        "max_abs_err_vs_plain": max_abs_err(out, plain),
        "max_err_vs_f64_over_abs_sum": float(((out.double() - ref)[ok].abs() / (scale[ok] + 1e-30)).max()),
    }, index


def kernel_icp_assoc():
    """The fused step kernel at every level of both bench rows, fresh from
    the identity and carried to a pose a little off it, then strides that do
    not divide the image and a single block, a NaN pose and a pose that sees
    nothing. Returns (checks, the record of config 3's finest level, its
    error, the records at the other main-path shapes)."""
    eye = torch.eye(4, device=DEV)
    T_off = se3_exp(torch.tensor([1e-3, -1e-3, 5e-4, 2e-3, -1e-3, 1e-3], device=DEV))
    checks, levels = [], {}
    for cfg, name in ((ICP_DENSE, "dense"), (ICP_CONFIG3, "config3")):
        src, tgt, _ = icp_scene(cfg)
        for level in range(3):
            acc, inputs = fused_level(cfg, src, tgt, level)
            levels[f"{name} level {level}"] = (acc, inputs)
            rec, index = check_icp_assoc(acc, inputs, eye, f"{name} level {level}, fresh")
            checks.append(rec)
            checks.append(check_icp_assoc(acc, inputs, T_off, f"{name} level {level}, carried",
                                          carried_over=index)[0])
        if name == "config3":
            for level, stride in ((0, 3), (2, 16)):  # 160 x 214 samples; 8 x 10, one block
                acc, inputs = fused_level(cfg, src, tgt, level, stride)
                checks.append(check_icp_assoc(acc, inputs, eye, f"level {level}, stride {stride}")[0])
    sizes = sorted({c["M"] for c in checks})
    if sizes != [80, 4800, 19200, 34240, 76800, 307200]:
        raise AssertionError(f"unexpected fused-step sizes {sizes}")

    acc, inputs = levels["config3 level 0"]
    maps, stride, intr, thr = inputs
    nan_pose = torch.full((4, 4), float("nan"), device=DEV)
    out = flat8(acc(nan_pose)[:4]).clone()
    plain = flat8(icp_assoc_jtj_jtr_reference(nan_pose, *maps, stride, intr, thr)[:4])
    if not (bool(torch.isnan(out).any()) and torch.equal(torch.isnan(out), torch.isnan(plain))
            and float(out[-1]) == 0.0):
        raise AssertionError("icp_assoc_jtj_jtr: a NaN pose does not give the plain version's NaN sums")
    checks.append({"rows": "config3 level 0, NaN pose", "nan_entries": int(torch.isnan(out).sum()),
                   "weight_sum": 0.0})
    T_far = torch.eye(4, device=DEV)
    T_far[0, 3] = 5.0  # five metres to the side: no sample lands on the target
    step = level_step(CAM, ICP_CONFIG3, *icp_scene(ICP_CONFIG3)[:2], 0)[0]
    T_new, stats, _ = step(T_far)
    if float(flat8(acc(T_far)[:4])[-1]) != 0.0 or float(stats[1]) != 0.0 or not torch.equal(T_new, T_far):
        raise AssertionError("icp_assoc_jtj_jtr: a pose that sees nothing took a step")
    checks.append({"rows": "config3 level 0, pose that sees nothing", "weight_sum": 0.0})
    # K4 between fused steps on one stream: each has its own ticket, and each
    # gives the bits it gives alone.
    rows = icp_assoc_rows_reference(eye, *source_rows(inputs), maps[2], maps[3], intr, thr)[0]
    k4_err = check_icp_jtj(*rows)
    alone = [flat8(acc(eye)[:4]).clone(), flat8(icp_jtj_jtr(*rows)).clone()]
    mixed = []
    for _ in range(2):
        mixed += [flat8(acc(eye)[:4]).clone(), flat8(icp_jtj_jtr(*rows)).clone()]
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(mixed, alone * 2)):
        raise AssertionError("the fused step and K4 interleaved on one stream differ from each alone")
    checks.append({"rows": "config3 level 0: the fused step and K4 interleaved on one stream",
                   "bit_equal_to_each_alone": True, "K4": k4_err})

    def record(key):
        acc, inputs = levels[key]
        maps, stride, intr, thr = inputs
        sv, sn = source_rows(inputs)
        src_valid = (sv[:, 2] > 0) & (torch.sum(sn * sn, dim=-1) > 0.5)
        pack = torch.cat([maps[2].reshape(-1, 3), maps[3].reshape(-1, 3)], dim=-1)
        acc(eye)
        index = acc.index.clone()
        M = index.numel()
        gathered = int(torch.unique(index[index >= 0]).numel())
        return {
            "M": M,
            "ms": time_ms(lambda: acc(eye)),
            "device_ms": device_ms_alone("icp_assoc_jtj_jtr", lambda: acc(eye)),
            "carried_ms": time_ms(lambda: acc(eye, acc.index)),
            "plain_ms": time_ms(lambda: icp_assoc_jtj_jtr_reference(eye, *maps, stride, intr, thr)),
            # The route the fused kernel replaced: the rows in PyTorch from
            # the level's prepared inputs, then K4. Not one library call.
            "unfused_ms": time_ms(lambda: icp_jtj_jtr(*icp_assoc_rows_reference(
                eye, sv, sn, maps[2], maps[3], intr, thr, src_valid=src_valid, tgt_pack=pack)[0])),
            "library_ms": None,
            # the sample's vertex and normal, the distinct target pixels it
            # gathers (both maps), the map written, T read, the 44 results
            "bytes": 24 * M + 24 * gathered + 4 * M + 64 + 4 * 44,
            "op_seconds": ASSOC_OPS * M / PEAK_F32_FLOPS,
        }

    by_size = [{"rows": key, **record(key)} for key in ("dense level 0", "dense level 2", "config3 level 1")]
    main = {
        "name": "icp_assoc_jtj_jtr",
        "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/icp_jtj.cu",
        "replaces": "rgbd_pose_estimation_tpu/ops/icp_jtj.py:173",
        "shape": "M=19200 (config 3, level 0), fresh",
        **record("config3 level 0"),
    }
    del main["M"]
    err = next(c["max_abs_err_vs_plain"] for c in checks if c["rows"] == "config3 level 0, carried")
    return checks, main, err, by_size


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


# The Horn kernels against their plain versions on the card (the reasons are
# tests/test_torch_horn_cuda.py's): the hypotheses bit for bit on every set;
# the refit's pose to 1e-5 (its block sums run in another order), its inlier
# masks and counts equal.
HORN_TOL = 1e-5
REFIT_ITERS = 12  # horn.cu's refit runs horn_quaternion's default


def horn_ops(iters):
    """f32 operations of one Horn solve from moments, counted from horn.cuh
    and horn.cu (a math function, sqrt, rsqrt, atan2, cos, sin, as one): the
    moments' centring 35, the matrix and its scaling 51, three squarings
    309, the start vectors 26, each power step 98, Rayleigh-Ritz 99, the
    pose 49."""
    return 569 + 98 * iters


def refit_ops(n, rounds):
    """f32 operations of the refit: a round's two residual passes (21 a
    row each), its weighted sums (7 a row) and covariance (27 a row), and
    one Horn solve; then the final residuals and count (22 a row)."""
    return rounds * (76 * n + horn_ops(REFIT_ITERS)) + 22 * n


def bit_equal_share(out, ref):
    return float((out.view(torch.int32) == ref.view(torch.int32)).float().mean())


def check_hypotheses_bits(mom, iters, what):
    """horn_hypotheses_kernel against horn_from_moments_reference, bit for
    bit. Returns the kernel's poses."""
    out = horn_from_moments(mom, iters)
    ref = horn_from_moments_reference(mom, iters)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"horn_hypotheses {what}: {bit_equal_share(out, ref):.4f} of the "
                             f"entries are the plain version's bits, not all")
    return out


def check_horn_hypotheses():
    """horn_hypotheses_kernel against horn_from_moments_reference, bit for
    bit: the bench problem's sets at K = 32768 and a ragged 1000, iters 4 and
    12; near-collinear sets; NaN moments; random sets ~1e4 from the origin
    (the pad sentinels' scale) and sets of the pad sentinels themselves."""
    out = {}
    g = generator(31)
    p, q, T_gt, _ = synthetic_correspondences(g, n=N, outlier_frac=0.4, noise=0.003)
    for k in (1000, K):
        mom = minimal_moments(sample_minimal_sets(g, N, k, M), p, q)
        for iters in (4, 12):
            check_hypotheses_bits(mom, iters, f"K={k} iters={iters}")
            out[f"K={k} iters={iters}"] = "bit-equal"
    # Near-collinear sets: off their line by 0.0035 of its length.
    base = torch.randn(4096, 1, 3, generator=g, device=DEV)
    direction = torch.randn(4096, 1, 3, generator=g, device=DEV)
    steps = torch.tensor([-1.0, 0.1, 1.0], device=DEV).reshape(1, 3, 1)
    P = base + steps * direction + 0.0035 * torch.randn(4096, 3, 3, generator=g, device=DEV)
    Q = P @ T_gt[:3, :3].T + T_gt[:3, 3]
    ix = torch.arange(3 * 4096, dtype=torch.int32, device=DEV).reshape(4096, 3)
    mom = minimal_moments(ix, P.reshape(-1, 3).contiguous(), Q.reshape(-1, 3).contiguous())
    T = check_hypotheses_bits(mom, 4, "near-collinear")
    out["near-collinear, 4096 sets"] = {
        "median_err_vs_truth": float((T[:, :3, :3] - T_gt[:3, :3]).abs().amax(dim=(1, 2)).median())}
    # NaN moments: a NaN pose in the same places.
    mom = minimal_moments(sample_minimal_sets(g, N, 1000, M), p, q)
    mom[:, 5] = float("nan")
    mom[7, 9] = float("nan")
    mom[15, 11] = float("nan")
    T = check_hypotheses_bits(mom, 4, "NaN moments")
    out["NaN moments"] = {"nan_poses": int(torch.isnan(T).any(2).any(1).sum())}
    # ~1e4 from the origin: random sets, and sets of the pad sentinels.
    P = 1e4 * torch.randn(1000, 3, 3, generator=g, device=DEV)
    Q = 1e4 * torch.randn(1000, 3, 3, generator=g, device=DEV)
    ix = torch.arange(3000, dtype=torch.int32, device=DEV).reshape(1000, 3)
    check_hypotheses_bits(minimal_moments(ix, P.reshape(-1, 3).contiguous(),
                                          Q.reshape(-1, 3).contiguous()), 4, "1e4 from the origin")
    pp, qq = pad_correspondences_3d3d(p[:100], q[:100], N)
    ixs = (100 + torch.rand((1000, N - 100), generator=g, device=DEV).argsort(dim=1)[:, :3])
    T = check_hypotheses_bits(minimal_moments(ixs.to(torch.int32).contiguous(), pp, qq), 4,
                              "pad sentinels")
    if not bool(torch.isfinite(T).all()):
        raise AssertionError("horn_hypotheses on pad-sentinel sets: not finite")
    out["1e4 from the origin, pad sentinels"] = "bit-equal, finite"
    return out


def check_horn_refit():
    """horn_refit_3d3d_kernel against _refit_3d3d_reference: N = 5, 2048 and
    3000 at rounds 0, 1 and 2 from a pose 0.01 off the truth; at N = 2048
    also fewer than 3 inliers (τ = 1e-5: the pose is kept) and a NaN start
    pose (a NaN pose, no inliers, not valid). Returns the cases and the
    largest pose error."""
    out, worst = {}, 0.0
    zero = torch.zeros((), device=DEV)
    for n in (5, N, 3000):
        p, q, T, _ = synthetic_correspondences(generator(40 + n), n=n, outlier_frac=0.4, noise=0.003)
        T0 = T.clone()
        T0[:3, 3] += 0.01
        cases = {f"rounds={r}": (T0, TAU, r) for r in (0, 1, 2)}
        if n == N:
            cases["fewer than 3 inliers"] = (T0, 1e-5, 2)
            cases["NaN start pose"] = (T0 * float("nan"), TAU, 2)
        for name, (start, tau, rounds) in cases.items():
            cfg = RansacConfig(threshold=tau, refit_rounds=rounds)
            a = _refit_3d3d(start, zero, p, q, cfg, 1)
            b = _refit_3d3d_reference(start, zero, p, q, cfg, 1)
            err = max_abs_err(a.pose, b.pose) if not bool(torch.isnan(b.pose).all()) else 0.0
            kept = rounds == 0 or tau < 1e-3
            if (not err <= HORN_TOL or not torch.equal(a.inlier_mask, b.inlier_mask)
                    or float(a.num_inliers) != float(b.num_inliers) or bool(a.valid) != bool(b.valid)
                    or (kept and not torch.equal(a.pose, start))
                    or (name == "NaN start pose" and (float(a.num_inliers) != 0 or bool(a.valid)
                                                     or not bool(torch.isnan(a.pose).all())))):
                raise AssertionError(f"horn_refit_3d3d N={n} {name}: pose err {err}, inliers "
                                     f"{float(a.num_inliers)} vs {float(b.num_inliers)}, valid "
                                     f"{bool(a.valid)} vs {bool(b.valid)}")
            out[f"N={n} {name}"] = {"max_abs_err": err, "num_inliers": float(a.num_inliers),
                                    "valid": bool(a.valid), "bit_equal": bit_equal_share(a.pose, b.pose)}
            worst = max(worst, err)
    return out, worst


def config2():
    """The RANSAC settings of config 2, through the port's loader."""
    cfg = load_yaml_config(_ROOT / "configs" / "config2_ransac_pnp_pair.yaml").ransac
    if (cfg.num_hypotheses, cfg.threshold) != (K2D, 0.01):
        raise AssertionError(f"config 2 is not K={K2D}, threshold 0.01: {cfg}")
    return cfg


def bench_row_2d3d(n=N2D):
    """The bench's 2D-3D problem: the bench's 3D points moved 4 units down
    the optical axis, observed exactly (no noise, no outliers) from the
    bench's pose; the first ``n`` of 2048 rows. Returns (points, obs, T_gt)."""
    p, _, T_gt, _ = synthetic_correspondences(
        generator(0), n=N, outlier_frac=0.4, noise=0.003
    )
    pts = p.clone()
    pts[:, 2] += 4.0
    Xc = se3_apply(T_gt, pts)
    obs = Xc[:, :2] / Xc[:, 2:3]
    return pts[:n].contiguous(), obs[:n].contiguous(), T_gt


def root_poses(seed, k, pts, obs):
    """What the 2D-3D estimator hands K5 for ``k`` minimal samples."""
    idx = sample_minimal_sets(generator(seed), pts.shape[0], k, 3)
    return _pack_root_poses(*p3p(*_minimal_rays(idx, pts, obs)))


def check_score2d(P, pts, obs, tau):
    """K5 against its plain version and against float64 of the same inputs.

    Scores: |kernel − ref| ≤ 0.5·τ². A score is a sum of N terms ≤ τ², and
    min(e, τ²) is continuous in e, so what separates the three is rounding
    alone: kernel and plain version project differently (a reciprocal and a
    product with fused multiply-adds in the kernel, a library product and a
    division in the plain version), which moves a term e ≤ τ² by about
    2·τ·|proj|·1e-7, i.e. N = 2048 of them by at most 0.4·τ² if every
    rounding pointed the same way (measured: thousands of times less).
    Counts: an error within rounding of τ² may change side, so a pose's count
    may differ by 1, on at most 0.1% of the poses. The plain version is held
    to float64 by the same bounds. NaN must sit where float64 has it, and a
    second run must give the same bits. Returns the largest score errors in
    units of τ² and the number of poses whose count differs."""
    tau2 = tau * tau
    m, c = rs.score_poses_2d3d(P, pts, obs, tau)
    m2, c2 = rs.score_poses_2d3d(P, pts, obs, tau)
    m_plain, c_plain = chunked(
        lambda t: rs.score_poses_2d3d_reference(t, pts, obs, tau), P)
    m64, c64 = chunked(
        lambda t: rs.score_poses_2d3d_reference(t.double(), pts.double(), obs.double(), tau),
        P, 2048)
    torch.cuda.synchronize()
    what = f"score_poses_2d3d K={P.shape[0]} N={pts.shape[0]}"
    if not (torch.equal(m.view(torch.int32), m2.view(torch.int32)) and torch.equal(c, c2)):
        raise AssertionError(f"{what}: two runs on the same input differ")
    if bool(torch.isnan(c).any()):
        raise AssertionError(f"{what}: a count is NaN")
    out = {}
    for name, (ma, ca), (mb, cb) in (
        ("vs_plain", (m, c), (m_plain, c_plain)),
        ("vs_f64", (m, c), (m64, c64)),
        ("plain_vs_f64", (m_plain, c_plain), (m64, c64)),
    ):
        assert_close(ma, mb, 0.0, 0.5 * tau2, f"{what} msac {name}")
        diff = (ca.double() - cb.double()).abs()
        if float(diff.max()) > 1 or float((diff > 0).double().mean()) > 1e-3:
            raise AssertionError(
                f"{what} counts {name}: max diff {float(diff.max())}, "
                f"{int((diff > 0).sum())} of {diff.numel()} poses differ")
        out[f"max_err_{name}_tau2"] = max_abs_err(ma, mb) / tau2
        out[f"counts_differ_{name}"] = int((diff > 0).sum())
    out["max_abs_err"] = max_abs_err(m, m_plain)
    return out


def check_reciprocal():
    """K5's reciprocal: the kernel takes rcp_rn_normal(z) for 1.f / z on
    normal depths below 2^126. Both on every positive normal float below
    2^126, bit for bit: not one may differ."""
    first, end = 0x00800000, 0x7E800000  # bits of 2^-126 and of 2^126
    blocks = 132 * 16
    per_block = torch.empty(blocks, dtype=torch.int32, device=DEV)
    _build.launch("msac_reciprocal_check", first, end - first, per_block.data_ptr(), blocks)
    differ = int(per_block.sum())
    if differ:
        raise AssertionError(f"rcp_rn_normal differs from 1.f / x on {differ} floats")
    return {"floats": end - first, "differ": differ}


def kernel_score2d():
    """K5 at the main path's shape (8192 root poses x 1024 rows), at the
    large shape, at ragged shapes with and without pad rows, from packed and
    matrix input, with NaN poses, with every point behind the camera and with
    depths of 2^126 and more; and its reciprocal on every float it may take.
    Returns (checks, the main-path record, its error, the large record)."""
    tau = config2().threshold
    pts, obs, _ = bench_row_2d3d()
    P = root_poses(13, K2D, pts, obs)
    P[3] = float("nan")  # a degenerate sample's outcome
    P[11, 9] = float("nan")  # one NaN entry is enough
    checks = [{"shape": f"K={4 * K2D} N={N2D}", **check_score2d(P, pts, obs, tau)}]
    m, c = rs.score_poses_2d3d(P, pts, obs, tau)
    if not bool(torch.isnan(m[[3, 11]]).all()) or float(c[3]) != 0.0:
        raise AssertionError("score_poses_2d3d: a NaN pose does not score NaN with count 0")
    if int(c.max()) < N2D - 2:
        raise AssertionError("score_poses_2d3d: no root pose explains the exact observations")

    # Matrix input is packed by the wrapper: the same bits as packed input
    # of the same K (K picks the kernel's layout, and with it the order in
    # which a pose's N terms are summed).
    T44 = rt_to_matrix(P[:64, :9].reshape(64, 3, 3), P[:64, 9:12])
    m44, c44 = rs.score_poses_2d3d(T44, pts, obs, tau)
    m64, c64 = rs.score_poses_2d3d(P[:64].contiguous(), pts, obs, tau)
    if not (torch.equal(m44.view(torch.int32), m64.view(torch.int32))
            and torch.equal(c44, c64)):
        raise AssertionError("score_poses_2d3d: (K, 4, 4) and packed input differ")
    checks.append({"shape": "(64, 4, 4) input", "max_abs_err": 0.0})

    # Ragged: K = 1000 poses, N = 200 rows; then 56 pad rows behind the
    # camera, which must add exactly 56 tau^2 and no inlier; K = 1, N = 1.
    # Contaminated observations spread the errors over both sides of tau^2.
    rp, ro, _ = contaminated_2d3d(17, 200)
    R = root_poses(14, 250, rp, ro)
    checks.append({"shape": "K=1000 N=200", **check_score2d(R, rp, ro, tau)})
    pp, po = pad_points_obs_2d3d(rp, ro, 256)
    checks.append({"shape": "K=1000 N=256 (56 pad rows)", **check_score2d(R, pp, po, tau)})
    (m0, c0), (m1, c1) = rs.score_poses_2d3d(R, rp, ro, tau), rs.score_poses_2d3d(R, pp, po, tau)
    assert_close(m1, m0 + 56 * tau * tau, 1e-5, 0.0, "score_poses_2d3d pad rows")
    if not torch.equal(c0, c1):
        raise AssertionError("score_poses_2d3d: a pad row was counted as an inlier")
    checks.append({"shape": "K=1 N=1", **check_score2d(R[:1], rp[:1], ro[:1], tau)})
    # Pose-stationary (K > 1024) at N = 3001: more than one 256-row tile,
    # and not a multiple of one; K = 2000 is not a multiple of 32.
    tp, to, _ = contaminated_2d3d(18, 3001)
    checks.append({"shape": "K=2000 N=3001",
                   **check_score2d(root_poses(19, 500, tp, to), tp, to, tau)})

    # Every point behind the camera: tau^2 each, no inlier, whatever obs says.
    eye = rs.pack_poses(torch.eye(4, device=DEV)[None]).repeat(300, 1)
    back = torch.zeros((77, 3), device=DEV)
    back[:40, 2] -= 1.0  # depth -1, and depth 0 for the rest
    mb, cb = rs.score_poses_2d3d(eye, back, torch.zeros((77, 2), device=DEV), tau)
    assert_close(mb, torch.full_like(mb, 77 * tau * tau), 1e-6, 0.0, "score_poses_2d3d behind")
    if float(cb.max()) != 0.0:
        raise AssertionError("score_poses_2d3d: a point behind the camera was counted")
    checks.append({"shape": "K=300 N=77, all behind the camera", "max_abs_err": 0.0})

    # Depths of 2^126 and more, up to the largest float, beside ordinary ones
    # (48 rows, so that a lane's group of four rows mixes them): the kernel's
    # exact division of such a group, under both layouts. (An infinite depth
    # would make both versions NaN: the rotation's zeros times inf.)
    far = torch.tensor([[0.5, -0.25, 2.0**126], [1.0, 1.0, 3e38], [-2.0, 1.0, 3.4028234e38],
                        [0.1, 0.2, 1e30], [0.3, -0.1, 4.0], [0.2, 0.1, 2.0**125]], device=DEV)
    far_obs = torch.tensor([[0.001, 0.0], [0.5, 0.5], [0.0, 0.002], [0.0, 0.0],
                            [0.075, -0.025], [0.2, 0.0]], device=DEV)
    for k in (300, 2000):
        P_far = eye.new_zeros((k, 12))
        P_far[:] = eye[0]
        checks.append({"shape": f"K={k} N=48, depths up to 3.4e38",
                       **check_score2d(P_far, far.repeat(8, 1), far_obs.repeat(8, 1), tau)})
    checks.append({"reciprocal": "rcp_rn_normal vs 1.f / x", **check_reciprocal()})

    # The large case: 131072 poses x 2048 rows.
    lp, lo, _ = bench_row_2d3d(N)
    L = root_poses(15, K2D_LARGE, lp, lo)
    L[5] = float("nan")
    large_check = check_score2d(L, lp, lo, tau)
    checks.append({"shape": f"K={4 * K2D_LARGE} N={N}", **large_check})

    def record(poses, points, observations, inner):
        k, n = poses.shape[0], points.shape[0]
        alone = [{"name": "score_poses_2d3d", "device_ms": None}]
        set_device_ms(alone, profile_device(
            lambda: [rs.score_poses_2d3d(poses, points, observations, tau) for _ in range(20)]))
        return {
            "shape": f"K={k} poses N={n}",
            "ms": time_ms(lambda: rs.score_poses_2d3d(poses, points, observations, tau),
                          inner=inner),
            "device_ms_alone": alone[0]["device_ms"],
            "plain_ms": time_ms(
                lambda: chunked(
                    lambda t: rs.score_poses_2d3d_reference(t, points, observations, tau), poses),
                reps=10, inner=1, warmup=1),
            # No single PyTorch call computes it: a perspective division sits
            # between the product and the reduction.
            "library_ms": None,
            # poses read once, both results written once; points and obs once
            "bytes": 4 * (14 * k + 5 * n),
            "op_seconds": 26 * k * n / PEAK_F32_FLOPS,
        }

    main = {
        "name": "score_poses_2d3d",
        "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/score2d.cu",
        "replaces": "rgbd_pose_estimation_tpu/ops/ransac_score.py:473",
        **record(P, pts, obs, 5),
    }
    large = record(L, lp, lo, 1)
    large["max_abs_err"] = large_check["max_abs_err"]
    return checks, main, checks[0]["max_abs_err"], large


def contaminated_2d3d(seed, n, outlier_frac=0.3):
    """A 2D-3D problem with gross outliers (the JAX package's
    TestRansac2D3D): a camera about 4 units from points in [-1.5, 1.5]^3,
    exact observations, ``outlier_frac`` of them replaced by uniform draws in
    [-1, 1]^2. Returns (points, obs, T_gt)."""
    g = generator(seed)
    T = se3_exp(torch.randn(6, generator=g, device=DEV) * 0.4)
    T[2, 3] += 4.0
    pts = torch.rand((n, 3), generator=g, device=DEV) * 3.0 - 1.5
    Xc = se3_apply(T, pts)
    obs = Xc[:, :2] / Xc[:, 2:3]
    out = torch.rand(n, generator=g, device=DEV) < outlier_frac
    junk = torch.rand((n, 2), generator=g, device=DEV) * 2.0 - 1.0
    return pts, torch.where(out[:, None], junk, obs).contiguous(), T


def phase_kernels():
    """Returns the per-kernel records of the main-path shapes, and the exact
    MSAC scorers' rows (K3, K5) for :func:`phase_exact_msac`."""
    checks = []
    # Ragged shapes: K not a multiple of 256, N not a multiple of 128 (the
    # scorers see N = 200 unpadded here, and the sentinel-padded 256 below).
    idx, pp, qq, T = hypotheses(11, 1000, 200)
    checks.append({
        "shape": "K=1000 N=200",
        "minimal_moments": check_moments(idx, pp[:200].contiguous(), qq[:200].contiguous()),
        "minimal_moments by m": check_moments_by_m(),
        "score_poses_3d3d_quad_fused": check_quad(T, pp[:200].contiguous(), qq[:200].contiguous()),
        "score_poses_3d3d": check_exact(T, pp[:200].contiguous(), qq[:200].contiguous()),
    })
    checks.append({
        "shape": "K=1000 N=256 (56 pad sentinels)",
        "score_poses_3d3d_quad_fused": check_quad(T, pp, qq),
        "score_poses_3d3d": check_exact(T, pp, qq),
    })
    # K3's two layouts (one pose a block up to K = 1024, pose-stationary
    # above) at N = 3001: more than one 256-row tile, and not a multiple of
    # one; K = 2000 is not a multiple of a block's 32 P poses. Then K = N = 1.
    _, pr, qr, Tr = hypotheses(16, 2000, 3001)
    pr, qr = pr[:3001].contiguous(), qr[:3001].contiguous()
    for k in (1000, 2000):
        checks.append({"shape": f"K={k} N=3001", "score_poses_3d3d": check_exact(Tr[:k], pr, qr)})
    checks.append({"shape": "K=1 N=1", "score_poses_3d3d": check_exact(Tr[:1], pr[:1], qr[:1])})

    # Main-path shapes.
    idx, p, q, T = hypotheses(12, K, N)
    mom = minimal_moments(idx, p, q)
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
    checks.append({"shape": f"K={K} N={N}", **err, "score_poses_3d3d[all K]": err_exact_all,
                   "best_pose_3d3d winner, tensor-core vs CUDA-core K2": check_quad_winner(T, p, q)})
    horn_checks = check_horn_hypotheses()
    err["horn_hypotheses"] = 0.0  # bit for bit
    refit_checks, err["horn_refit_3d3d"] = check_horn_refit()
    checks.append({"horn_hypotheses": horn_checks, "horn_refit_3d3d": refit_checks})
    # The refit starts from the estimator's winner, as in an estimate.
    _, _, T_start = rs.best_pose_3d3d(T, p, q, TAU, return_pose=True)
    zero = torch.zeros((), device=DEV)

    tau2 = TAU * TAU
    f32 = PEAK_F32_FLOPS
    records = [
        {
            "name": "minimal_moments",
            "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/moments.cu",
            "replaces": "rgbd_pose_estimation_tpu/ops/moments.py:110",
            "ms": time_ms(lambda: minimal_moments(idx, p, q)),
            "device_ms_alone": device_ms_alone("minimal_moments", lambda: minimal_moments(idx, p, q)),
            # The floor of its launch: as many blocks that do nothing.
            "empty_kernel_device_ms": device_ms_alone(
                "empty_kernel", lambda: ceilings.empty_kernel(-(-K // K1_THREADS))),
            "plain_ms": time_ms(lambda: minimal_moments_reference(idx, p, q)),
            "library_ms": None,
            "bytes": 4 * (M * K + 16 * K) + 24 * N,
            "op_seconds": 24 * M * K / f32,
        },
        {
            "name": "score_poses_3d3d_quad_fused",
            "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/quad_bf16_mma.cu",
            "replaces": "rgbd_pose_estimation_tpu/ops/ransac_score.py:279",
            "ms": time_ms(lambda: rs._quad_scores(feat, pn, TAU)),
            "device_ms_alone": device_ms_alone(
                "score_poses_3d3d_quad_fused", lambda: rs._quad_scores(feat, pn, TAU)),
            # K2's CUDA-core design, on the same operands in the same run.
            "cuda_core_design_ms": time_ms(lambda: mv.quad_fused_cuda_cores(feat, pn, TAU)),
            "cuda_core_design_device_ms_alone": device_ms_alone(
                "quad_fused_cuda_cores", lambda: mv.quad_fused_cuda_cores(feat, pn, TAU)),
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
            "device_ms_alone": device_ms_alone(
                "score_poses_3d3d", lambda: rs._score_packed(packed_top, p, q, TAU)),
            # The floor of its launch: as many blocks that do nothing.
            "empty_kernel_device_ms": device_ms_alone(
                "empty_kernel", lambda: ceilings.empty_kernel(top)),
            "plain_ms": time_ms(lambda: rs._score_packed_reference(packed_top, p, q, TAU)),
            "library_ms": None,
            "bytes": 4 * (12 * top + 6 * N + 2 * top),
            "op_seconds": 23 * top * N / f32,
        },
        {
            "name": "horn_hypotheses",
            "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/horn.cu",
            "replaces": None,  # jnp code that XLA fuses: solvers/absolute_orientation.py
            "shape": f"K={K}, iters=4",
            "ms": time_ms(lambda: horn_from_moments(mom, 4)),
            "device_ms_alone": device_ms_alone("horn_hypotheses", lambda: horn_from_moments(mom, 4)),
            # The floor of its launch: as many blocks that do nothing.
            "empty_kernel_device_ms": device_ms_alone(
                "empty_kernel", lambda: ceilings.empty_kernel(-(-K // HORN_THREADS))),
            "plain_ms": time_ms(lambda: horn_from_moments_reference(mom, 4), reps=10, inner=1),
            "library_ms": None,
            "bytes": 4 * (16 * K + 16 * K),
            "op_seconds": horn_ops(4) * K / f32,
        },
        {
            "name": "horn_refit_3d3d",
            "source": "rgbd_pose_estimation_tpu_torch/ops/csrc/horn.cu",
            "replaces": None,  # the refit scan of ransac/engine.py::estimate_pose_3d3d
            "shape": f"N={N}, rounds={CFG.refit_rounds}",
            "ms": time_ms(lambda: _refit_3d3d(T_start, zero, p[:N], q[:N], CFG, K)),
            "device_ms_alone": device_ms_alone(
                "horn_refit_3d3d", lambda: _refit_3d3d(T_start, zero, p[:N], q[:N], CFG, K)),
            "plain_ms": time_ms(
                lambda: _refit_3d3d_reference(T_start, zero, p[:N], q[:N], CFG, K), reps=10, inner=1),
            "library_ms": None,
            # p and q once, the start pose, the pose, mask, count and validity.
            "bytes": 24 * N + 64 + 64 + N + 4 + 1,
            "op_seconds": refit_ops(N, CFG.refit_rounds) / f32,
        },
    ]
    icp_checks, icp_record, err["icp_jtj_jtr"], icp_by_size = kernel_icp_jtj()
    checks += icp_checks
    records.append(icp_record)
    assoc_checks, assoc_record, err["icp_assoc_jtj_jtr"], assoc_by_size = kernel_icp_assoc()
    checks += assoc_checks
    records.append(assoc_record)
    s2d_checks, s2d_record, err["score_poses_2d3d"], s2d_large = kernel_score2d()
    checks += s2d_checks
    records.append(s2d_record)
    for rec in records + icp_by_size + assoc_by_size + [s2d_large]:
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
        "device_ms_alone": device_ms_alone(
            "score_poses_3d3d", lambda: rs.score_poses_3d3d(T, p, q, TAU)),
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
         icp_jtj_jtr_by_size=icp_by_size, icp_assoc_jtj_jtr_by_size=assoc_by_size,
         score_poses_2d3d_large=s2d_large)
    finalists = next(r for r in records if r["name"] == "score_poses_3d3d")
    exact_rows = [
        {"row": f"K3 K={top} finalists x N={N}", "device_ms": finalists["device_ms_alone"],
         "ops": 23 * top * N},
        {"row": f"K3 K={K} x N={N}", "device_ms": exact_all["device_ms_alone"], "ops": 23 * K * N},
        {"row": f"K5 K={4 * K2D} x N={N2D}", "device_ms": s2d_record["device_ms_alone"],
         "ops": 26 * 4 * K2D * N2D},
        {"row": f"K5 K={4 * K2D_LARGE} x N={N}", "device_ms": s2d_large["device_ms_alone"],
         "ops": 26 * 4 * K2D_LARGE * N},
    ]
    return records, exact_rows


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


ESTIMATE_KERNELS = ("minimal_moments", "horn_hypotheses", "score_poses_3d3d_quad_fused",
                    "score_poses_3d3d", "horn_refit_3d3d")


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


def normals_problem(seed, n, outlier_frac=0.7):
    """Point+normal correspondences under one pose with gross outliers (the
    JAX package's TestRansacNormals at size ``n``): outlier rows get a random
    target point in [-2, 2]^3 and a random target normal."""
    g = generator(seed)

    def unit(shape):
        v = torch.randn(shape, generator=g, device=DEV)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    T = se3_exp(torch.randn(6, generator=g, device=DEV) * 0.5)
    p = torch.randn((n, 3), generator=g, device=DEV)
    n_p = unit((n, 3))
    q = se3_apply(T, p)
    n_q = n_p @ T[:3, :3].T
    out = (torch.rand(n, generator=g, device=DEV) < outlier_frac)[:, None]
    q = torch.where(out, torch.rand((n, 3), generator=g, device=DEV) * 4.0 - 2.0, q)
    n_q = torch.where(out, unit((n, 3)), n_q)
    return p, q.contiguous(), n_p, n_q.contiguous(), T


def expect_launches(counts, expected, what):
    """``counts`` must show exactly ``expected`` (name → launches) and no
    launch of any other kernel; a kernel missing from ``counts`` (a dict of
    the launched kernels only) was launched 0 times."""
    names = set(counts) | set(expected)
    if any(counts.get(name, 0) != expected.get(name, 0) for name in names):
        want = {name: expected.get(name, 0) for name in sorted(names)}
        raise AssertionError(f"{what}: kernel launches {counts}, expected {want}")


def phase_estimate_2d3d():
    """Config 2's estimator at its full size, nothing cut: five
    requests on the bench's clean row, one on a contaminated problem of the
    same size, the adaptive wrapper, and the point+normal estimator. Returns
    the launch counts of the five requests (the main path) and the clean row."""
    cfg = config2()
    pts, obs, T_gt = bench_row_2d3d()
    # Warm-up request: builds the PROSAC windows (a host loop, cached) and
    # loads every PyTorch kernel the path uses.
    pose_error(estimate_pose_2d3d(generator(1), pts, obs, cfg, refine_iters=8), T_gt)
    torch.cuda.synchronize()

    requests = 5
    times, errs = [], []
    _build.reset_launch_counts()
    for i in range(requests):
        g = generator(200 + i)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = estimate_pose_2d3d(g, pts, obs, cfg, refine_iters=8)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
        errs.append(pose_error(res, T_gt))
        if res.num_hypotheses != 4 * K2D or res.inlier_mask.shape != (N2D,):
            raise AssertionError("estimate_pose_2d3d: wrong hypothesis count or mask shape")
    counts = _build.launch_counts()
    expect_launches(counts, {"score_poses_2d3d": requests}, "five 2D-3D estimates")
    ms = statistics.median(times)

    # The same estimator under PyTorch's synchronisation check: any call of
    # its own that waits for the device raises.
    torch.cuda.set_sync_debug_mode("error")
    try:
        res_nosync = estimate_pose_2d3d(generator(206), pts, obs, cfg, refine_iters=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pose_error(res_nosync, T_gt)

    # The bench row has neither outliers nor noise: 30% gross outliers.
    cp, co, cT = contaminated_2d3d(23, N2D)
    _build.reset_launch_counts()
    res_c = estimate_pose_2d3d(generator(207), cp, co, cfg, refine_iters=8)
    err_c = pose_error(res_c, cT)
    expect_launches(_build.launch_counts(), {"score_poses_2d3d": 1}, "contaminated 2D-3D estimate")

    # Adaptive: on the clean row the probe meets the bound and the full round
    # never runs; num_hypotheses counts the probe's roots.
    _build.reset_launch_counts()
    res_a = estimate_pose_2d3d_adaptive(generator(208), pts, obs, cfg)
    err_a = pose_error(res_a, T_gt)
    probe = max(cfg.probe_hypotheses, 64)
    if res_a.num_hypotheses != 4 * probe:
        raise AssertionError(f"2D-3D adaptive scored {res_a.num_hypotheses}, expected {4 * probe}")
    expect_launches(_build.launch_counts(), {"score_poses_2d3d": 1}, "adaptive 2D-3D estimate")

    # Point+normal samples: gathers, the 2-point solver, then the 3D-3D
    # estimator's ranking (K2), finalists (K3) and refit.
    ncfg = RansacConfig(num_hypotheses=K2D, threshold=TAU, sample_size=2)
    p, q, n_p, n_q, nT = normals_problem(29, N)
    estimate_pose_3d3d_normals(generator(209), p, q, n_p, n_q, ncfg)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    res_n = estimate_pose_3d3d_normals(generator(210), p, q, n_p, n_q, ncfg)
    stop.record()
    stop.synchronize()
    err_n = pose_error(res_n, nT)
    if err_n >= NORMALS_TOL:
        raise AssertionError(f"point+normal estimate: pose error {err_n} >= {NORMALS_TOL}")
    expect_launches(
        _build.launch_counts(),
        {"score_poses_3d3d_quad_fused": 1, "score_poses_3d3d": 1, "horn_refit_3d3d": 1},
        "point+normal estimate",
    )

    emit(
        "estimate_2d3d", K=K2D, poses_scored=4 * K2D, N=N2D, requests=requests,
        threshold=cfg.threshold, prosac=cfg.prosac, refine_iters=8,
        ms_per_estimate=ms, ms_samples=times,
        ransac_hypotheses_per_s=4 * K2D / (ms * 1e-3),
        pose_max_err=max(errs), num_inliers=float(res.num_inliers),
        launches_per_estimate={k: v / requests for k, v in counts.items()},
        no_sync_pose_max_err=pose_error(res_nosync, T_gt),
        contaminated={"outlier_frac": 0.3, "pose_max_err": err_c,
                      "num_inliers": float(res_c.num_inliers)},
        adaptive={"num_hypotheses": res_a.num_hypotheses, "pose_max_err": err_a},
        normals={"K": K2D, "N": N, "outlier_frac": 0.7, "pose_max_err": err_n,
                 "num_inliers": float(res_n.num_inliers),
                 "ms_per_estimate": start.elapsed_time(stop)},
    )
    return counts, (pts, obs, T_gt, ms)


def phase_stages_2d3d(pts, obs, ms_per_estimate, records):
    """Where a 2D-3D estimate's time goes: each layer alone and synchronous,
    through the functions the engine calls, then one estimate under the
    profiler for the device's side of it. K5's record gets its time on the
    device inside that estimate."""
    cfg = config2()
    tau = cfg.threshold
    g = generator(7)
    idx = sample_minimal_sets(g, N2D, K2D, 3)

    def gather():
        return _minimal_rays(sample_minimal_sets(g, N2D, K2D, 3), pts, obs)

    pm, rays = gather()
    T_roots, valid = p3p(pm, rays)

    def score():
        return _best_root_pose(
            _pack_root_poses(T_roots, valid), valid.reshape(-1), pts, obs, tau)[0]

    T_best = score()
    w = torch.ones(N2D, device=DEV)
    stages = {
        "sample_minimal_sets + gather + rays": gather,
        "p3p (quartic + Horn on (2048, 4) root sets)": lambda: p3p(pm, rays),
        "pack + score_poses_2d3d (K5) + argmin + winner": score,
        "pnp_refine, 8 steps": lambda: pnp_refine(T_best, pts, obs, weights=w, iters=8),
        "everything after the sampler": lambda: _estimate_2d3d_from_samples(idx, pts, obs, cfg, 8),
    }
    out = {name: time_ms(fn, reps=20, inner=1, warmup=2) for name, fn in stages.items()}

    rows = profile_device(lambda: estimate_pose_2d3d(generator(8), pts, obs, cfg, refine_iters=8))
    rec = next(r for r in records if r["name"] == "score_poses_2d3d")
    rec["device_ms"] = None
    set_device_ms([rec], rows)
    prof = device_summary(rows)
    if prof["device_busy_ms"] is not None:
        prof["ms_per_estimate"] = ms_per_estimate
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / ms_per_estimate
        prof["score_poses_2d3d_device_ms"] = rec["device_ms"]
        if rec["device_ms"] is not None:
            prof["score_poses_2d3d_share_of_estimate"] = rec["device_ms"] / ms_per_estimate
    emit("stages_2d3d", K=K2D, N=N2D, synchronous_ms=out, profiled_estimate=prof)


def track_once(cam, cfg, src, tgt, T_gt, launches):
    """One track from identity: the bench's accuracy gate, the launch
    counters (``launches``: kernel name → launches expected, every other
    kernel none), and the same bits from a second run. Returns the pose
    error, the stats and the counts."""
    eye = torch.eye(4, device=DEV)
    _build.reset_launch_counts()
    T, stats = icp_track(cam, cfg, eye, src, tgt)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    expect_launches(counts, launches, "icp_track")
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
    return err, stats.tolist(), counts


def phase_icp_track():
    """The two dense-ICP rows of the bench at 640x480, three levels: each
    track launches the fused step kernel once a Gauss-Newton step and K4 not
    at all; then a short run of each branch of the step that still goes
    through K4 (photometric rows, bilinear association) at 160x120. Each
    track also gives the launches on the device and the busy time of one
    track under the profiler, and the CUDA-graph slope of chained tracks (the
    device time without the host's launching). Returns ms per track by
    setting and K4's launches (its path, the photometric and bilinear tracks,
    each counted from zero)."""
    from rgbd_pose_estimation_tpu_torch.tools.roofline import timeit_chain

    eye = torch.eye(4, device=DEV)
    out, ms_by_name = {}, {}
    for name, cfg in (("dense", ICP_DENSE), ("config3", ICP_CONFIG3)):
        src, tgt, T_gt = icp_scene(cfg)
        steps = STEPS_PER_TRACK[name]
        err, stats, _ = track_once(CAM, cfg, src, tgt, T_gt, {"icp_assoc_jtj_jtr": steps})
        ms = time_ms(lambda: icp_track(CAM, cfg, eye, src, tgt), reps=9, inner=1, warmup=1)
        ms_by_name[name] = ms
        fused = device_summary(profile_device(lambda: icp_track(CAM, cfg, eye, src, tgt)))
        out[name] = {
            "source_stride": cfg.source_stride, "reassoc_every": cfg.reassoc_every,
            "iters_per_level": cfg.iters_per_level, "icp_assoc_jtj_jtr_launches": steps,
            "pose_max_err": err, "stats": stats,
            "ms_per_track": ms, "frames_per_s": 1e3 / ms,
            "device_launches_per_track": fused["cuda_kernel_launches"],
            "unfused_route_device_launches_per_track": UNFUSED_LAUNCHES_PER_TRACK.get(name),
            "device_busy_ms": fused["device_busy_ms"],
            "graph_ms_per_track": 1e3 * timeit_chain(
                lambda T: icp_track(CAM, cfg, T, src, tgt)[0], eye, n1=2, n2=12),
        }
    small = CAM.scaled(0.25)
    k4_counts = {}
    for name, cfg, intensity in (
        ("photometric_160x120", IcpConfig(photometric_weight=0.5), True),
        ("bilinear_160x120", IcpConfig(association="bilinear"), False),
    ):
        src, tgt, T_gt = icp_scene(cfg, small, intensity)
        err, stats, counts = track_once(small, cfg, src, tgt, T_gt,
                                        {"icp_jtj_jtr": sum(cfg.iters_per_level)})
        prof = profile_device(lambda: icp_track(small, cfg, eye, src, tgt))
        on_device = device_summary(prof)
        out[name] = {
            "pose_max_err": err, "stats": stats, "icp_jtj_jtr_launches": counts["icp_jtj_jtr"],
            "device_launches_per_track": on_device["cuda_kernel_launches"],
            "k4_device_kernels_per_track": sum(r[1] for r in prof if DEVICE_NAMES["icp_jtj_jtr"][0] in r[0]),
            "device_busy_ms": on_device["device_busy_ms"],
            "graph_ms_per_track": 1e3 * timeit_chain(
                lambda T: icp_track(small, cfg, T, src, tgt)[0], eye, n1=2, n2=12),
        }
        for k, v in counts.items():
            k4_counts[k] = k4_counts.get(k, 0) + v
    emit("icp_track", width=CAM.width, height=CAM.height, levels=3, **out)
    return ms_by_name, k4_counts


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
    expect_launches(main["counts"], {"icp_assoc_jtj_jtr": tracked * STEPS_PER_TRACK["config3"]},
                    f"odometry over {tracked} tracked frames")
    emit(
        "odometry", frames=frames, width=CAM.width, height=CAM.height,
        icp=vars(cfg.icp), keyframe=vars(cfg.keyframe),
        runs={name: {"frames_per_s": r["frames_per_s"], "keyframes": len(r["odo"].keyframes),
                     "center_err_m": r["center_err_m"], "rotation_err": r["rotation_err"],
                     "max_diff_vs_process": r["max_diff_vs_process"]}
              for name, r in runs.items()},
        icp_assoc_jtj_jtr_launches_per_frame=main["counts"]["icp_assoc_jtj_jtr"] / frames,
        stream_vs_process_one_keyframe=strict,
    )
    return main["counts"]


# Substring of each hand-written kernel's name in a profiler trace.
DEVICE_NAMES = {
    "minimal_moments": ("minimal_moments_kernel",),
    "horn_hypotheses": ("horn_hypotheses_kernel",),
    "horn_refit_3d3d": ("horn_refit_3d3d_kernel",),
    "score_poses_3d3d_quad_fused": ("quad_bf16_mma_kernel",),
    "quad_fused_cuda_cores": ("quad_score_kernel",),
    "score_poses_3d3d": ("Residual3D3D",),
    "icp_jtj_jtr": ("icp_jtj_kernel",),
    "icp_assoc_jtj_jtr": ("icp_assoc_kernel",),
    "score_poses_2d3d": ("Residual2D3D",),
    "variant_A": ("Residual3D3D",),
    "variant_C": ("quad_score_kernel",),
    "variant_M": ("quad_mma_kernel",),
    "variant_E_ceiling": ("op_mix_kernel",),
    "variant_D": ("Residual3D3D",),
    "ceiling_vpu": ("fma_chain_kernel",),
    "empty_kernel": ("empty_kernel",),
}


def profile_device(fn, host_ops=True):
    """Run ``fn`` once under the profiler. Returns (kernel name, launches,
    device microseconds) of everything that ran on the card; empty where the
    profiler cannot trace it. ``host_ops=False`` traces the card alone,
    which costs the host less."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
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


def device_ms_alone(name, fn, n=20):
    """Device time of one call of kernel ``name``'s wrapper, from ``n`` calls
    under the profiler; None where the profiler sees no device time."""
    rec = [{"name": name, "device_ms": None}]
    set_device_ms(rec, profile_device(lambda: [fn() for _ in range(n)]))
    return rec[0]["device_ms"]


def phase_stages(p, q, records, track_ms):
    """Where an estimate's time goes: each layer alone, synchronous, through
    the same public functions the engine calls (it is eager PyTorch around
    the three kernels, so most of this is the launching of small kernels).
    Then one estimate and one config-3 track under the profiler, for the
    device's side of them; each record of the estimate's kernels gets its
    kernel's time on the device there (``device_ms``, None where the profiler
    saw no device activity; the ICP kernels' records have their own, taken
    alone at the record's shape)."""
    g = generator(7)
    idx = sample_minimal_sets(g, N, K, M)
    mom = minimal_moments(idx, p, q)
    T = horn_from_moments(mom, iters=4)
    _, _, T_start = rs.best_pose_3d3d(T, p, q, TAU, return_pose=True)
    zero = torch.zeros((), device=DEV)
    stages = {
        "sample_minimal_sets": lambda: sample_minimal_sets(g, N, K, M),
        "minimal_moments (K1)": lambda: minimal_moments(idx, p, q),
        "horn_from_moments iters=4 (horn_hypotheses_kernel)": lambda: horn_from_moments(mom, iters=4),
        "best_pose_3d3d (features, K2, finalists, K3)": lambda: rs.best_pose_3d3d(
            T, p, q, TAU, return_pose=True
        ),
        "refit, 2 rounds (horn_refit_3d3d_kernel)": lambda: _refit_3d3d(
            T_start, zero, p, q, CFG, K
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
    # The fused step's record keeps its time alone at one shape; the track's
    # mean over its 13 launches (3 at M = 19200, 10 at M = 4800) stands here.
    in_track = [{"name": "icp_assoc_jtj_jtr", "device_ms": None}]
    set_device_ms(in_track, track_rows)
    track["icp_assoc_jtj_jtr_device_ms_per_launch"] = in_track[0]["device_ms"]
    if track["device_busy_ms"] is not None:
        track["ms_per_track"] = track_ms
        track["idle_share"] = 1.0 - track["device_busy_ms"] / track_ms

    # The layers of one config-3 Gauss-Newton step at level 0, each alone.
    step, _ = level_step(CAM, ICP_CONFIG3, src, tgt, 0)
    acc, _ = fused_level(ICP_CONFIG3, src, tgt, 0)
    JtJ, Jtr = (x.clone() for x in acc(eye)[:2])
    H = JtJ + 1e-6 * torch.eye(6, device=DEV)
    depth, _ = synthetic_depth_scene(CAM, eye)
    step_ms = {
        "make_icp_frame 640x480, 3 levels": lambda: make_icp_frame(CAM, depth, ICP_CONFIG3),
        "level closure (checks, buffers)": lambda: level_step(CAM, ICP_CONFIG3, src, tgt, 0),
        "icp_assoc_jtj_jtr (fused warp + associate + weights + sums, 19200 samples)": lambda: acc(eye),
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

    # The 2D-3D estimator on the card against itself on the CPU (K5's plain
    # version), from the same samples, 30% outliers, N = 300 (padded to 384).
    # 1e-3: exact-inlier samples tie to rounding, so the two may polish
    # different winners towards the one optimum.
    pts, obs, T2 = contaminated_2d3d(22, 300)
    cfg2 = RansacConfig(num_hypotheses=512, threshold=0.01)
    idx2 = sample_minimal_sets(g, 300, 512, 3)
    card2 = _estimate_2d3d_from_samples(idx2, pts, obs, cfg2)
    cpu2 = _estimate_2d3d_from_samples(idx2.cpu(), pts.cpu(), obs.cpu(), cfg2)
    diff2 = float((card2.pose.cpu() - cpu2.pose).abs().max())
    agree2 = float((card2.inlier_mask.cpu() == cpu2.inlier_mask).float().mean())
    score2 = abs(float(card2.score) - float(cpu2.score)) / float(cpu2.score)
    if diff2 > 1e-3 or agree2 < 0.99 or score2 > 1e-3 or not bool(card2.valid):
        raise AssertionError(f"2D-3D card vs CPU: pose diff {diff2}, masks agree {agree2}, "
                             f"score differs by {score2}")
    err2 = pose_error(card2, T2)

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
         estimate_2d3d_pose_max_diff=diff2, estimate_2d3d_inlier_mask_agreement=agree2,
         estimate_2d3d_score_rel_diff=score2, estimate_2d3d_pose_max_err=err2,
         icp_track_pose_max_diff=track_diff, icp_track_pose_max_err=track_err,
         icp_track_stats=[stats_card.tolist(), stats_cpu.tolist()])


# ---------------------------------------------------------------------------
# The frame-pair model and the SLAM model, from host images to poses
# ---------------------------------------------------------------------------

# The frame pair's gates are the JAX package's (tests/unit/test_tpu_features.py):
# at least 30 matches, rotation and translation entries within 0.02 of the
# ground-truth relative pose. Detection on the card is held against the same
# function on CPU tensors: keypoints and validity equal, scores within 1e-6,
# descriptor bits equal on 99.9% of the valid rows' bits (the centroid angle is
# a sum of 1369 terms whose order the two devices choose).
FRAME_PAIR_TOL = 0.02
FRAME_PAIR_MIN_MATCHES = 30
FRAME_PAIR_REPS = 5
MAX_FEATURES = 512
DESC_BITS_AGREE = 0.999


def frame_pair_modes():
    """name → (RansacConfig, mode, kernel launches a pair). Config 1 builds
    its hypotheses with the port's kabsch, so no K1 and no Horn hypotheses."""
    cfg1 = load_yaml_config(_ROOT / "configs" / "config1_synthetic_ao_pair.yaml").ransac
    cfg2 = load_yaml_config(_ROOT / "configs" / "config2_ransac_pnp_pair.yaml").ransac
    ranking = {"score_poses_3d3d_quad_fused": 1, "score_poses_3d3d": 1, "horn_refit_3d3d": 1}
    return {
        "config1_3d3d_kabsch": (cfg1, "3d3d", ranking),
        "default_3d3d_horn": (RansacConfig(), "3d3d",
                              {"minimal_moments": 1, "horn_hypotheses": 1, **ranking}),
        "config2_2d3d": (cfg2, "2d3d", {"score_poses_2d3d": 1}),
    }


def check_detection(grays):
    """FAST+BRIEF on the card against the same function on CPU tensors, for
    both frames of the pair; then matching the two frames' descriptors on the
    card against the CPU."""
    out = {"keypoints": [], "score_max_abs_err": 0.0, "descriptor_bits_differing": 0,
           "descriptor_bits": 0}
    found = []
    for gray in grays:
        g = torch.from_numpy(gray)
        card = [x.cpu() for x in tpu_detect.detect_and_describe(g.to(DEV), MAX_FEATURES)]
        host = tpu_detect.detect_and_describe(g, MAX_FEATURES)
        (uv, desc, valid, score), (uv_h, desc_h, valid_h, score_h) = card, host
        if not torch.equal(uv, uv_h) or not torch.equal(valid, valid_h):
            raise AssertionError("detect_and_describe: keypoints differ between card and CPU")
        out["keypoints"].append(int(valid.sum()))
        out["score_max_abs_err"] = max(out["score_max_abs_err"], float((score - score_h).abs().max()))
        out["descriptor_bits_differing"] += int(
            np.unpackbits((desc[valid] ^ desc_h[valid_h]).numpy(), axis=-1).sum())
        out["descriptor_bits"] += int(valid.sum()) * 256
        found.append((desc, valid))
    if (out["score_max_abs_err"] > 1e-6
            or out["descriptor_bits_differing"] > (1 - DESC_BITS_AGREE) * out["descriptor_bits"]):
        raise AssertionError(f"detect_and_describe, card vs CPU: {out}")
    # Matching on the card against the CPU on the same descriptors: equal.
    pair = (*found[0], *found[1])
    on_card = frontend.match_descriptors(*(x.to(DEV) for x in pair))
    on_cpu = frontend.match_descriptors(*pair)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
        raise AssertionError("match_descriptors: card and CPU differ")
    out["matches"] = int(on_cpu[1].sum())
    out["matches_equal"] = True
    return out


def pair_split_ms(est, images, seed):
    """One pair's wall time by stage, as ``estimate`` runs them: detection of
    both frames (host images in, host arrays out), matching on the card, the
    host part (depth lookup, quality sort, one copy to the card, padding),
    and the estimate with its read-back. The card is synchronised before
    each timer."""
    ga, da, gb = images[:3]
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    uv_a, d_a, va = frontend._detect(ga, MAX_FEATURES, "tpu", DEV)
    uv_b, d_b, vb = frontend._detect(gb, MAX_FEATURES, "tpu", DEV)
    mark()
    matches = frontend._match(d_a, va, d_b, vb, DEV)
    mark()
    if est.mode == "3d3d":
        a, b = frontend._correspondences_3d3d(CAM, uv_a, uv_b, *matches, da, images[3])
        n = min(len(a), est.max_corr)
        a_pad, b_pad = pad_correspondences_3d3d(*est._ship(a[:n], b[:n]), est.max_corr)
        run = estimate_pose_3d3d
    else:
        a, b = frontend._correspondences_2d3d(CAM, uv_a, uv_b, *matches, da)
        n = min(len(a), est.max_corr)
        a_pad, b_pad = pad_points_obs_2d3d(*est._ship(a[:n], b[:n]), est.max_corr)
        run = estimate_pose_2d3d
    mark()
    run(generator(seed), a_pad, b_pad, est.cfg).pose.cpu()
    mark()
    return dict(zip(("detect", "match", "host", "estimate"), np.diff(marks).tolist())) | {
        "total": marks[-1] - marks[0]}


def phase_frame_pair():
    """The frame-pair model a user calls for configurations 1 and 2, at
    640x480 (the icp_track phase's camera), host images in: the FAST+BRIEF
    detector on the card, matching on the card, the host's depth lookup and
    sort, then the RANSAC engine's kernels. Returns the launch counts of each
    mode's pair (the main path)."""
    poses, depths, intens = synthetic_sequence(CAM, generator(41), 2, motion_scale=0.01, device=DEV)
    gray = [g.cpu().numpy() for g in intens]
    depth = [d.cpu().numpy() for d in depths]
    P = poses.cpu().numpy()
    T_ab = P[1] @ np.linalg.inv(P[0])
    detection = check_detection(gray)
    out, counts_by_mode = {}, {}
    for name, (cfg, mode, launches) in frame_pair_modes().items():
        est = FramePairEstimator(CAM, cfg, mode=mode, detector="tpu",
                                 max_features=MAX_FEATURES, max_corr=MAX_FEATURES)
        images = (gray[0], depth[0], gray[1], depth[1]) if mode == "3d3d" else (gray[0], depth[0], gray[1])
        est.estimate(*images)  # warm-up: loads every library kernel the path uses
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        res = est.estimate(*images)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        expect_launches(counts, launches, f"frame pair {name}")
        counts_by_mode[name] = counts
        err_R = float(np.abs(res.pose[:3, :3] - T_ab[:3, :3]).max())
        err_t = float(np.abs(res.pose[:3, 3] - T_ab[:3, 3]).max())
        if (not res.valid or res.num_matches < FRAME_PAIR_MIN_MATCHES
                or not max(err_R, err_t) < FRAME_PAIR_TOL):
            raise AssertionError(f"frame pair {name}: {res}, errors {err_R} {err_t}")
        times = []
        for _ in range(FRAME_PAIR_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.estimate(*images)
            times.append((time.perf_counter() - t0) * 1e3)
        splits = [pair_split_ms(est, images, 100 + i) for i in range(FRAME_PAIR_REPS)]
        on_device = device_summary(profile_device(lambda: est.estimate(*images)))
        out[name] = {
            "mode": mode, "solver": cfg.solver, "num_hypotheses": res.num_hypotheses,
            "threshold": cfg.threshold, "prosac": cfg.prosac,
            "num_matches": res.num_matches, "num_inliers": res.num_inliers,
            "rotation_err": err_R, "translation_err": err_t,
            "ms_per_pair": statistics.median(times), "ms_samples": times,
            "split_ms": {k: 1e3 * statistics.median(s[k] for s in splits) for k in splits[0]},
            "kernel_launches_per_pair": {k: v for k, v in counts.items() if v},
            "device_launches_per_pair": on_device["cuda_kernel_launches"],
            "device_busy_ms": on_device["device_busy_ms"],
            "by_kernel_ms": on_device["by_kernel_ms"],
        }
    emit("frame_pair", width=CAM.width, height=CAM.height, max_features=MAX_FEATURES,
         max_corr=MAX_FEATURES, detection_card_vs_cpu=detection, modes=out)
    return counts_by_mode


# Configuration 4's backend over a rendered sequence: the JAX package's SLAM
# test holds 12 frames at 160x120 to 1 cm ATE after the pose graph; here 32
# frames at 640x480, a keyframe at least every 4th frame (as that test takes
# it) so that loop candidates exist. Every loop candidate is verified by one
# config-4 track: 5 + 7 + 10 fused steps.
SLAM_FRAMES = 32
SLAM_ATE_TOL_M = 0.01
SLAM_STEPS = 22
PCG_VS_DENSE_TOL = 1e-4


def phase_slam():
    """The SLAM model at 640x480 with configuration 4's ICP and pose graph:
    track 32 frames (host depth in), then ``optimize()``: ICP-verified loop
    closures and the keyframe pose graph. Returns the launch counts of the
    backend (the main path of loop verification)."""
    import dataclasses

    c4 = load_yaml_config(_ROOT / "configs" / "config4_pose_graph.yaml")
    cfg = PipelineConfig(icp=c4.icp, pose_graph=c4.pose_graph,
                         keyframe=KeyframeConfig(max_interval=4))
    poses_gt, depths, _ = synthetic_sequence(CAM, generator(51), SLAM_FRAMES,
                                             motion_scale=0.008, device=DEV)
    depths_np = [d.cpu().numpy() for d in depths]
    gt = poses_gt.cpu().numpy()

    warm = Slam(CAM, cfg)  # warm-up: loads every library kernel the path uses
    for d in depths_np[:6]:
        warm.track(d)
    warm.optimize()
    slam = Slam(CAM, cfg)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for d in depths_np:
        slam.track(d)
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    expect_launches(_build.launch_counts(), {"icp_assoc_jtj_jtr": (SLAM_FRAMES - 1) * SLAM_STEPS},
                    "slam tracking")
    kfs = slam.odo.keyframes
    candidates = pose_graph.loop_candidates(kfs, 0.5, 3, 20)  # detect_loop_closures' defaults

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    traj = slam.optimize()
    optimize_ms = (time.perf_counter() - t0) * 1e3
    counts = _build.launch_counts()
    expect_launches(counts, {"icp_assoc_jtj_jtr": SLAM_STEPS * len(candidates)}, "slam optimize")

    # The same backend in its two parts, on the same keyframes.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loops = pose_graph.detect_loop_closures(slam.odo)
    loop_ms = (time.perf_counter() - t0) * 1e3
    graph = pose_graph.keyframe_graph(slam.odo, loops, cfg.pose_graph)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T_opt, costs = pose_graph.optimize_pose_graph(*graph, cfg.pose_graph)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    ate = ate_rmse(centers(traj), centers(gt))
    ate_odometry = ate_rmse(centers(slam.trajectory), centers(gt))
    if not np.isfinite(traj).all() or traj.shape != (SLAM_FRAMES, 4, 4) or not ate < SLAM_ATE_TOL_M:
        raise AssertionError(f"slam: ATE {ate} m")
    if len(loops) < 1:
        raise AssertionError(f"slam: no loop verified among {len(candidates)} candidates")
    # The two solvers on the same graph; reruns bit-equal (no float atomics);
    # nothing in the pose graph waits for the stream.
    pcg = dataclasses.replace(cfg.pose_graph, solver="pcg")
    dense = dataclasses.replace(cfg.pose_graph, solver="dense")
    pcg_vs_dense = float((pose_graph.optimize_pose_graph(*graph, pcg)[0]
                          - pose_graph.optimize_pose_graph(*graph, dense)[0]).abs().max())
    if not pcg_vs_dense <= PCG_VS_DENSE_TOL:
        raise AssertionError(f"slam: pcg and dense differ by {pcg_vs_dense}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        reruns = [pose_graph.optimize_pose_graph(*graph, s) for s in (cfg.pose_graph, pcg)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = [pose_graph.optimize_pose_graph(*graph, s) for s in (cfg.pose_graph, pcg)]
    if not torch.equal(reruns[0][0], T_opt) or not all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(reruns, again)):
        raise AssertionError("slam: two runs of optimize_pose_graph differ")
    on_device = device_summary(profile_device(
        lambda: pose_graph.optimize_pose_graph(*graph, cfg.pose_graph)))
    emit("slam", frames=SLAM_FRAMES, width=CAM.width, height=CAM.height,
         icp=vars(cfg.icp), pose_graph=vars(cfg.pose_graph), keyframe=vars(cfg.keyframe),
         track_frames_per_s=SLAM_FRAMES / track_s,
         optimize_ms=optimize_ms, loop_detection_ms=loop_ms, pose_graph_ms=graph_ms,
         keyframes=len(kfs), candidates=len(candidates), accepted_loops=len(loops),
         loops=[(a, b, ov) for a, b, _, ov in loops],
         ate_m=ate, ate_odometry_only_m=ate_odometry,
         costs_first_last=[float(costs[0]), float(costs[-1])],
         pcg_vs_dense_max_diff=pcg_vs_dense,
         icp_assoc_jtj_jtr_launches={"track": (SLAM_FRAMES - 1) * SLAM_STEPS,
                                     "optimize": counts["icp_assoc_jtj_jtr"]},
         pose_graph_device_launches=on_device["cuda_kernel_launches"],
         pose_graph_device_busy_ms=on_device["device_busy_ms"])
    return counts


# Phase ba: configuration 5 on one card. A TUM-format sequence written to disk,
# read back through the port's readers, tracked by Slam and optimised with
# loop closure, the pose graph and bundle adjustment; then ba_solve at the
# size the reference sized its reductions for (ba/schur.py of the JAX
# package measured its slot tables at O = 98,304).
BA_FRAMES = 64
BA_SIZE = (640, 480)
BA_SEED = 61
BA_ATE_TOL_M = 0.02  # the JAX package's own BA bound (tests/unit/test_slam_model.py)
BA_PROBLEM = dict(num_cameras=64, num_points=24576, obs_per_point=4)  # O = 98,304
BA_PROBLEM_SEED = 7
# Noise-free observations: the reference's ba_solve brings this very problem
# (drawn from a CPU torch.Generator seeded 7, config 5's iterations) to
# 1.79e-7 of the truth on the CPU; the gate allows two f32 ulps of the
# poses' largest entries (~3.1), 4.8e-7, for the card's summation order.
BA_TRUTH_TOL = 4.8e-7
# One ba_step on the card against the same step on the CPU: the CPU parity
# tests' tolerances (tests/test_torch_ba.py).
BA_STEP_COST_RTOL, BA_STEP_ATOL = 1e-5, 1e-4


def ba_data(root):
    """Part 1: write the sequence, read it back through ``TumSequence`` and
    ``sequence_prefetcher``; frames bit-equal to the render quantised as the
    writer quantises it. Returns the camera, the sequence, the frames and
    the timings."""
    from rgbd_pose_estimation_tpu_torch.data import native_loader, png, tum
    from rgbd_pose_estimation_tpu_torch.data.prefetch import sequence_prefetcher

    t0 = time.perf_counter()
    cam = tum.write_synthetic_tum(root, n_frames=BA_FRAMES, size=BA_SIZE, motion_scale=0.008,
                                  seed=BA_SEED, device=DEV)
    write_s = time.perf_counter() - t0
    seq = tum.TumSequence(root)
    decoder = native_loader.decoder_name()
    if len(seq) != BA_FRAMES:
        raise AssertionError(f"ba: {len(seq)} frames associated, wrote {BA_FRAMES}")
    # The native decoder, where it built, against the stdlib codec bit for bit.
    if decoder == "native":
        for sub, files in (("gray", seq.rgb_files), ("depth", seq.depth_files)):
            path = str(pathlib.Path(root) / files[BA_FRAMES // 2])
            stdlib = png.read_png(path)
            native = (native_loader.decode_gray8(path) if sub == "gray"
                      else native_loader.decode_depth16(path))
            if not np.array_equal(png.to_gray8(stdlib) if sub == "gray" else stdlib, native):
                raise AssertionError(f"ba: stdlib and native decoders differ on a {sub} frame")
    t0 = time.perf_counter()
    for i in range(len(seq)):
        seq.frame(i)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(seq)
    t0 = time.perf_counter()
    frames = list(sequence_prefetcher(seq, 0, len(seq)))
    prefetch_fps = len(frames) / (time.perf_counter() - t0)
    _, depths, intens = tum.render_synthetic(cam, BA_FRAMES, 0.008, BA_SEED, device=DEV)
    for i, (_, gray, depth) in enumerate(frames):
        if not (np.array_equal(gray, tum.quantize_gray8(intens[i]).astype(np.float32) / 255.0)
                and np.array_equal(depth, tum.quantize_depth16(depths[i]).astype(np.float32)
                                   * seq.depth_scale)):
            raise AssertionError(f"ba: frame {i} read back differs from the quantised render")
    timing = {"decoder": decoder, "write_s": write_s, "decode_ms_per_frame": decode_ms,
              "prefetch_frames_per_s": prefetch_fps}
    return cam, seq, frames, timing


def ba_slam(cam, seq, frames):
    """Part 2: ``Slam`` with BA over the frames read back, config 4's
    tracking and pose graph, config 5's BA and front-end size. Returns the
    Slam, its trajectory with BA and the phase's record."""
    import dataclasses

    from rgbd_pose_estimation_tpu_torch.ba.build import (
        build_ba_problem,
        detect_keyframe_features,
        match_keyframe_pairs,
    )
    from rgbd_pose_estimation_tpu_torch.ba.schur import ba_step, reduction_slots, reprojection_rmse
    from rgbd_pose_estimation_tpu_torch.models.slam import refine_keyframes

    c4 = load_yaml_config(_ROOT / "configs" / "config4_pose_graph.yaml")
    c5 = load_yaml_config(_ROOT / "configs" / "config5_distributed_ba.yaml")
    # The card's machine has no cv2, so config 5's host ORB cannot run there:
    # the on-device FAST+BRIEF detector at config 5's max_features.
    cfg = PipelineConfig(icp=c4.icp, pose_graph=c4.pose_graph,
                         keyframe=KeyframeConfig(max_interval=4), ba=c5.ba,
                         frontend=dataclasses.replace(c5.frontend, detector="tpu"))
    warm = Slam(cam, cfg, device=DEV)  # warm-up: every library kernel and the BA path once
    for _, g, d in frames[:6]:
        warm.track(d, gray=g)
    warm.optimize(bundle_adjust=True)

    slam = Slam(cam, cfg, device=DEV)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for _, g, d in frames:
        slam.track(d, gray=g)
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    kfs = slam.odo.keyframes
    candidates = pose_graph.loop_candidates(kfs, 0.5, 3, 20)  # detect_loop_closures' defaults
    t0 = time.perf_counter()
    traj = slam.optimize(bundle_adjust=True)
    optimize_ms = (time.perf_counter() - t0) * 1e3
    expect_launches(_build.launch_counts(),
                    {"icp_assoc_jtj_jtr": SLAM_STEPS * (BA_FRAMES - 1 + len(candidates))},
                    "ba: slam track + optimize(bundle_adjust=True)")
    report = slam.ba_report
    info = report["info"]

    # The backend in its parts, on the same keyframes, each synchronised.
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    loops, loop_ms = timed(lambda: pose_graph.detect_loop_closures(slam.odo))
    graph = pose_graph.keyframe_graph(slam.odo, loops, cfg.pose_graph)
    _, graph_ms = timed(lambda: pose_graph.optimize_pose_graph(*graph, cfg.pose_graph))
    kf_idx = [k.index for k in kfs]
    grays = [slam._grays[i] for i in kf_idx]
    depths = [slam._depths[i] for i in kf_idx]
    M = cfg.frontend.max_features
    (_, desc, valid, _), detect_ms = timed(
        lambda: detect_keyframe_features(grays, depths, M, "tpu", device=DEV))
    pairs = [(i, i + 1) for i in range(len(kfs) - 1)]
    _, match_ms = timed(lambda: match_keyframe_pairs(desc, valid, pairs, device=DEV))
    kf_poses = report["pose_graph_trajectory"][kf_idx]
    (prob, info2), build_ms = timed(lambda: build_ba_problem(cam, grays, depths, kf_poses,
                                                             max_features=M, detector="tpu",
                                                             device=DEV))
    _, solve_ms = timed(lambda: refine_keyframes(prob, cfg.ba))
    if info2 != info:
        raise AssertionError(f"ba: a second build differs: {info2} vs {info}")

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    _, gt = seq.groundtruth_aligned()
    ate = ate_rmse(centers(traj), centers(gt))
    ate_pose_graph = ate_rmse(centers(report["pose_graph_trajectory"]), centers(gt))
    solved = report["solved"]
    # A step with the odometry priors waits for the stream no more than one
    # without (part 3).
    slots = reduction_slots(solved)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ba_step(solved, cfg.ba, *slots)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rmse_before = float(reprojection_rmse(report["problem"]._replace(w=solved.w)))
    rmse_after = float(reprojection_rmse(solved))
    costs = report["costs"].cpu().numpy()
    if not np.isfinite(traj).all() or traj.shape != (BA_FRAMES, 4, 4):
        raise AssertionError(f"ba: trajectory {traj.shape}, finite {np.isfinite(traj).all()}")
    if not ate < BA_ATE_TOL_M:
        raise AssertionError(f"ba: ATE with BA {ate} m")
    if not rmse_after < rmse_before:
        raise AssertionError(f"ba: reprojection RMSE {rmse_before} -> {rmse_after}")
    if len(loops) < 1:
        raise AssertionError(f"ba: no loop verified among {len(candidates)} candidates")
    return slam, traj, {
        "frames": BA_FRAMES, "width": cam.width, "height": cam.height,
        "detector": "tpu (config 5 names orb: host OpenCV, which the card's machine lacks)",
        "ba": vars(cfg.ba), "icp": vars(cfg.icp), "keyframe": vars(cfg.keyframe),
        "track_frames_per_s": BA_FRAMES / track_s, "optimize_ms": optimize_ms,
        "split_ms": {"loop_detection": loop_ms, "pose_graph": graph_ms, "ba_detect": detect_ms,
                     "ba_match": match_ms, "ba_tracks": build_ms - detect_ms - match_ms,
                     "ba_build": build_ms, "ba_solve": solve_ms},
        "keyframes": len(kfs), "candidates": len(candidates), "accepted_loops": len(loops),
        "landmarks": info["num_landmarks"], "observations": info["num_observations"],
        "mean_track_len": info["mean_track_len"],
        "costs_first_last": [float(costs[0]), float(costs[-1])],
        "reprojection_rmse_before_after": [rmse_before, rmse_after],
        "ate_m": ate, "ate_pose_graph_only_m": ate_pose_graph,
        "icp_assoc_jtj_jtr_launches": SLAM_STEPS * (BA_FRAMES - 1 + len(candidates)),
    }


def ba_large(cfg):
    """Part 3: ``ba_solve`` at O = 98,304 on the card: cost falls, reruns
    bit-equal, one step against the CPU, nothing waits for the stream, and
    noise-free observations bring the poses to the truth."""
    from rgbd_pose_estimation_tpu_torch.ba.schur import (
        ba_solve,
        ba_step,
        make_synthetic_ba_problem,
        reduction_slots,
    )

    def on_card(prob):
        return type(prob)(*(None if x is None else x.to(DEV) for x in prob))

    host, _, _ = make_synthetic_ba_problem(torch.Generator().manual_seed(BA_PROBLEM_SEED + 1),
                                           **BA_PROBLEM, device="cpu")
    prob = on_card(host)
    slots = reduction_slots(prob)
    for _ in range(2):  # warm-up
        ba_step(prob, cfg, *slots)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out, costs = prob, []
    for _ in range(cfg.outer_iters):
        out, cost = ba_step(out, cfg, *slots)
        costs.append(cost)
    stop.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / cfg.outer_iters
    event_ms = start.elapsed_time(stop) / cfg.outer_iters
    costs = torch.stack(costs)
    again, costs2 = ba_solve(prob, cfg)
    if not (torch.equal(again.poses, out.poses) and torch.equal(again.points, out.points)
            and torch.equal(costs2, costs)):
        raise AssertionError("ba: two runs of ba_solve differ")
    if not float(costs[-1]) < float(costs[0]):
        raise AssertionError(f"ba: cost {float(costs[0])} -> {float(costs[-1])}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        step, cost = ba_step(prob, cfg, *slots)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    step_cpu, cost_cpu = ba_step(host, cfg, *reduction_slots(host))
    cost_rel = abs(float(cost) - float(cost_cpu)) / abs(float(cost_cpu))
    state_err = max(float((step.poses.cpu() - step_cpu.poses).abs().max()),
                    float((step.points.cpu() - step_cpu.points).abs().max()))
    if not (cost_rel <= BA_STEP_COST_RTOL and state_err <= BA_STEP_ATOL):
        raise AssertionError(f"ba: card vs CPU step: cost rel {cost_rel}, state {state_err}")
    on_device = device_summary(profile_device(lambda: ba_step(prob, cfg, *slots)))

    clean, T_gt, _ = make_synthetic_ba_problem(torch.Generator().manual_seed(BA_PROBLEM_SEED),
                                               **BA_PROBLEM, pixel_noise=0.0, device="cpu")
    solved, _ = ba_solve(on_card(clean), cfg)
    truth_err = float((solved.poses.cpu() - T_gt).abs().max())
    if not truth_err <= BA_TRUTH_TOL:
        raise AssertionError(f"ba: noise-free poses {truth_err} from the truth (bound {BA_TRUTH_TOL})")
    return {
        "O": int(prob.cam_idx.shape[0]), "C": int(prob.poses.shape[0]), "L": int(prob.points.shape[0]),
        "outer_iters": cfg.outer_iters, "cg_iters": cfg.cg_iters,
        "ms_per_outer_step_events": event_ms, "ms_per_outer_step_host": host_ms,
        "costs_first_last": [float(costs[0]), float(costs[-1])],
        "step_card_vs_cpu": {"cost_rel": cost_rel, "max_abs_state": state_err},
        "noise_free_pose_err": truth_err, "noise_free_bound": BA_TRUTH_TOL,
        "step_device_launches": on_device["cuda_kernel_launches"],
        "step_device_busy_ms": on_device["device_busy_ms"],
        "step_by_kernel_ms": on_device["by_kernel_ms"],
    }


def phase_ba():
    """Configuration 5 on one card: data, Slam with BA, the large solve."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_tum_")
    try:
        cam, seq, frames, data = ba_data(root)
        slam, traj, record = ba_slam(cam, seq, frames)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    c5 = load_yaml_config(_ROOT / "configs" / "config5_distributed_ba.yaml")
    emit("ba", data=data, slam=record, solve=ba_large(c5.ba))
    return slam, traj, seq.groundtruth_aligned()[1], record["ate_m"]


# Phase distributed: the distributed layer (parallel/, ba/cluster.py) on a
# mesh of one rank, a real NCCL group of world size 1 (NCCL refuses two
# ranks on one card; the multi-rank runs are the CPU tests' gloo groups).
# Each sharded function is held against its single-device twin at the
# shapes of the earlier phases, with the tolerances of the JAX package's
# distributed tests; on one rank the sums run in the same order, so each is
# also reported bit for bit.
DIST_SEED = 71
DIST_SCORE_RTOL = 1e-6
DIST_ICP_RTOL, DIST_ICP_ATOL = 2e-5, 1e-3
DIST_COST_RTOL, DIST_POSE_ATOL, DIST_POINT_ATOL = 1e-5, 2e-4, 1e-3
DIST_RING_TOL = 1e-5
DIST_ICP_M = 640 * 480
DIST_RING_K = BA_FRAMES  # one descriptor a frame of phase ba's sequence


def check_same(out, ref, rtol, atol, what):
    """``out`` within the tolerance of ``ref`` (NaN where ``ref`` has it);
    returns whether it is bit-equal too."""
    assert_close(out, ref, rtol, atol, what)
    return bool(torch.equal(torch.nan_to_num(out, nan=7.0), torch.nan_to_num(ref, nan=7.0)))


def counted_launches(fn):
    """``fn()`` with the launch counters set to 0 just before it and read
    just after: (result, {kernel: launches} of the kernels it launched)."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _build.launch_counts().items() if v}


def without_sync(fn):
    """``fn()`` under ``set_sync_debug_mode("error")``: a read-back raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def interleaved_ms(fns, rounds=7):
    """Median ms of one call of each of ``fns`` (a dict), by CUDA events and
    by the host clock to a synchronise, the calls taken in turns so that
    the host's drift falls on all alike."""
    samples = {k: ([], []) for k in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            samples[k][0].append(start.elapsed_time(stop))
            samples[k][1].append((time.perf_counter() - t0) * 1e3)
    return {k: {"events": statistics.median(ev), "host": statistics.median(host)}
            for k, (ev, host) in samples.items()}


def dist_loop_candidates(slam):
    """The loop candidates of phase ba's keyframes as
    ``detect_loop_closures`` verifies them: (pairs, T_init, src, tgt)."""
    from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame

    kfs = slam.odo.keyframes
    pairs = pose_graph.loop_candidates(kfs, 0.5, 3, 20)
    inv = pose_graph._inverse_np(np.stack([k.pose for k in kfs]))
    T_init = torch.from_numpy(np.stack([kfs[a].pose @ inv[b] for a, b in pairs]).astype(np.float32)).to(DEV)

    def stack(frames):
        return IcpFrame(*(tuple(torch.stack(level) for level in zip(*leaves)) for leaves in zip(*frames)))

    return pairs, T_init, stack([kfs[b].frame for _, b in pairs]), stack([kfs[a].frame for a, _ in pairs])


# Configuration 5 as one call, distributed_slam on the world-1 mesh over
# phase ba's 64 frames with phase ba's Slam configuration: its ATE may exceed
# the Slam's by at most the JAX package's own margin
# (tests/distributed/test_distributed_slam.py), and each tracked frame and
# each verified loop candidate is one config-4 track, 22 fused steps.
DSLAM_CHUNKS, DSLAM_OVERLAP = 2, 3
DSLAM_ATE_MARGIN_M = 1.5e-3


def tracked_frames(n, chunks, overlap):
    """Frames the chunks of sequence_parallel_odometry track (a chunk's
    first frame is its origin, not tracked)."""
    from rgbd_pose_estimation_tpu_torch.models.sequence_parallel import chunk_ranges

    return sum(e - s - 1 for s, e in chunk_ranges(n, chunks, overlap))


def stage_of(records, name):
    return next(r for r in records if r.get("stage") == name)


def dist_slam_phase(mesh, slam, gt, ate_slam):
    """distributed_slam over phase ba's frames on ``mesh`` (world 1, NCCL):
    finite, within the margin of the Slam's ATE, bit-equal on a rerun, no
    observation dropped, exactly 22 fused steps a tracked frame and a
    verified candidate; and sequence_parallel_odometry with the mesh
    bit-equal to without. Returns (record, fused-step launches)."""
    from rgbd_pose_estimation_tpu_torch.models.distributed_slam import distributed_slam
    from rgbd_pose_estimation_tpu_torch.models.sequence_parallel import sequence_parallel_odometry
    from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger

    cam, cfg = slam.cam, slam.cfg
    depths, grays = slam._depths, slam._grays
    n = len(depths)
    tracked = tracked_frames(n, DSLAM_CHUNKS, DSLAM_OVERLAP)

    def call():
        metrics = MetricsLogger()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = distributed_slam(cam, depths, grays, mesh, cfg, n_chunks=DSLAM_CHUNKS,
                                overlap=DSLAM_OVERLAP, detector="tpu", bundle_adjust=True,
                                metrics=metrics)
        torch.cuda.synchronize()
        return traj, metrics.records, time.perf_counter() - t0

    (traj, records, seconds), got = counted_launches(call)
    candidates = stage_of(records, "loops")["candidates"]
    expect_launches(got, {"icp_assoc_jtj_jtr": SLAM_STEPS * (tracked + candidates)},
                    "distributed_slam")
    again, _, seconds2 = call()

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    ate = ate_rmse(centers(traj), centers(gt))
    ba = stage_of(records, "ba")
    if not (traj.shape == (n, 4, 4) and np.isfinite(traj).all()):
        raise AssertionError(f"distributed_slam: trajectory {traj.shape}, finite {np.isfinite(traj).all()}")
    if not ate <= ate_slam + DSLAM_ATE_MARGIN_M:
        raise AssertionError(f"distributed_slam: ATE {ate} m against the Slam's {ate_slam} m")
    if not np.array_equal(traj, again):
        raise AssertionError(f"distributed_slam: a rerun differs by {np.abs(traj - again).max()}")
    if ba["reshard_dropped"] != 0:
        raise AssertionError(f"distributed_slam: the relayout dropped {ba['reshard_dropped']}")

    def odometry(with_mesh):
        return sequence_parallel_odometry(cam, depths, n_chunks=DSLAM_CHUNKS, overlap=DSLAM_OVERLAP,
                                          icp_cfg=cfg.icp, kf_cfg=cfg.keyframe, pg_cfg=cfg.pose_graph,
                                          return_keyframes=True, mesh=mesh if with_mesh else None,
                                          device=DEV)

    (odo_mesh, kf_mesh), odo_got = counted_launches(lambda: odometry(True))
    expect_launches(odo_got, {"icp_assoc_jtj_jtr": SLAM_STEPS * tracked},
                    "sequence_parallel_odometry(mesh=)")
    odo_none, kf_none = odometry(False)
    if not (np.array_equal(odo_mesh, odo_none) and kf_mesh == kf_none):
        raise AssertionError("sequence_parallel_odometry: mesh of one rank differs from mesh=None")
    return {
        "frames": n, "size": [cam.width, cam.height], "chunks": DSLAM_CHUNKS, "overlap": DSLAM_OVERLAP,
        "detector": "tpu", "icp": vars(cfg.icp), "ba": vars(cfg.ba),
        "keyframes": stage_of(records, "keyframes")["count"], "candidates": candidates,
        "accepted_loops": stage_of(records, "loops")["accepted"],
        "landmarks": stage_of(records, "ba_build")["num_landmarks"],
        "observations": stage_of(records, "ba_build")["num_observations"],
        "cost_first_last": [ba["cost_first"], ba["cost_last"]], "reshard_dropped": ba["reshard_dropped"],
        "ate_m": ate, "ate_slam_m": ate_slam, "ate_margin_m": DSLAM_ATE_MARGIN_M,
        "rerun_bit_equal": True, "tracked_frames": tracked,
        "fused_step_launches": got["icp_assoc_jtj_jtr"],
        "seconds": [seconds, seconds2], "frames_per_s": [n / seconds, n / seconds2],
        "card": SMI,
        "stage_seconds": {r["stage"]: r["t"] - records[0]["t"] for r in records},
        "sequence_parallel_mesh_vs_none_bit_equal": True,
        "sequence_parallel_launches": odo_got["icp_assoc_jtj_jtr"],
    }, got["icp_assoc_jtj_jtr"]


def phase_distributed(slam, traj, gt, ate_slam):
    """Every sharded function on a world-1 NCCL mesh against its twin, the
    launches of K3, K4 and the fused ICP step on the sharded paths, the BA
    steps with no read-back, the bytes a blocked CG iteration reduces, the
    sharded Slam, configuration 5 as one call (distributed_slam) and the dry
    run. Returns the sharded paths' launches."""
    import dataclasses

    import torch.distributed as dist

    from rgbd_pose_estimation_tpu_torch.ba import cluster
    from rgbd_pose_estimation_tpu_torch.ba.schur import (
        ba_solve,
        ba_step,
        make_synthetic_ba_problem,
        reduction_slots,
    )
    from rgbd_pose_estimation_tpu_torch.icp.dense import icp_track_batch
    from rgbd_pose_estimation_tpu_torch.parallel import mesh as pm
    from rgbd_pose_estimation_tpu_torch.parallel import sharded as ps
    from rgbd_pose_estimation_tpu_torch.parallel.dryrun import dryrun_multichip
    from rgbd_pose_estimation_tpu_torch.parallel.specs import REPLICATED

    t_phase = time.perf_counter()
    mesh = pm.make_mesh(device=DEV)
    backend = str(dist.get_backend())
    if "nccl" not in backend or dist.get_world_size() != 1 or mesh.shape != (1, 1):
        raise AssertionError(f"distributed: a {backend} group of {dist.get_world_size()}, mesh {mesh.shape}")
    out = {"backend": backend, "world_size": dist.get_world_size(), "mesh": list(mesh.shape)}
    launches = {}

    def fetch(x):
        return pm.gather_global(x)

    # K3: the bench problem's hypotheses split over the ranks.
    _, pp, qq, T = hypotheses(DIST_SEED, K, N)
    (msac, count), got = counted_launches(lambda: ps.score_poses_3d3d_sharded(mesh, T, pp, qq, TAU))
    expect_launches(got, {"score_poses_3d3d": 1}, "distributed: score_poses_3d3d_sharded")
    launches["score_poses_3d3d"] = got["score_poses_3d3d"]
    ref_m, ref_c = rs.score_poses_3d3d(T, pp, qq, TAU)
    again = ps.score_poses_3d3d_sharded(mesh, T, pp, qq, TAU)[0]
    out["score"] = {
        "K": K, "N": N, "bit_equal": check_same(fetch(msac), ref_m, DIST_SCORE_RTOL, 0.0, "sharded scores"),
        "counts_equal": bool(torch.equal(fetch(count), ref_c)),
        "rerun_bit_equal": bool(torch.equal(torch.nan_to_num(again.local), torch.nan_to_num(msac.local))),
        "ms": time_ms(lambda: ps.score_poses_3d3d_sharded(mesh, T, pp, qq, TAU)),
        "single_device_ms": time_ms(lambda: rs.score_poses_3d3d(T, pp, qq, TAU)),
    }
    if not out["score"]["counts_equal"]:
        raise AssertionError("distributed: sharded inlier counts differ")

    # K4: the 640x480 pixel rows split over the ranks, one all_reduce.
    g = generator(DIST_SEED + 1)
    p = torch.randn((DIST_ICP_M, 3), generator=g, device=DEV)
    q = p + 0.01 * torch.randn((DIST_ICP_M, 3), generator=g, device=DEV)
    n = torch.randn((DIST_ICP_M, 3), generator=g, device=DEV)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    w = torch.rand((DIST_ICP_M,), generator=g, device=DEV)
    shd, got = counted_launches(lambda: ps.icp_jtj_sharded(mesh, p, q, n, w))
    expect_launches(got, {"icp_jtj_jtr": 1}, "distributed: icp_jtj_sharded")
    launches["icp_jtj_jtr"] = got["icp_jtj_jtr"]
    ref = icp_jtj_jtr(p, q, n, w)
    out["icp_jtj"] = {
        "M": DIST_ICP_M,
        "bit_equal": all([check_same(a.reshape(-1), b.reshape(-1), DIST_ICP_RTOL, DIST_ICP_ATOL, "icp_jtj_sharded")
                          for a, b in zip(shd, ref)]),
        "ms": time_ms(lambda: ps.icp_jtj_sharded(mesh, p, q, n, w)),
        "single_device_ms": time_ms(lambda: icp_jtj_jtr(p, q, n, w)),
    }

    # The fused ICP step: phase ba's loop candidates split over the ranks.
    pairs, T_init, src, tgt = dist_loop_candidates(slam)
    cam, icp_cfg = slam.odo.cam, slam.odo.icp_cfg
    (T_v, stats_v, valid0), got = counted_launches(
        lambda: ps.icp_verify_sharded(mesh, cam, icp_cfg, T_init, src, tgt))
    expect_launches(got, {"icp_assoc_jtj_jtr": SLAM_STEPS * len(pairs)}, "distributed: icp_verify_sharded")
    launches["icp_assoc_jtj_jtr"] = got["icp_assoc_jtj_jtr"]
    T_ref, stats_ref = icp_track_batch(cam, icp_cfg, T_init, src, tgt)
    valid_ref = torch.sum(torch.sum(src.normals[0] ** 2, dim=-1) > 0.5, dim=(1, 2)).to(torch.float32)
    out["icp_verify"] = {
        "pairs": len(pairs), "size": [cam.width, cam.height],
        "bit_equal": (check_same(fetch(T_v), T_ref, DIST_ICP_RTOL, DIST_ICP_ATOL, "icp_verify_sharded poses")
                      and check_same(fetch(stats_v), stats_ref, DIST_ICP_RTOL, DIST_ICP_ATOL,
                                     "icp_verify_sharded stats")),
        "valid0_equal": bool(torch.equal(fetch(valid0), valid_ref)),
    }
    if not out["icp_verify"]["valid0_equal"] or len(pairs) < 1:
        raise AssertionError(f"distributed: {len(pairs)} candidates, valid0 {out['icp_verify']}")

    # BA at O = 98,304: the replicated layout and the blocked one.
    cfg = load_yaml_config(_ROOT / "configs" / "config5_distributed_ba.yaml").ba
    host, _, _ = make_synthetic_ba_problem(torch.Generator().manual_seed(BA_PROBLEM_SEED + 1),
                                           **BA_PROBLEM, device="cpu")
    prob = type(host)(*(None if x is None else x.to(DEV) for x in host))
    C, L = int(prob.poses.shape[0]), int(prob.points.shape[0])
    slots = reduction_slots(prob)
    shard_slots = ps.ba_reduction_slots(mesh, prob)
    ref_p, ref_cost = ba_step(prob, cfg, *slots)
    ps.ba_step_sharded(mesh, prob, cfg, shard_slots)  # warm-up
    sh, sh_cost = without_sync(lambda: ps.ba_step_sharded(mesh, prob, cfg, shard_slots))
    sh2, sh_cost2 = ps.ba_step_sharded(mesh, prob, cfg, shard_slots)
    out["ba_step_sharded"] = {
        "O": int(prob.cam_idx.shape[0]), "C": C, "L": L,
        "bit_equal": (check_same(sh_cost.reshape(1), ref_cost.reshape(1), DIST_COST_RTOL, 0.0, "sharded cost")
                      and check_same(fetch(sh.poses), ref_p.poses, 0.0, DIST_POSE_ATOL, "sharded poses")
                      and check_same(fetch(sh.points), ref_p.points, 0.0, DIST_POINT_ATOL, "sharded points")),
        "rerun_bit_equal": bool(torch.equal(sh2.poses.local, sh.poses.local) and torch.equal(sh_cost2, sh_cost)),
    }
    blocked, layout, cstats, dropped = cluster.block_ba_problem_device(mesh, prob)
    dropped = int(pm.fetch_global(mesh, REPLICATED, dropped))
    if dropped or cstats["reshard_dropped_host"]:
        raise AssertionError(f"distributed: the relayout dropped {dropped} observations")
    b_slots = ps.layout_slots(mesh, layout)
    ps.ba_step_blocked(mesh, blocked, cfg, b_slots)  # warm-up
    solved_b, costs_b = without_sync(lambda: ps.ba_solve_blocked(mesh, blocked, cfg, b_slots))
    solved, costs = ba_solve(prob, cfg)
    points_b = torch.from_numpy(cluster.unblock_points(fetch(solved_b.points), layout)).to(DEV)
    again_b, costs_b2 = ps.ba_solve_blocked(mesh, blocked, cfg, b_slots)
    out["ba_solve_blocked"] = {
        "outer_iters": cfg.outer_iters, "cg_iters": cfg.cg_iters, "dropped": dropped,
        "block_size": layout.block_size, "obs_cap": layout.obs_cap,
        "bit_equal": (check_same(costs_b, costs, DIST_COST_RTOL, 0.0, "blocked costs")
                      and check_same(fetch(solved_b.poses), solved.poses, 0.0, DIST_POSE_ATOL, "blocked poses")
                      and check_same(points_b, solved.points, 0.0, DIST_POINT_ATOL, "blocked points")),
        "rerun_bit_equal": bool(torch.equal(again_b.poses.local, solved_b.poses.local)
                                and torch.equal(costs_b2, costs_b)),
    }
    if not (out["ba_step_sharded"]["rerun_bit_equal"] and out["ba_solve_blocked"]["rerun_bit_equal"]):
        raise AssertionError(f"distributed: BA reruns differ {out}")

    # The bytes one CG iteration reduces, counted on the collectives.
    def reduced(step, iters):
        mesh.reset_comm()
        step(dataclasses.replace(cfg, cg_iters=iters))
        torch.cuda.synchronize()
        return mesh.comm["all_reduce"]

    per_iter = {}
    for name, step in (("blocked", lambda c: ps.ba_step_blocked(mesh, blocked, c, b_slots)),
                       ("replicated", lambda c: ps.ba_step_sharded(mesh, prob, c, shard_slots))):
        (calls1, bytes1), (calls2, bytes2) = reduced(step, cfg.cg_iters), reduced(step, cfg.cg_iters + 1)
        per_iter[name] = {"bytes": bytes2 - bytes1, "all_reduce_calls": calls2 - calls1,
                          "all_reduce_calls_per_step": calls1,
                          "comm_bytes_per_cg_iter": cluster.comm_bytes_per_cg_iter(C, L, name == "blocked")}
        if per_iter[name]["bytes"] != per_iter[name]["comm_bytes_per_cg_iter"]:
            raise AssertionError(f"distributed: a {name} CG iteration reduced {per_iter[name]}")
    out["cg_iteration_reduces"] = per_iter
    steps = {"ba_step": lambda: ba_step(prob, cfg, *slots),
             "ba_step_sharded": lambda: ps.ba_step_sharded(mesh, prob, cfg, shard_slots),
             "ba_step_blocked": lambda: ps.ba_step_blocked(mesh, blocked, cfg, b_slots)}
    out["ba_ms_per_step"] = interleaved_ms(steps)
    out["ba_step_device"] = {k: device_summary(profile_device(fn)) for k, fn in steps.items()}

    # The ring over one descriptor a frame of phase ba's sequence.
    desc = torch.from_numpy(np.stack([
        pose_graph.frame_descriptor(make_icp_frame(cam, torch.from_numpy(d).to(DEV), icp_cfg))
        for d in slam._depths[:DIST_RING_K]])).to(DEV)
    ring = fetch(ps.ring_similarity(mesh, desc))
    out["ring"] = {"K": int(desc.shape[0]), "D": int(desc.shape[1]),
                   "bit_equal": check_same(ring, desc @ desc.T, DIST_RING_TOL, DIST_RING_TOL, "ring")}

    # The sharded Slam on phase ba's frames, against its call without mesh.
    (traj_mesh), got = counted_launches(lambda: slam.optimize(bundle_adjust=True, mesh=mesh))
    diff = float(np.abs(traj_mesh - traj).max())
    if not (traj_mesh.shape == traj.shape and diff <= DIST_POSE_ATOL):
        raise AssertionError(f"distributed: Slam with mesh differs from without by {diff}")
    out["slam_optimize_mesh"] = {"max_abs_diff": diff, "bit_equal": bool(np.array_equal(traj_mesh, traj)),
                                 "launches": got}

    out["distributed_slam"], launches["distributed_slam"] = dist_slam_phase(mesh, slam, gt, ate_slam)

    _build.reset_launch_counts()
    dryrun_multichip(1, device=DEV)
    torch.cuda.synchronize()
    tail = _build.launch_counts().get("icp_assoc_jtj_jtr", 0)
    if tail < 1:
        raise AssertionError("dryrun_multichip: its distributed_slam tail launched no fused ICP step")
    out["dryrun_multichip"] = {"ok": True, "distributed_slam_tail_fused_steps": tail}
    out["launches_on_sharded_paths"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    dist.destroy_process_group()
    emit("distributed", **out)
    return launches


# Phase cli: the command line a user starts the system with, called in this
# process (main(argv)) so that the launch counters see its work, over a
# 64-frame 640x480 directory that its own synth command writes. Phase
# sequence_parallel then tracks the same frames in four chunks.
CLI_FRAMES = 64
CLI_SIZE = (640, 480)
CLI_ODOM_ATE_TOL_M = SLAM_ATE_TOL_M
CLI_RESUME_TOL = 1e-6
ODOM_CHECKPOINT_AT = 50  # cli/main.py writes an odometry checkpoint every 50 frames
BA_FAIL_AT_ITER = 4
# Config 5 has no icp section: ba's odometry tracks with IcpConfig's
# defaults, 5 + 7 + 10 fused steps a frame.
DEFAULT_ICP_STEPS = sum(IcpConfig().iters_per_level)
# Sequence-parallel odometry over the first 32 of those frames: tracing the
# card for the busy share takes ~20 s a mode over all 64.
SEQ_FRAMES, SEQ_CHUNKS, SEQ_OVERLAP = 32, 4, 3
SEQ_PARALLEL_TOL = 1e-5  # the reference's own bound (tests/integration/test_sequence_parallel.py)
SEQ_ATE_TOL_M = 0.015  # ditto


def cli_run(*argv):
    """One command through the port's ``main(argv)``: (exit code, what it
    printed, wall seconds). An exception propagates."""
    import contextlib
    import io

    from rgbd_pose_estimation_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main([str(a) for a in argv])
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def counted(what, expected, *argv):
    """A command of the main path, the counters set to 0 just before it and
    read just after: exactly ``expected`` launches, nothing else."""
    _build.reset_launch_counts()
    rc, out, seconds = cli_run(*argv)
    counts = _build.launch_counts()
    expect_launches(counts, expected(), what)
    return rc, out, seconds, {k: v for k, v in counts.items() if v}


class _Recorded:
    """Records what ``module.name`` returns while the block runs."""

    def __init__(self, module, name):
        self.module, self.name, self.results = module, name, []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            self.results.append(out)
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def read_traj(path):
    from rgbd_pose_estimation_tpu_torch.eval.traj_io import read_tum_trajectory

    return read_tum_trajectory(str(path))[1]


def diff_report(a, b):
    return {"max_abs_diff": float(np.abs(a - b).max()), "bit_equal": bool(np.array_equal(a, b))}


def phase_cli(root):
    """synth, pair (configs 1 and 2), odom with the pose graph (config 3 and
    4's backend), eval, odom's resume across its checkpoint, ba in one
    process with its fault injection and resume. Returns the directory."""
    from rgbd_pose_estimation_tpu_torch.cli.main import _dataset_cam
    from rgbd_pose_estimation_tpu_torch.data import native_loader
    from rgbd_pose_estimation_tpu_torch.data.tum import TumSequence

    t_phase = time.perf_counter()
    configs = _ROOT / "configs"
    d = root / "synth"
    rc, _, synth_s = cli_run("synth", "--out", d, "--frames", CLI_FRAMES,
                             "--width", CLI_SIZE[0], "--height", CLI_SIZE[1])
    if rc != 0:
        raise AssertionError(f"cli synth: exit {rc}")
    cam, seq = _dataset_cam(str(d)), TumSequence(str(d))
    _, gt = seq.groundtruth_aligned()
    out = {"decoder": native_loader.decoder_name(), "frames": CLI_FRAMES,
           "width": cam.width, "height": cam.height, "seconds": {"synth": synth_s}}

    # pair: config 1 (3D-3D, kabsch: K2 + K3 + the refit) and config 2 (2D-3D: K5).
    T_ab = gt[1] @ np.linalg.inv(gt[0])
    pairs = {"config1_3d3d": ("config1_synthetic_ao_pair.yaml", "3d3d",
                              {"score_poses_3d3d_quad_fused": 1, "score_poses_3d3d": 1,
                               "horn_refit_3d3d": 1}),
             "config2_2d3d": ("config2_ransac_pnp_pair.yaml", "2d3d", {"score_poses_2d3d": 1})}
    out["pair"] = {}
    for name, (config, mode, launches) in pairs.items():
        rc, printed, seconds, counts = counted(
            f"cli pair {name}", lambda: launches, "pair", "--dataset", d, "--config", configs / config,
            "--mode", mode, "--detector", "tpu", "--intrinsics", "from_dataset")
        res = json.loads(printed)
        pose = np.asarray(res["pose"])
        err = float(np.abs(pose - T_ab).max())
        if rc != 0 or not res["valid"] or not err < FRAME_PAIR_TOL:
            raise AssertionError(f"cli pair {name}: exit {rc}, {res}, pose error {err}")
        out["pair"][name] = {"ms_estimate": res["ms_estimate"], "pose_err": err,
                             "num_matches": res["num_matches"], "num_inliers": res["num_inliers"],
                             "num_hypotheses": res["num_hypotheses"], "launches": counts}
        out["seconds"]["pair_" + name] = seconds

    # odom with the pose graph: 13 fused steps a tracked frame and a loop
    # candidate (config 3's ICP verifies the loops too), then eval.
    c3 = configs / "config3_dense_icp_odometry.yaml"
    steps = STEPS_PER_TRACK["config3"]
    full, metrics = root / "odom.txt", root / "odom.jsonl"
    with _Recorded(pose_graph, "loop_candidates") as cands:
        rc, printed, seconds, counts = counted(
            "cli odom --pose-graph",
            lambda: {"icp_assoc_jtj_jtr": steps * (CLI_FRAMES - 1 + sum(map(len, cands.results)))},
            "odom", "--dataset", d, "--out", full, "--config", c3, "--intrinsics", "from_dataset",
            "--pose-graph", "--metrics", metrics)
    summary = json.loads(printed)
    logged = [json.loads(line) for line in open(metrics)]
    ate = [r["ate_rmse"] for r in logged if "ate_rmse" in r]
    if rc != 0 or len(ate) != 1 or not ate[0] < CLI_ODOM_ATE_TOL_M:
        raise AssertionError(f"cli odom: exit {rc}, ATE {ate}")
    rc, printed, eval_s = cli_run("eval", "--est", full, "--gt", d / "groundtruth.txt")
    evaluated = json.loads(printed)
    if rc != 0 or evaluated["num_poses"] != CLI_FRAMES or not evaluated["ate_rmse"] < CLI_ODOM_ATE_TOL_M:
        raise AssertionError(f"cli eval: exit {rc}, {evaluated}")
    out["odom"] = {"frames_per_s_wall": CLI_FRAMES / seconds,
                   "frames_per_s_metrics": summary["frames_per_s"],
                   "keyframes": sum(1 for r in logged if r.get("keyframe")),
                   "loop_candidates": sum(map(len, cands.results)), "ate_m": ate[0],
                   "launches": counts, "eval": evaluated}
    out["seconds"].update(odom=seconds, eval=eval_s)

    # odom's resume: 50 frames, then --resume over all of them.
    resumed = root / "resumed.txt"
    common = ("--dataset", d, "--out", resumed, "--config", c3, "--intrinsics", "from_dataset")
    rc1, _, s1 = cli_run("odom", *common, "--max-frames", ODOM_CHECKPOINT_AT)
    rc2, _, s2 = cli_run("odom", *common, "--resume", "--pose-graph")
    resume = diff_report(read_traj(resumed), read_traj(full))
    if rc1 != 0 or rc2 != 0 or not resume["max_abs_diff"] <= CLI_RESUME_TOL:
        raise AssertionError(f"cli odom --resume: exits {rc1} {rc2}, {resume}")
    out["odom"]["resume_vs_one_run"] = resume
    out["seconds"].update(odom_first_50=s1, odom_resume=s2)

    # ba in one process: config 5's ba and frontend sections on a 1 x 1 mesh.
    c5 = root / "config5_one_device.yaml"
    c5.write_text((configs / "config5_distributed_ba.yaml").read_text()
                  .replace("hosts: 2", "hosts: 1").replace("chips_per_host: 4", "chips_per_host: 1"))
    ba_common = ("--dataset", d, "--config", c5, "--intrinsics", "from_dataset", "--detector", "tpu")
    ba_full, ba_metrics = root / "ba.txt", root / "ba.jsonl"
    rc, printed, seconds, counts = counted(
        "cli ba", lambda: {"icp_assoc_jtj_jtr": DEFAULT_ICP_STEPS * (CLI_FRAMES - 1)},
        "ba", *ba_common, "--out", ba_full, "--metrics", ba_metrics)
    one_run = json.loads(printed)
    costs = one_run["costs"]
    if (rc != 0 or not costs[-1] < costs[0]
            or not one_run["reproj_rmse_after"] < one_run["reproj_rmse_before"]):
        raise AssertionError(f"cli ba: exit {rc}, {one_run}")
    iters = [json.loads(line) for line in open(ba_metrics)]
    iter_ms = [r["ms"] for r in iters if "ba_iter" in r]

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    ckpt, ba_resumed = root / "ba.npz", root / "ba_resumed.txt"
    try:
        cli_run("ba", *ba_common, "--out", ba_resumed, "--checkpoint", ckpt,
                "--fail-at-iter", BA_FAIL_AT_ITER)
    except RuntimeError as e:
        if "fault injection" not in str(e):
            raise
    else:
        raise AssertionError("cli ba --fail-at-iter did not raise")
    rc, printed, resume_s = cli_run("ba", *ba_common, "--out", ba_resumed, "--checkpoint", ckpt,
                                    "--resume")
    again = json.loads(printed)
    ba_resume = {"costs": diff_report(np.asarray(again["costs"]), np.asarray(costs[BA_FAIL_AT_ITER + 1:])),
                 "trajectory": diff_report(read_traj(ba_resumed), read_traj(ba_full))}
    if rc != 0 or not max(v["max_abs_diff"] for v in ba_resume.values()) <= CLI_RESUME_TOL:
        raise AssertionError(f"cli ba --resume: exit {rc}, {ba_resume}")
    out["ba"] = {"keyframes": one_run["num_keyframes"], "landmarks": one_run["num_landmarks"],
                 "observations": one_run["num_observations"],
                 "costs_first_last": [costs[0], costs[-1]],
                 "reprojection_rmse_before_after": [one_run["reproj_rmse_before"],
                                                    one_run["reproj_rmse_after"]],
                 "ms_per_iteration": statistics.median(iter_ms), "ms_per_iteration_all": iter_ms,
                 "ate_m": ate_rmse(centers(read_traj(ba_full)), centers(gt)),
                 "launches": counts, "resume_vs_one_run": ba_resume}
    out["slam"], launches = cli_slam(root, d, cam, seq)
    out["seconds"].update(ba=seconds, ba_resume=resume_s, phase=time.perf_counter() - t_phase)
    emit("cli", **out)
    return d, launches


def cli_slam(root, d, cam, seq):
    """slam over the synth directory on the card: exit 0, the trajectory
    written and its ATE printed, exactly 22 fused steps a tracked frame and a
    verified candidate, the file of a direct distributed_slam call on the
    same decoded frames byte for byte; and --mesh-devices 2 on one card
    raises before any rank starts. Returns (record, fused-step launches)."""
    from rgbd_pose_estimation_tpu_torch.eval.traj_io import write_tum_trajectory
    from rgbd_pose_estimation_tpu_torch.models.distributed_slam import distributed_slam
    from rgbd_pose_estimation_tpu_torch.parallel import spawn
    from rgbd_pose_estimation_tpu_torch.parallel.mesh import make_mesh
    from rgbd_pose_estimation_tpu_torch.utils.metrics import MetricsLogger

    out_path, metrics = root / "slam.txt", root / "slam.jsonl"
    tracked = tracked_frames(CLI_FRAMES, DSLAM_CHUNKS, DSLAM_OVERLAP)

    def expected():
        cands = stage_of([json.loads(line) for line in open(metrics)], "loops")["candidates"]
        return {"icp_assoc_jtj_jtr": DEFAULT_ICP_STEPS * (tracked + cands)}

    rc, printed, seconds, counts = counted(
        "cli slam", expected, "slam", "--dataset", d, "--out", out_path, "--intrinsics", "from_dataset",
        "--detector", "tpu", "--metrics", metrics)
    res = json.loads(printed)
    logged = [json.loads(line) for line in open(metrics)]
    if rc != 0 or not out_path.exists() or "ate_rmse" not in res or not res["ate_rmse"] < SLAM_ATE_TOL_M:
        raise AssertionError(f"cli slam: exit {rc}, {res}")
    frames = [seq.frame(i) for i in range(CLI_FRAMES)]
    mesh = make_mesh(device=DEV)
    try:
        direct = distributed_slam(cam, [f[2] for f in frames], [f[1] for f in frames], mesh,
                                  PipelineConfig(), detector="tpu", metrics=MetricsLogger())
    finally:
        torch.distributed.destroy_process_group()
    write_tum_trajectory(str(root / "slam_direct.txt"), seq.timestamps[:CLI_FRAMES], direct)
    same_file = (root / "slam_direct.txt").read_bytes() == out_path.read_bytes()
    if not same_file:
        raise AssertionError(f"cli slam: differs from a direct call by {diff_report(read_traj(out_path), direct)}")

    # Two ranks need two cards: with one, the command raises before any starts.
    started = []
    run_ranks = spawn.run_ranks
    spawn.run_ranks = lambda *a: started.append(a) or [0, 0]
    try:
        cli_run("slam", "--dataset", d, "--out", root / "slam2.txt", "--mesh-devices", 2)
        two_cards = "no error"
    except ValueError as e:
        two_cards = f"ValueError: {e}"
    finally:
        spawn.run_ranks = run_ranks
    cards = torch.cuda.device_count()
    if cards < 2 and (started or not two_cards.startswith("ValueError")):
        raise AssertionError(f"cli slam --mesh-devices 2 on {cards} card: {two_cards}, ranks {started}")
    io_stage = stage_of(logged, "io")
    return {"exit": rc, "printed": res, "seconds": seconds, "frames_per_s_wall": CLI_FRAMES / seconds,
            "card": SMI, "tracked_frames": tracked,
            "candidates": stage_of(logged, "loops")["candidates"],
            "accepted_loops": stage_of(logged, "loops")["accepted"],
            "frames_decoded": io_stage["frames_decoded"], "launches": counts,
            "file_equals_direct_call": same_file,
            "mesh_devices_2_on_%d_card" % cards: two_cards}, counts["icp_assoc_jtj_jtr"]


def phase_sequence_parallel(d):
    """``sequence_parallel_odometry`` over the first frames of phase cli's
    directory with config 3's ICP, four chunks overlapping by three frames,
    the chunks in four host threads and one after another."""
    from rgbd_pose_estimation_tpu_torch.cli.main import _dataset_cam
    from rgbd_pose_estimation_tpu_torch.data.tum import TumSequence
    from rgbd_pose_estimation_tpu_torch.models.sequence_parallel import (
        chunk_ranges,
        sequence_parallel_odometry,
    )

    t_phase = time.perf_counter()
    cam, seq = _dataset_cam(str(d)), TumSequence(str(d))
    depths = [seq.frame(i)[2] for i in range(SEQ_FRAMES)]
    gt = seq.groundtruth_aligned()[1][:SEQ_FRAMES]
    c3 = load_yaml_config(_ROOT / "configs" / "config3_dense_icp_odometry.yaml")
    ranges = chunk_ranges(len(depths), SEQ_CHUNKS, SEQ_OVERLAP)
    tracked = sum(e - s - 1 for s, e in ranges)  # a chunk's first frame is not tracked
    expected = {"icp_assoc_jtj_jtr": tracked * STEPS_PER_TRACK["config3"]}

    def run(parallel):
        return sequence_parallel_odometry(cam, depths, n_chunks=SEQ_CHUNKS, overlap=SEQ_OVERLAP,
                                          icp_cfg=c3.icp, kf_cfg=c3.keyframe, parallel=parallel,
                                          return_keyframes=True, device=DEV)

    modes = {}
    for name, parallel in (("serial", False), ("parallel", True)):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        traj, kfs = run(parallel)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        expect_launches(_build.launch_counts(), expected, f"sequence_parallel {name}")
        # The card alone: tracing ~114k host ops from four threads takes minutes.
        on_device = device_summary(profile_device(lambda: run(parallel), host_ops=False))
        modes[name] = {"traj": traj, "keyframes": len(kfs), "seconds": seconds,
                       "frames_per_s": len(depths) / seconds,
                       "device_busy_ms": on_device["device_busy_ms"],
                       "device_launches": on_device["cuda_kernel_launches"]}

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    par, ser = modes["parallel"]["traj"], modes["serial"]["traj"]
    agree = diff_report(par, ser)
    ate = ate_rmse(centers(par), centers(gt))
    if not np.isfinite(par).all() or par.shape != (len(depths), 4, 4):
        raise AssertionError(f"sequence_parallel: trajectory {par.shape}")
    if not agree["max_abs_diff"] <= SEQ_PARALLEL_TOL or not ate < SEQ_ATE_TOL_M:
        raise AssertionError(f"sequence_parallel: parallel vs serial {agree}, ATE {ate}")
    for m in modes.values():
        busy = m["device_busy_ms"]
        m["device_busy_share"] = None if busy is None else busy / (m["seconds"] * 1e3)
        del m["traj"]
    emit("sequence_parallel", frames=len(depths), chunks=ranges, overlap=SEQ_OVERLAP,
         icp=vars(c3.icp), keyframe=vars(c3.keyframe), tracked_frames=tracked,
         icp_assoc_jtj_jtr_launches=expected["icp_assoc_jtj_jtr"],
         parallel_vs_serial=agree, ate_m=ate, modes=modes,
         phase_seconds=time.perf_counter() - t_phase)


def phase_scaling():
    """eval/scaling.py on the card at its defaults, one card: the step mode
    (K3 through score_poses_3d3d_sharded, 4096 hypotheses x 1024
    correspondences, a warm-up and 5 timed calls; the replicated and the
    blocked BA step at 2048 observations) and the slam mode (distributed_slam
    over 8 frames at 160x120, BA's features on the card). Returns K3's
    launches in the step mode."""
    from rgbd_pose_estimation_tpu_torch.eval import scaling

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    step = scaling.run(1)
    torch.cuda.synchronize()
    step_counts = {k: v for k, v in _build.launch_counts().items() if v}
    expect_launches(step_counts, {"score_poses_3d3d": 6}, "scaling step mode")
    _build.reset_launch_counts()
    slam = scaling.run_slam(1, detector="tpu")
    torch.cuda.synchronize()
    slam_counts = {k: v for k, v in _build.launch_counts().items() if v}
    if slam_counts.get("icp_assoc_jtj_jtr", 0) < 1 or set(slam_counts) != {"icp_assoc_jtj_jtr"}:
        raise AssertionError(f"scaling slam mode: launches {slam_counts}")
    emit("scaling", card=SMI, step=step, step_launches=step_counts, slam=slam, slam_launches=slam_counts)
    return step_counts["score_poses_3d3d"]


# ---------------------------------------------------------------------------
# The repository's remaining entry points: entry.py and the tools
# ---------------------------------------------------------------------------


# The engine's contract against another implementation on the same minimal
# sets (tests/test_torch_engine.py): the entry's pose against the plain path.
ENTRY_PLAIN_TOL = 2e-3


def phase_entry():
    """entry.py's flagship step (the counterpart of __graft_entry__.entry():
    estimate_pose_3d3d with RansacConfig(num_hypotheses=1024, threshold=0.05)
    on 512 correspondences, 30% outliers): one call under
    set_sync_debug_mode("error") launching K1, the Horn hypotheses, K2, K3
    and the refit once each, its ms by
    CUDA events; then the call captured once in a CUDA graph (the sampler's
    generator registered, as tools/roofline.py::timeit_chain captures the
    estimate), replayed, each replay's pose through the same gate. Returns
    the eager call's launches.

    K1, the Horn hypotheses, K2 and K3 are also held against their plain versions at the step's
    own shapes: its p and q (N = 512), the 1024 minimal sets a fresh
    sampler draws (the very sets of the eager call) and the hypotheses
    solved from them, and the 16 finalists the fast pass picks. And the
    eager pose against the whole plain path (CPU copies of the same minimal
    sets through ``_estimate_from_samples``), within the engine's 2e-3."""
    from rgbd_pose_estimation_tpu_torch.entry import CONFIG, entry, example_problem

    _, _, T_gt, inliers = example_problem()

    def err(pose):
        return float((pose - T_gt).abs().max())

    fn, args = entry()
    fn(*args)  # warm-up: the PROSAC windows, every PyTorch kernel of the path

    _, (gen, p, q) = entry()
    k = CONFIG.num_hypotheses
    idx = sample_minimal_sets(gen, p.shape[0], k, CONFIG.sample_size, CONFIG.prosac, device=DEV)
    if CONFIG.threshold != TAU or p.shape[0] % 128:
        raise AssertionError(f"entry: threshold {CONFIG.threshold}, N = {p.shape[0]} unpadded")
    T = check_hypotheses_bits(minimal_moments(idx, p, q), 4, "entry")
    feat, pn = rs._quad_features(T, p, q)
    top = max(16, k // 1024)
    fast = torch.nan_to_num(rs._quad_scores(feat, pn, TAU), nan=float("inf"))
    finalists = T[fast.reshape(top, k // top).argmin(1) + torch.arange(top, device=DEV) * (k // top)]
    kernel_checks = {
        "shape": f"K={k} N={p.shape[0]}, {top} finalists",
        "minimal_moments": check_moments(idx, p, q),
        "horn_hypotheses": "bit-equal",
        "score_poses_3d3d_quad_fused": check_quad(T, p, q, needs_nan_pose=False),
        "score_poses_3d3d": check_exact(finalists.contiguous(), p, q),
        "best_pose_3d3d winner, tensor-core vs CUDA-core K2": check_quad_winner(T, p, q),
    }
    plain = _estimate_from_samples(idx.cpu(), p.cpu(), q.cpu(), CONFIG)

    fn, args = entry()
    (pose, num_inliers), counts = counted_launches(lambda: without_sync(lambda: fn(*args)))
    expect_launches(counts, {name: 1 for name in ESTIMATE_KERNELS}, "entry")
    eager_err = err(pose)
    if not eager_err < POSE_TOL or pose.shape != (4, 4) or num_inliers.shape != ():
        raise AssertionError(f"entry: pose error {eager_err}, shapes {pose.shape} {num_inliers.shape}")
    plain_diff = float((pose.cpu() - plain.pose).abs().max())
    if not plain_diff <= ENTRY_PLAIN_TOL:
        raise AssertionError(f"entry: pose {plain_diff} from the plain path's (tolerance {ENTRY_PLAIN_TOL})")
    kernel_checks["pose vs the plain path"] = plain_diff
    kernel_checks["num_inliers, plain path"] = float(plain.num_inliers)
    ms = time_ms(lambda: fn(*args), reps=10, inner=3)

    fn, (gen, p, q) = entry()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(gen, p, q)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)

    def capture():
        with torch.cuda.graph(graph):
            return fn(gen, p, q)

    (g_pose, g_num), captured = counted_launches(capture)
    expect_launches(captured, {name: 1 for name in ESTIMATE_KERNELS}, "entry, captured")
    graph_errs, graph_inliers, graph_ms = [], [], []
    for _ in range(10):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        graph_ms.append(start.elapsed_time(stop))
        graph_errs.append(err(g_pose))
        graph_inliers.append(float(g_num))
    if not max(graph_errs) < POSE_TOL:
        raise AssertionError(f"entry, graph replays: pose errors {graph_errs}")
    emit("entry", card=SMI, config=vars(CONFIG), n=p.shape[0], true_inliers=int(inliers.sum()),
         pose_max_err=eager_err, num_inliers=float(num_inliers), ms_per_call=ms,
         launches=counts, kernel_checks=kernel_checks, graph={"launches_captured": captured, "replays": len(graph_ms),
                                 "ms_per_replay": statistics.median(graph_ms),
                                 "ms_samples": graph_ms, "pose_max_err": max(graph_errs),
                                 "num_inliers": graph_inliers})
    return counts


# The ICP experiments at full width: 10 frames at 640x480, config 3's stride.
TOOLS_FRAMES, TOOLS_SIZE = 10, (640, 480)
TOOLS_ATE_TOL_M = 0.01  # at weight 0, every reassoc_every


def byteswapped_copy(src, dst):
    """A copy of a TUM directory whose depth PNGs hold byteswapped values."""
    import shutil

    from rgbd_pose_estimation_tpu_torch.data import native_loader, png

    shutil.copytree(src, dst)
    for path in sorted((pathlib.Path(dst) / "depth").iterdir()):
        png.write_png(path, native_loader.decode_depth16(str(path)).byteswap())


def run_verify_dataset(root):
    import contextlib
    import io

    from rgbd_pose_estimation_tpu_torch.tools import verify_dataset

    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = verify_dataset.main(str(root))
    return {"exit": rc, "checks": [list(r) for r in verify_dataset._RESULTS],
            "printed_commands": [line for line in printed.getvalue().splitlines()
                                 if line.startswith(verify_dataset.CLI)]}


def phase_tools(cli_dir, scratch):
    """The two ICP experiments at full width (the reference's settings: the
    10-frame 640x480 hard-mode sequence, config 3's stride, the default 22
    Gauss-Newton steps a track), their tables printed; the launches of their
    accuracy loops counted from zero (every step of reassoc_exp and of the
    photometric weight 0 one fused step, every step at 0.1 and 0.5 one K4);
    each table's track times, CUDA-graph slopes (reassoc_exp.ROUNDS a
    setting, in turns; the tables and the record give the median and every
    sample).
    Then verify_dataset on phase cli's directory (exit 0) and on a
    byteswapped copy of it (exit 1). Returns the launches of the two
    accuracy loops."""
    from rgbd_pose_estimation_tpu_torch.tools import photometric_exp, reassoc_exp

    t_phase = time.perf_counter()
    W, H = TOOLS_SIZE
    cam = reassoc_exp.camera(H, W)
    tracks = TOOLS_FRAMES - 1
    steps = sum(IcpConfig().iters_per_level)
    out = {"card": SMI, "frames": TOOLS_FRAMES, "size": [W, H], "steps_per_track": steps}

    poses, depths, _ = reassoc_exp.hard_sequence(cam, reassoc_exp.SEED, TOOLS_FRAMES)
    cfgs = reassoc_exp.configs()
    rows, reassoc_counts = counted_launches(lambda: reassoc_exp.ate_rows(cam, poses, depths, cfgs))
    expect_launches(reassoc_counts, {"icp_assoc_jtj_jtr": steps * tracks * len(cfgs)}, "reassoc_exp")
    reassoc_samples = reassoc_exp.track_times(cam, cfgs, depths)
    print(f"reassoc_exp: hard sequence {TOOLS_FRAMES} frames {W}x{H}, "
          f"stride={cfgs[0].source_stride}; {SMI}", flush=True)
    print(reassoc_exp.table(rows, reassoc_samples), flush=True)
    ates = [row["ate_m"] for row in rows]
    if not all(np.isfinite(a) and a < TOOLS_ATE_TOL_M for a in ates):
        raise AssertionError(f"reassoc_exp: ATE {ates} (gate {TOOLS_ATE_TOL_M} m)")
    out["reassoc_exp"] = {"reassoc_every": [c.reassoc_every for c in cfgs], "ate_m": ates,
                          "track_ms_graph_median": [statistics.median(t) for t in reassoc_samples],
                          "track_ms_graph_samples": reassoc_samples,
                          "launches": reassoc_counts}

    pcfgs = photometric_exp.configs()
    (p_ates, (d0, i0)), photo_counts = counted_launches(
        lambda: photometric_exp.ate_table(cam, TOOLS_FRAMES, pcfgs))
    n_seeds = len(photometric_exp.SEEDS)
    expect_launches(photo_counts, {"icp_assoc_jtj_jtr": steps * tracks * n_seeds,
                                   "icp_jtj_jtr": steps * tracks * n_seeds * 2}, "photometric_exp")
    photo_samples = reassoc_exp.track_times(cam, pcfgs, d0, i0)
    print(f"photometric_exp: hard sequence {TOOLS_FRAMES} frames {W}x{H}, "
          f"stride={pcfgs[0].source_stride}, reassoc_every={photometric_exp.REASSOC}, "
          f"seeds={list(photometric_exp.SEEDS)}; {SMI}", flush=True)
    print(photometric_exp.table(pcfgs, p_ates, photo_samples), flush=True)
    if not all(np.isfinite(a) for per_seed in p_ates for a in per_seed):
        raise AssertionError(f"photometric_exp: ATE {p_ates}")
    # Weight 0 on seed 5 is reassoc_exp's k = 2 run again: the same bits.
    if p_ates[0][0] != rows[1]["ate_m"]:
        raise AssertionError(f"photometric_exp weight 0 {p_ates[0][0]} != reassoc_exp k = 2 {rows[1]['ate_m']}")
    out["photometric_exp"] = {"weights": [c.photometric_weight for c in pcfgs],
                              "seeds": list(photometric_exp.SEEDS), "ate_m": p_ates,
                              "track_ms_graph_median": [statistics.median(t) for t in photo_samples],
                              "track_ms_graph_samples": photo_samples,
                              "launches": photo_counts}

    swapped = scratch / "byteswapped"
    byteswapped_copy(cli_dir, swapped)
    checked = {"synth": run_verify_dataset(cli_dir), "byteswapped": run_verify_dataset(swapped)}
    if checked["synth"]["exit"] != 0 or checked["byteswapped"]["exit"] != 1:
        raise AssertionError(f"verify_dataset: {checked}")
    out["verify_dataset"] = checked
    out["seconds"] = time.perf_counter() - t_phase
    emit("tools", **out)
    return reassoc_counts, photo_counts


# ---------------------------------------------------------------------------
# The measurement harness: tools/msac_opt.py and tools/roofline.py, T1-T6
# ---------------------------------------------------------------------------

_CSRC = "rgbd_pose_estimation_tpu_torch/ops/csrc/"
# record name -> (launch name, source, TPU kernel it replaces)
HARNESS = {
    "variant_A": ("msac_variant_a", _CSRC + "msac_variants.cu", "tools/msac_opt.py:67"),
    "variant_C": ("msac_variant_c", _CSRC + "quad_score.cu", "tools/msac_opt.py:136"),
    "variant_M": ("msac_variant_m", _CSRC + "quad_mma.cu", "tools/msac_opt.py:199"),
    "variant_E_ceiling": ("msac_op_mix_ceiling", _CSRC + "ceilings.cu", "tools/msac_opt.py:257"),
    "variant_D": ("msac_variant_d", _CSRC + "msac_variants.cu", "tools/msac_opt.py:287"),
    "ceiling_vpu": ("fma_chain_ceiling", _CSRC + "ceilings.cu", "tools/roofline.py:167"),
}
QUAD_GAMMA = 1e-5  # per-entry error of the 17-term quad form, over its terms' magnitude


def check_direct_variant(m_out, c_out, m_ref, c_ref, what):
    """T1 and T5 against the exact plain scorer, as K3: scores rtol 1e-5 (N
    f32 terms in another order); counts equal except where a residual sits
    within rounding of tau^2: at most 1 apart, on at most 0.1% of poses."""
    err = max_abs_err(m_out, m_ref)  # raises unless NaN sits where the plain version has it
    assert_close(m_out, m_ref, 1e-5, 0.0, f"{what} msac")
    if c_out is not None:
        diff = (c_out - c_ref).abs()
        if float(diff.max()) > 1 or float((diff > 0).float().mean()) > 1e-3:
            raise AssertionError(f"{what} counts: max diff {float(diff.max())}, "
                                 f"{int((diff > 0).sum())} of {diff.numel()} poses differ")
    return err


def check_quad_variant(m, c, feat, pn, what, chunk=4096):
    """T2, T3 (and their plain versions) against float64 of the same f32
    features. The 17 terms of an entry, of order 10-50 (1e9 for a pad
    sentinel), cancel down to residuals near tau^2, so rounding is absolute
    at the terms' scale: with S the sum of an entry's absolute terms, an
    entry may move by QUAD_GAMMA*S. So a pose's score may differ from float64
    by QUAD_GAMMA*S summed over its entries below tau^2 + QUAD_GAMMA*S (plus
    1e-5 of the score for the N-term sum), and its count by the number of
    entries within QUAD_GAMMA*S of tau^2. NaN must sit where float64 has it,
    with count 0. Returns the largest score error as a share of its bound and
    the number of poses whose count differs from float64."""
    tau2 = TAU * TAU
    pn64 = pn.double()
    apn = pn64.abs()
    worst, differ = 0.0, 0
    for i in range(0, feat.shape[0], chunk):
        f = feat[i : i + chunk].double()
        e, bound = f @ pn64, QUAD_GAMMA * (f.abs() @ apn)
        nan = torch.isnan(e).any(dim=1)
        mi, ci = m[i : i + chunk].double(), c[i : i + chunk].double()
        if not torch.equal(torch.isnan(mi), nan) or bool((ci[nan] != 0).any()):
            raise AssertionError(f"{what}: NaN does not sit where float64 has it")
        m64 = torch.clamp(e, max=tau2).sum(1)
        c64 = (e < tau2).double().sum(1)
        mb = torch.where(e < tau2 + bound, bound, 0.0).sum(1) + 1e-5 * m64.abs()
        cb = ((e - tau2).abs() <= bound).double().sum(1)
        ok = ~nan
        over_m = (mi - m64).abs()[ok] > mb[ok]
        over_c = (ci - c64).abs()[ok] > cb[ok]
        if bool(over_m.any()) or bool(over_c.any()):
            raise AssertionError(f"{what}: {int(over_m.sum())} scores and {int(over_c.sum())} counts "
                                 f"beyond their bounds (rows {i}..)")
        worst = max(worst, float(((mi - m64).abs()[ok] / (mb[ok] + 1e-30)).max()))
        differ += int(((ci - c64)[ok] != 0).sum())
    return {"max_err_over_bound": worst, "counts_differ_vs_f64": differ}


def msac_variant_checks(T, p, q, label):
    """T1 and T5 at every poses-per-thread, T2 and T3 against their plain
    versions (and T2, T3 with their plain versions against float64) on one
    problem. Returns (check record, max |kernel - plain| by record name)."""
    from rgbd_pose_estimation_tpu_torch.ops import msac_variants as mv

    P = rs.pack_poses(T)
    feat, pn = rs._quad_features(T, p, q)
    m_ref, c_ref = chunked(lambda t: mv.variant_A_reference(t, p, q, TAU), P)
    check, err = {"shape": label}, {}
    for P_ in mv.POSES_PER_THREAD:
        m, c = mv.variant_A(P, p, q, TAU, poses_per_thread=P_)
        again = mv.variant_A(P, p, q, TAU, poses_per_thread=P_)
        torch.cuda.synchronize()
        if not (torch.equal(m.view(torch.int32), again[0].view(torch.int32)) and torch.equal(c, again[1])):
            raise AssertionError(f"variant_A poses/thread={P_}: two runs differ")
        err[f"variant_A[{P_}]"] = check_direct_variant(m, c, m_ref, c_ref, f"variant_A {label} P={P_}")
        d = mv.variant_D(P, p, q, TAU, poses_per_thread=P_)
        err[f"variant_D[{P_}]"] = check_direct_variant(d, None, m_ref, None, f"variant_D {label} P={P_}")
    for name, kernel, plain in (("variant_C", mv.quad_C, mv.quad_C_reference),
                                ("variant_M", mv.quad_M, mv.quad_M_reference)):
        m, c = kernel(feat, pn, TAU)
        mp, cp = chunked(lambda f: plain(f, pn, TAU), feat)
        if name == "variant_M":
            again = kernel(feat, pn, TAU)
            torch.cuda.synchronize()
            if not (torch.equal(m.view(torch.int32), again[0].view(torch.int32))
                    and torch.equal(c, again[1])):
                raise AssertionError(f"variant_M {label}: two runs differ")
        torch.cuda.synchronize()
        check[name] = check_quad_variant(m, c, feat, pn, f"{name} {label}")
        check[name + " (plain)"] = check_quad_variant(mp, cp, feat, pn, f"{name} plain {label}")
        # poses whose count differs from the f32 plain version's (each such
        # pose is within its float64 bound, checked above)
        check[name]["counts_differ_vs_plain"] = int((c != cp).sum())
        err[name] = max_abs_err(m, mp)
    check["max_abs_err_vs_plain"] = err
    return check, err


def t3_small_k_checks(T, p, q):
    """T3 at K = 1 and K = 65 against float64 and its plain version, with
    bit-equal reruns: a partial row tile, and one row past a tile (with the
    NaN pose 3)."""
    out = []
    for k in (1, 65):
        feat, pn = rs._quad_features(T[:k].contiguous(), p, q)
        m, c = mv.quad_M(feat, pn, TAU)
        again = mv.quad_M(feat, pn, TAU)
        mp, cp = mv.quad_M_reference(feat, pn, TAU)
        torch.cuda.synchronize()
        if not (torch.equal(m.view(torch.int32), again[0].view(torch.int32)) and torch.equal(c, again[1])):
            raise AssertionError(f"variant_M K={k}: two runs differ")
        rec = check_quad_variant(m, c, feat, pn, f"variant_M K={k} N={p.shape[0]}")
        rec.update(shape=f"K={k} N={p.shape[0]}", max_abs_err_vs_plain=max_abs_err(m, mp),
                   counts_differ_vs_plain=int((c != cp).sum()))
        out.append(rec)
    return {"variant_M small K": out}


# Bits of edge values for T3's split: ties at the 13th bit (both signs),
# just below and above one, a tie at the top of the range (rounds to inf),
# FLT_MAX, +-inf, NaN, subnormals (a tie, the smallest, the largest).
TF32_EDGE_BITS = (0x3F801000, 0x3F803000, 0xBF801000, 0x3F800FFF, 0x3F801001, 0x7F7FF000,
                  0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000, 0x00001000,
                  0x00000001, 0x807FFFFF, 0x00000000, 0x80000000)


def check_tf32_split(feat, pn):
    """T3 splits each operand x = hi + lo with cvt.rna.tf32.f32, held here
    against rounding by bits ((b + 0x1000) & ~0x1fff, inf kept, NaN made the
    quiet NaN). Both on the edge values, +-1e8 (the pad sentinels' size),
    65536 normal values of scale 30 and every entry of the main problem's
    feat and pn: hi and lo bit for bit, or both NaN (NaN inputs, whose
    payloads the two canonicalise differently, and inf - inf)."""
    g = generator(52)
    edge = torch.tensor([b - (1 << 32) if b >= 1 << 31 else b for b in TF32_EDGE_BITS],
                        dtype=torch.int32, device=DEV).view(torch.float32)
    x = torch.cat([edge, torch.tensor([1e8, -1e8, 1.23456789e8], device=DEV),
                   30.0 * torch.randn(65536, generator=g, device=DEV),
                   feat.reshape(-1), pn.reshape(-1)]).contiguous()
    out = torch.empty((x.numel(), 4), dtype=torch.int32, device=DEV)
    _build.launch("tf32_split_check", x.data_ptr(), out.data_ptr(), x.numel())
    torch.cuda.synchronize()
    def differ(a, b):
        nan = torch.isnan(a.view(torch.float32)) & torch.isnan(b.view(torch.float32))
        return int(((a != b) & ~nan).sum()), int(nan.sum())

    (hi_differ, hi_nan), (lo_differ, lo_nan) = differ(out[:, 0], out[:, 2]), differ(out[:, 1], out[:, 3])
    if hi_differ or lo_differ:
        raise AssertionError(f"cvt.rna split differs from the bit-level one: hi {hi_differ}, lo {lo_differ}")
    return {"values": x.numel(), "hi_differ": 0, "lo_differ": 0, "hi_both_nan": hi_nan,
            "lo_both_nan": lo_nan}


def probe_checks():
    """T4 and T6 against their plain versions: the same bits. T4 at its
    compiled-in 64 iterations and through its generic instance (3 and 7
    iterations), on full and ragged shapes."""
    from rgbd_pose_estimation_tpu_torch.ops import ceilings

    g = generator(51)
    checks = []
    ones = torch.ones((8, 2048), device=DEV)
    near = -0.5 + 0.02 * torch.randn((8, 2048), generator=g, device=DEV)
    ragged = -0.5 + 0.02 * torch.randn((5, 1000), generator=g, device=DEV)
    for x, reps in ((ones, 64), (near, 64), (ragged, 3), (ragged, 64), (near, 7)):
        out, ref = ceilings.msac_op_mix(x, reps), ceilings.msac_op_mix_reference(x, reps)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"msac_op_mix {tuple(x.shape)} reps={reps}: not the plain version's bits")
        checks.append({"probe": "variant_E_ceiling", "shape": list(x.shape), "reps": reps,
                       "counted": bool((ref >= 1.0).any()), "max_abs_err": 0.0})
    for shape in ((32768, 128), (1000, 7)):
        x = torch.ones(shape, device=DEV)
        out, ref = ceilings.fma_chain(x), ceilings.fma_chain_reference(x)
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and bool((out == 1.0).all())):
            raise AssertionError(f"fma_chain {shape}: not exactly 1.0")
        checks.append({"probe": "ceiling_vpu", "shape": list(shape), "max_abs_err": 0.0})
    return checks


def harness_records(T, p, q, err):
    """The kernels-line records of T1-T6 at the harness's shapes: K = 32768
    poses x N = 2048 (T1 and T5 at K3's poses a thread), T4 at (8, 2048) x 64
    iterations, T6 at (32768, 128). ``ms`` by CUDA events around the
    wrapper (T2, T3 on prebuilt features, as K2's record), ``device_ms`` the
    kernel alone under the profiler."""
    from rgbd_pose_estimation_tpu_torch.ops import ceilings
    from rgbd_pose_estimation_tpu_torch.ops import msac_variants as mv

    k, n = T.shape[0], p.shape[0]
    P = rs.pack_poses(T)
    feat, pn = rs._quad_features(T, p, q)
    x4 = torch.ones((8, 2048), device=DEV)
    x6 = torch.ones((32768, 128), device=DEV)
    f32, tf32 = PEAK_F32_FLOPS, 495e12
    quad_bytes = 4 * (17 * k + 17 * n + 2 * k)
    spec = {
        # name: (call, plain, library, bytes, op seconds, shape)
        "variant_A": (lambda: mv.variant_A(P, p, q, TAU),
                      lambda: chunked(lambda t: mv.variant_A_reference(t, p, q, TAU), P),
                      None, 4 * (14 * k + 6 * n), 23 * k * n / f32,
                      f"K={k} N={n}, {mv.K3_POSES_PER_THREAD} poses a thread"),
        "variant_C": (lambda: mv.quad_C(feat, pn, TAU),
                      lambda: chunked(lambda f: mv.quad_C_reference(f, pn, TAU), feat),
                      lambda: mv.variant_X(T, p, q, TAU, precision="highest"),
                      quad_bytes, (2 * 17 + 4) * k * n / f32, f"K={k} N={n}"),
        # three TF32 passes at the tensor-core peak, the epilogue at the f32 peak
        "variant_M": (lambda: mv.quad_M(feat, pn, TAU),
                      lambda: chunked(lambda f: mv.quad_M_reference(f, pn, TAU), feat),
                      lambda: mv.variant_X(T, p, q, TAU, precision="highest"),
                      quad_bytes, 3 * 2 * 17 * k * n / tf32 + 4 * k * n / f32, f"K={k} N={n}"),
        "variant_E_ceiling": (lambda: ceilings.msac_op_mix(x4, 64),
                              lambda: ceilings.msac_op_mix_reference(x4, 64),
                              None, 2 * 4 * x4.numel(), 23 * 64 * x4.numel() / f32, "(8, 2048), 64 iterations"),
        "variant_D": (lambda: mv.variant_D(P, p, q, TAU),
                      lambda: chunked(lambda t: mv.variant_D_reference(t, p, q, TAU), P),
                      None, 4 * (13 * k + 6 * n), 20 * k * n / f32,
                      f"K={k} N={n}, {mv.K3_POSES_PER_THREAD} poses a thread"),
        "ceiling_vpu": (lambda: ceilings.fma_chain(x6), lambda: ceilings.fma_chain_reference(x6),
                        None, 2 * 4 * x6.numel(), 2 * 256 * x6.numel() / f32, "(32768, 128)"),
    }
    records = []
    for name, (call, plain, library, nbytes, op_s, shape) in spec.items():
        launch_name, source, replaces = HARNESS[name]
        alone = [{"name": name, "device_ms": None}]
        set_device_ms(alone, profile_device(lambda: [call() for _ in range(20)]))
        byte_ms, op_ms = nbytes / PEAK_BYTES_S * 1e3, op_s * 1e3
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "shape": shape,
            "ms": time_ms(call),
            "device_ms": alone[0]["device_ms"],
            "plain_ms": time_ms(plain, reps=5, inner=1, warmup=1),
            "library_ms": None if library is None else time_ms(library, reps=10, inner=1),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "max_abs_err": err.get(name, 0.0),
        })
    return records


def phase_msac_opt():
    """The measurement harness on the card. First its kernels against their
    plain versions: T1 and T5 (every poses-per-thread), T2 and T3 at K =
    32768 hypotheses x N = 2048 bench correspondences (a NaN pose among
    them), at K = 1000 x N = 200, with 56 pad-sentinel rows (N = 256) and at
    N = 3001 (tiles of 256 rows, the last one ragged); T4 and T6 exactly.
    Then the harness itself, through its own entry points, with the
    counters set to 0 just before: the msac timing table at K = 4096 and
    32768 x N = 2048 (tools/msac_opt.py) and the four measured ceilings plus
    the T4 op-mix ceiling (tools/roofline.py). Each of T1-T6 must be
    launched there (counted once per capture into the timing graphs).
    Returns the T1-T6 records of the kernels line, T1's device time at every
    poses-per-thread, and the measured FMA ceiling (TFLOP/s)."""
    from rgbd_pose_estimation_tpu_torch.tools import msac_opt, roofline

    _, pp, qq, Tr = hypotheses(11, 1000, 200)
    checks = [msac_variant_checks(Tr, pp[:200].contiguous(), qq[:200].contiguous(), "K=1000 N=200")[0],
              msac_variant_checks(Tr, pp, qq, "K=1000 N=256 (56 pad sentinels)")[0]]
    _, pr, qr, Tr = hypotheses(16, 1000, 3001)
    checks.append(msac_variant_checks(Tr, pr[:3001].contiguous(), qr[:3001].contiguous(), "K=1000 N=3001")[0])
    _, p, q, T = hypotheses(12, K, N)
    main_check, err = msac_variant_checks(T, p, q, f"K={K} N={N}")
    checks.append(main_check)
    checks.append(t3_small_k_checks(T, p, q))
    checks.append({"tf32 split, cvt.rna vs bit-level": check_tf32_split(*rs._quad_features(T, p, q))})
    err = {"variant_A": err[f"variant_A[{mv.K3_POSES_PER_THREAD}]"],
           "variant_D": err[f"variant_D[{mv.K3_POSES_PER_THREAD}]"],
           "variant_C": err["variant_C"], "variant_M": err["variant_M"]}
    checks += probe_checks()
    records = harness_records(T, p, q, err)
    # T3 alone on the device at both sizes of the timing table.
    t3_device_ms = {}
    for kk in (4096, K):
        feat_k, pn_k = rs._quad_features(T[:kk].contiguous(), p, q)
        t3_device_ms[kk] = device_ms_alone("variant_M", lambda: mv.quad_M(feat_k, pn_k, TAU))
    P = rs.pack_poses(T)
    t1_device_ms = {
        P_: device_ms_alone("variant_A", lambda P_=P_: mv.variant_A(P, p, q, TAU, poses_per_thread=P_))
        for P_ in mv.POSES_PER_THREAD
    }

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    table = {kk: msac_opt.time_table(kk) for kk in (4096, 32768)}
    ceilings_measured = {
        "hbm_gbps": roofline.ceiling_hbm(),
        "fma_tflops": roofline.ceiling_vpu(),
        "op_mix_tflops": msac_opt.variant_E_ceiling(),
        "bf16_matmul_tflops": roofline.ceiling_mxu(dtype=torch.bfloat16),
        "f32_matmul_tflops": roofline.ceiling_mxu(dtype=torch.float32),
    }
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    for rec in records:
        rec["launches"] = counts[HARNESS[rec["name"]][0]]
        if rec["launches"] < 1:
            raise AssertionError(f"{rec['name']} was not launched by the harness")
    failed = [f"K={kk} {name}" for kk, rows in table.items() for name, s in rows.items() if s is None]
    if failed:
        raise AssertionError(f"msac timing rows failed: {failed}")
    fma = ceilings_measured["fma_tflops"]
    # T4 at a shape that fills the card (not on the main path), and alone
    # on the device at both shapes, beside its issue floor.
    op_mix_wide = msac_opt.variant_E_ceiling(N=131072)
    t4 = {"op_mix_tflops_8x131072": op_mix_wide}
    for n in (2048, 131072):
        x = torch.ones((8, n), device=DEV)
        t4[f"device_ms_8x{n}"] = device_ms_alone("variant_E_ceiling", lambda: ceilings.msac_op_mix(x, 64))
    sass = roofline.audit_t4_k4_sass()
    per_iteration = next(r["instructions_an_element_iteration"] for r in sass["T4"]
                         if r.get("reps") == ceilings.OP_MIX_REPS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor_cycles = 8 * 2048 * ceilings.OP_MIX_REPS * per_iteration / 32 / (4 * sms)
    mhz = max_sm_clock_mhz()
    t4["issue_floor_8x2048"] = {
        "sass_instructions_an_element_iteration": per_iteration, "cycles": floor_cycles,
        "max_sm_clock_mhz": mhz, "us_at_max_sm_clock": floor_cycles / mhz,
        "bound_us": ceilings.OP_MIX_FLOPS * 64 * 8 * 2048 / PEAK_F32_FLOPS * 1e6,
    }
    emit("msac_opt", checks=checks, harness_seconds=seconds, ceilings=ceilings_measured,
         variant_E_ceiling=t4, sass_T4_K4=sass,
         timing={str(kk): {name: {"us": s * 1e6, "tflops": 23 * kk * N / s / 1e12,
                                  "share_of_fma_ceiling": 23 * kk * N / s / 1e12 / fma}
                           for name, s in rows.items()}
                 for kk, rows in table.items()},
         launches={rec["name"]: rec["launches"] for rec in records},
         variant_A_device_ms_by_poses_per_thread=t1_device_ms,
         variant_M_device_ms_by_K=t3_device_ms, sass_T3_K1=roofline.audit_t3_k1_sass(),
         parity_K4096=msac_opt.parity(*msac_opt.problem(4096)))
    return records, t1_device_ms, fma, op_mix_wide


def max_sm_clock_mhz():
    """The card's highest SM clock, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])


def phase_exact_msac(rows, harness, t1_device_ms, fma_tflops, op_mix_tflops):
    """The exact MSAC scorers of msac_exact.cuh side by side (K3, K5, T1 at
    every poses-per-thread, T5), each alone on the device: its time, its
    bound (operations at the published f32 peak), and the share of the bound
    and of this run's measured f32 FMA ceiling (T6) that the reference's
    operation count over that time reaches. Beside them what the compiler
    made of each instance's inner loop: registers, spills and SASS
    instructions a pose-correspondence pair (``tools/roofline.py``)."""
    from rgbd_pose_estimation_tpu_torch.tools import roofline

    t5 = next(r for r in harness if r["name"] == "variant_D")
    rows = rows + [
        {"row": f"T1 K={K} x N={N}, {P_} poses a thread", "device_ms": ms, "ops": 23 * K * N}
        for P_, ms in t1_device_ms.items()
    ] + [{"row": f"T5 K={K} x N={N}, {mv.K3_POSES_PER_THREAD} poses a thread",
          "device_ms": t5["device_ms"], "ops": 20 * K * N}]
    for r in rows:
        ms = r["device_ms"]
        r["bound_ms"] = r["ops"] / PEAK_F32_FLOPS * 1e3
        r["share_of_bound"] = None if ms is None else r["bound_ms"] / ms
        r["share_of_fma_ceiling"] = None if ms is None else r["ops"] / (ms * 1e9) / fma_tflops
        r["share_of_op_mix_ceiling"] = None if ms is None else r["ops"] / (ms * 1e9) / op_mix_tflops
    emit("exact_msac", fma_ceiling_tflops=fma_tflops, op_mix_ceiling_tflops_8x131072=op_mix_tflops,
         rows=rows, sass=roofline.audit_exact_sass())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    global SMI
    smi = SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0)

    records, exact_rows = phase_kernels()
    counts, (p, q, T_gt) = phase_estimate()
    counts_2d3d, (pts, obs, _, ms_2d3d) = phase_estimate_2d3d()
    track_ms, k4_counts = phase_icp_track()
    odometry_counts = phase_odometry()
    phase_stages(p, q, records, track_ms["config3"])
    phase_stages_2d3d(pts, obs, ms_2d3d, records)
    phase_adaptive(p, q, T_gt)
    phase_reference()
    phase_frame_pair()
    phase_slam()
    dist_launches = phase_distributed(*phase_ba())
    import shutil
    import tempfile

    cli_root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        cli_dir, slam_command_launches = phase_cli(cli_root)
        phase_sequence_parallel(cli_dir)
        reassoc_launches, photometric_launches = phase_tools(cli_dir, cli_root)
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)
    scaling_k3 = phase_scaling()
    entry_launches = phase_entry()

    # Launches on each kernel's own main path, each counted from zero: the
    # 3D-3D estimates for K1-K3 and the Horn kernels, the 2D-3D estimates for K5, the synchronous
    # odometry run for the fused ICP step, and the photometric and bilinear
    # tracks for K4, the steps that still make their rows in PyTorch.
    paths = {"score_poses_2d3d": counts_2d3d, "icp_assoc_jtj_jtr": odometry_counts,
             "icp_jtj_jtr": k4_counts}
    for rec in records:
        rec["launches"] = paths.get(rec["name"], counts)[rec["name"]]
        if rec["launches"] < 1:
            raise AssertionError(f"{rec['name']} was not launched by the main path")
        if rec["name"] in dist_launches:  # K3, K4, the fused step: phase distributed
            rec["launches_sharded"] = dist_launches[rec["name"]]
        if rec["name"] == "icp_assoc_jtj_jtr":  # configuration 5 as one call and one command
            rec["launches_distributed_slam"] = dist_launches["distributed_slam"]
            rec["launches_slam_command"] = slam_command_launches
        if rec["name"] == "score_poses_3d3d":  # eval/scaling.py's step mode
            rec["launches_scaling_step"] = scaling_k3
        if rec["name"] in entry_launches:  # K1-K3, Horn: one call of entry.py's step
            rec["launches_entry"] = entry_launches[rec["name"]]
        if rec["name"] in reassoc_launches:  # the ICP experiments' accuracy loops
            rec["launches_reassoc_exp"] = reassoc_launches[rec["name"]]
        if rec["name"] in photometric_launches:
            rec["launches_photometric_exp"] = photometric_launches[rec["name"]]
    # T1-T6: launches of the harness phase, counted from zero there.
    harness, t1_device_ms, fma, op_mix = phase_msac_opt()
    records += harness
    phase_exact_msac(exact_rows, harness, t1_device_ms, fma, op_mix)
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
