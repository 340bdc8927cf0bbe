"""ba/ of the PyTorch port (the Schur-complement bundle adjustment and
``build_ba_problem``) against the JAX package's, on the CPU.

The synthetic problem is the reference's (8 cameras, 200 points, four
observations a point), converted with ``ba_problem_from_reference``; the
reference's step is called through ``jax.jit``, one signature a case.
``build_ba_problem`` runs both packages' on-device FAST+BRIEF detector over five 160x120
frames of the port's renderer, handed to both as numpy.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.ba import build as jbuild
from rgbd_pose_estimation_tpu.ba import schur as jschur
from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
from rgbd_pose_estimation_tpu.parallel import mesh as jmesh
from rgbd_pose_estimation_tpu.utils.config import BAConfig as JBAConfig
from rgbd_pose_estimation_tpu_torch.ba import build as tbuild
from rgbd_pose_estimation_tpu_torch.ba import schur as tschur
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence
from rgbd_pose_estimation_tpu_torch.features.frontend import match_descriptors
from rgbd_pose_estimation_tpu_torch.parallel.mesh import make_mesh, partition_bounds
from rgbd_pose_estimation_tpu_torch.utils.checkpoint import (
    load_ba_checkpoint,
    save_ba_checkpoint,
)
from rgbd_pose_estimation_tpu_torch.utils.convert import (
    ba_problem_from_reference,
    config_from_reference,
)

# Configuration 5's step (30 CG iterations). One step's CG runs past its
# convergence, where f32 rounding is amplified: at 25 iterations even the
# reference's two reductions (segment_sum, slots) and a float64 run part by
# up to 1.9e-4 on this problem; at 30 all of them agree within 1e-5.
JCFG = JBAConfig()
CFG = config_from_reference(JCFG)
COST_RTOL = 1e-5
STATE_ATOL = 1e-4
JAC_ATOL = 1e-6
C, L = 8, 200

# The reference's problem maker, pruning and RMSE, jitted: eager JAX
# compiles every primitive it meets.
make_problem_j = jax.jit(jschur.make_synthetic_ba_problem, static_argnums=(1, 2),
                         static_argnames=("pixel_noise",))
prune_j = jax.jit(jschur.prune_observations, static_argnums=(1,))
rmse_j = jax.jit(jschur.reprojection_rmse)


@pytest.fixture(scope="module")
def problem():
    """The reference's synthetic problem and its conversion to the port."""
    prob, T_gt, X_gt = make_problem_j(jax.random.key(0), C, L)
    return prob, ba_problem_from_reference(prob, "cpu"), np.asarray(T_gt), np.asarray(X_gt)


def _ref_slots(prob):
    cs = jschur.make_reduction_slots(np.asarray(prob.cam_idx), C)
    ls = jschur.make_reduction_slots(np.asarray(prob.lm_idx), L)
    return jnp.asarray(cs), jnp.asarray(ls)


def test_residual_jacobians_match_reference(problem):
    prob, p, _, _ = problem
    args = (prob.poses, prob.points, prob.cam_idx, prob.lm_idx, prob.obs, prob.obs_z)
    ref = jax.jit(jschur._residual_jacobians)(*args)
    out = tschur._residual_jacobians(p.poses, p.points, p.cam_idx, p.lm_idx, p.obs, p.obs_z)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=JAC_ATOL)
    # RGB-only rows: no depth residual and no depth Jacobian row.
    r_rgb, Jc, _ = tschur._residual_jacobians(p.poses, p.points, p.cam_idx, p.lm_idx, p.obs)
    assert not r_rgb[:, 2].any() and not Jc[:, 2].any()


def _slot_cases():
    rng = np.random.default_rng(3)
    balanced = rng.integers(0, 8, 800)
    skewed = np.concatenate([np.zeros(300, int), rng.integers(0, 50, 100)])
    return {
        "balanced": (balanced, 8),
        "per_landmark": (np.repeat(np.arange(200), 4), 200),
        "skewed_refused": (skewed, 50),
        "empty_segment": (np.array([5, 0, 3, 1, 0, 2, 5, 3, 1, 2]), 6),
        "no_rows": (np.zeros(0, int), 1),
    }


@pytest.mark.parametrize("case", list(_slot_cases()))
def test_reduction_slots_equal_reference_loop(case):
    """The vectorised table equals the reference's loop, its None included;
    at any inflation it sums exactly as the incidence product does."""
    idx, n = _slot_cases()[case]
    ref = jschur.make_reduction_slots(idx, n)
    out = tschur.make_reduction_slots(idx, n)
    assert (out is None) == (ref is None) == (case == "skewed_refused")
    if ref is not None:
        assert out.dtype == ref.dtype and np.array_equal(out, ref)
    full = tschur.make_reduction_slots(idx, n, max_inflation=None)
    x = torch.from_numpy(np.random.default_rng(0).integers(-4, 5, (len(idx), 3)).astype(np.float32))
    seg = torch.from_numpy(idx)
    want = tschur._seg_by_incidence(x, tschur._incidence(n, seg, torch.float32))
    assert torch.equal(tschur._seg_by_slots(x, torch.from_numpy(full).long()), want)


@pytest.mark.parametrize("slots", [False, True], ids=["incidence", "slots"])
@pytest.mark.parametrize("priors", [False, True], ids=["plain", "priors"])
def test_ba_step_matches_reference(problem, priors, slots):
    prob, p, _, _ = problem
    if priors:
        prob, p = jschur.with_odometry_priors(prob, 100.0), tschur.with_odometry_priors(p, 100.0)
    kw = dict(zip(("cam_slots", "lm_slots"), _ref_slots(prob))) if slots else {}
    ref, cost_ref = jax.jit(lambda q: jschur.ba_step(q, JCFG, **kw))(prob)
    kw = dict(zip(("cam_slots", "lm_slots"), tschur.reduction_slots(p))) if slots else {}
    out, cost = tschur.ba_step(p, CFG, **kw)
    assert cost.shape == () and out.poses.shape == (C, 4, 4)
    np.testing.assert_allclose(float(cost), float(cost_ref), rtol=COST_RTOL)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points), rtol=0, atol=STATE_ATOL)
    assert torch.equal(out.poses[0], p.poses[0])  # the gauge camera stays
    again, _ = tschur.ba_step(p, CFG, **kw)
    assert torch.equal(again.poses, out.poses) and torch.equal(again.points, out.points)


def test_ba_step_sum_hooks_sit_where_the_reference_puts_them(problem):
    """``psum=``/``psum_lm=`` (the sums over a mesh's ranks) at the
    reference's places: a hook that scales the cost and the camera-indexed
    sums, another the landmark-indexed ones, with the priors added after
    them; and the identity hooks leave the step bit for bit as it is."""
    prob, p = jschur.with_odometry_priors(problem[0], 100.0), tschur.with_odometry_priors(problem[1], 100.0)
    ref, cost_ref = jax.jit(lambda q: jschur.ba_step(
        q, JCFG, psum=lambda x: 2.0 * x, psum_lm=lambda x: 0.5 * x))(prob)
    out, cost = tschur.ba_step(p, CFG, psum=lambda x: 2.0 * x, psum_lm=lambda x: 0.5 * x)
    np.testing.assert_allclose(float(cost), float(cost_ref), rtol=COST_RTOL)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points), rtol=0, atol=STATE_ATOL)
    slots = tschur.reduction_slots(p)
    plain, plain_cost = tschur.ba_step(p, CFG, *slots)
    same, same_cost = tschur.ba_step(p, CFG, *slots, psum=lambda x: x, psum_lm=lambda x: x)
    assert torch.equal(plain.poses, same.poses) and torch.equal(plain.points, same.points)
    assert torch.equal(plain_cost, same_cost)


def test_prune_rmse_and_priors_match_reference(problem):
    prob, p, _, _ = problem
    ref = jschur.with_odometry_priors(prob, 50.0, edges=[(0, 1), (2, 7)])
    out = tschur.with_odometry_priors(p, 50.0, edges=[(0, 1), (2, 7)])
    for name in ("prior_i", "prior_j", "prior_w"):
        assert np.array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(out.prior_T_inv.numpy(), np.asarray(ref.prior_T_inv), atol=1e-6)
    assert tschur.with_odometry_priors(p, 50.0, edges=[]) is p
    default = tschur.with_odometry_priors(p, 50.0)
    assert default.prior_i.tolist() == list(range(C - 1)) and default.prior_j.tolist() == list(range(1, C))
    # Move the points so that some residuals pass the bound.
    bad = prob._replace(points=prob.points + 0.05 * jnp.sin(jnp.arange(3 * L).reshape(L, 3)))
    pb = ba_problem_from_reference(bad, "cpu")
    ref_pruned = prune_j(bad, 0.03)
    pruned = tschur.prune_observations(pb, 0.03)
    assert np.array_equal(pruned.w.numpy(), np.asarray(ref_pruned.w))
    assert 0 < int((pruned.w == 0).sum()) - int((pb.w == 0).sum()) < len(pb.w)
    for q, qr in ((pb, bad), (pruned, ref_pruned)):
        np.testing.assert_allclose(
            float(tschur.reprojection_rmse(q)), float(rmse_j(qr)), rtol=1e-5
        )


@jax.jit
def _reference_draws(key):
    """The reference maker's random draws, split and drawn as it does."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    O = 4 * L
    return {
        "xi": jax.random.normal(k1, (C, 6)),
        "X": jax.random.uniform(k2, (L, 3), minval=-1.5, maxval=1.5),
        "cam_idx": jax.random.randint(k3, (L, 4), 0, C).reshape(-1),
        "obs_noise": jax.random.normal(k4, (O, 2)),
        "z_noise": jax.random.normal(k4, (O,)),
        "dxi": jax.random.normal(k5, (C, 6)),
        "X_noise": jax.random.normal(k6, (L, 3)),
    }


def test_synthetic_problem_takes_reference_draws(problem):
    """The reference's draws in, the reference's problem out; from a
    torch.Generator, the same distribution and reruns equal."""
    prob, _, T_gt, X_gt = problem
    draws = _reference_draws(jax.random.key(0))
    out, T, X = tschur.make_synthetic_ba_problem(
        None, C, L, draws={k: np.asarray(v) for k, v in draws.items()}, device="cpu"
    )
    np.testing.assert_allclose(T.numpy(), T_gt, atol=1e-6)
    np.testing.assert_allclose(X.numpy(), X_gt, atol=0)
    for name in ("cam_idx", "lm_idx", "w"):
        assert np.array_equal(getattr(out, name).numpy(), np.asarray(getattr(prob, name)))
    for name in ("poses", "points", "obs", "obs_z"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(prob, name)), atol=1e-5)
    a, _, _ = tschur.make_synthetic_ba_problem(torch.Generator().manual_seed(4), C, L, device="cpu")
    b, _, _ = tschur.make_synthetic_ba_problem(torch.Generator().manual_seed(4), C, L, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[:7], b[:7]))
    assert a.cam_idx.dtype == torch.int32 and int(a.cam_idx.max()) < C and float(a.w.mean()) > 0.9


def test_ba_solve_converges_keeps_gauge_and_ignores_zero_weights(problem):
    """The reference's own ``ba_solve`` tests, on the port: noise-free
    observations bring the poses back to the truth (the reference's 5e-3
    bound), the gauge camera stays, corrupted rows of weight 0 change
    nothing."""
    prob, p, T_gt, _ = problem
    cfg = dataclasses.replace(CFG, damping=1e-5)
    clean, T_clean, _ = make_problem_j(jax.random.key(1), C, L, pixel_noise=0.0)
    out, costs = tschur.ba_solve(ba_problem_from_reference(clean, "cpu"), cfg)
    assert costs.shape == (cfg.outer_iters,) and float(costs[-1]) < float(costs[0])
    assert float((out.poses - torch.from_numpy(np.array(T_clean))).abs().max()) < 5e-3
    bad = torch.arange(p.w.shape[0]) < p.w.shape[0] // 2
    corrupt = p._replace(obs=torch.where(bad[:, None], p.obs + 100.0, p.obs), w=torch.where(bad, 0.0, p.w))
    base = p._replace(w=corrupt.w)
    a, _ = tschur.ba_solve(corrupt, CFG)
    b, _ = tschur.ba_solve(base, CFG)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.poses[0], p.poses[0])
    assert float(tschur.reprojection_rmse(b)) < float(tschur.reprojection_rmse(base))
    _, no_steps = tschur.ba_solve(p, dataclasses.replace(CFG, outer_iters=0))
    assert no_steps.shape == (0,)


# --- build_ba_problem ---------------------------------------------------------

W, H = 160, 120
CAM = CameraIntrinsics(W * 1.0, W * 1.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
KEYFRAMES = 5
LOOP_PAIRS = [(0, 3), (1, 4)]


@pytest.fixture(scope="module")
def keyframes():
    """Five 160x120 frames of the port's renderer and their poses, perturbed
    by up to 2 mm / 2 mrad (as odometry would hand them over)."""
    g = torch.Generator().manual_seed(11)
    poses, depths, intens = synthetic_sequence(CAM, g, KEYFRAMES, motion_scale=0.015, device="cpu")
    xi = torch.from_numpy(np.random.default_rng(0).normal(size=(KEYFRAMES, 6)).astype(np.float32) * 0.002)
    xi[0] = 0.0
    noisy = (se3_exp(xi) @ poses).numpy()
    return [i.numpy() for i in intens], [d.numpy() for d in depths], noisy


@pytest.fixture(scope="module")
def built(keyframes):
    grays, depths, poses = keyframes
    args = (grays, depths, poses, LOOP_PAIRS)
    ref = jbuild.build_ba_problem(JCamera(CAM.fx, CAM.fy, CAM.cx, CAM.cy, W, H), *args, detector="tpu")
    out = tbuild.build_ba_problem(CAM, *args, detector="tpu", device="cpu")
    return ref, out


def test_build_ba_problem_matches_reference(built):
    (ref, info_ref), (out, info) = built
    assert info == info_ref
    assert info["num_landmarks"] > 50 and info["mean_track_len"] >= 2.0
    for name in ("cam_idx", "lm_idx", "w", "obs_z"):
        o, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert o.dtype == r.dtype and np.array_equal(o, r), name
    for name in ("obs", "points", "poses"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), rtol=0, atol=1e-5)
    assert out.prior_i is None and len(out.w) % 8 == 0


def test_batched_matching_equals_per_pair_loop(keyframes):
    """All pairs in one call: the reference's per-pair matches, and the
    port's own per-pair calls, exactly."""
    grays, depths, _ = keyframes
    uv, desc, valid, z = tbuild.detect_keyframe_features(grays, depths, 512, "tpu", device="cpu")
    pairs = [(i, i + 1) for i in range(KEYFRAMES - 1)] + LOOP_PAIRS
    stats = {}
    idx, good = tbuild.match_keyframe_pairs(desc, valid, pairs, stats=stats, device="cpu")
    idx_ref, good_ref = jbuild.match_keyframe_pairs(desc, valid, pairs)
    assert np.array_equal(idx, idx_ref) and np.array_equal(good, good_ref) and good.sum() > 100
    assert stats == {"match_pairs_local": len(pairs)}
    d, v = torch.from_numpy(desc), torch.from_numpy(valid)
    for k, (a, b) in enumerate(pairs):
        ib, g, _ = match_descriptors(d[a], v[a], d[b], v[b])
        assert np.array_equal(ib.numpy(), idx[k]) and np.array_equal(g.numpy(), good[k])
    empty = tbuild.match_keyframe_pairs(desc, valid, [], device="cpu")
    assert empty[0].shape == (0, 512)
    # On a mesh of one rank (a gloo group of world size 1) the process-
    # sharded matching is the whole matching, through the all-gather.
    mesh = make_mesh(device="cpu")
    try:
        stats_mesh = {}
        idx_mesh, good_mesh = tbuild.match_keyframe_pairs(desc, valid, pairs, mesh=mesh,
                                                          stats=stats_mesh, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    assert np.array_equal(idx_mesh, idx) and np.array_equal(good_mesh, good)
    assert stats_mesh == stats
    for n, procs in ((16, 1), (16, 3), (5, 8)):
        assert np.array_equal(partition_bounds(n, procs), jmesh.partition_bounds(n, procs))


def test_resume_after_fault_matches_uninterrupted(built, tmp_path):
    """The reference's resume test (``tests/integration/test_ba_pipeline.py``),
    on the port: four steps at once equal two, a checkpoint, a reload and two
    more. Also the solve lowers the reprojection error of the built
    problem."""
    _, (prob, _) = built
    cfg = dataclasses.replace(CFG, cg_iters=10)
    slots = tschur.reduction_slots(prob)
    p_full = prob
    for _ in range(4):
        p_full, _ = tschur.ba_step(p_full, cfg, *slots)
    p_half = prob
    for _ in range(2):
        p_half, _ = tschur.ba_step(p_half, cfg, *slots)
    path = str(tmp_path / "ba.npz")
    save_ba_checkpoint(path, poses=p_half.poses.numpy(), points=p_half.points.numpy(), iter=np.int64(2))
    state = load_ba_checkpoint(path)
    assert int(state["iter"]) == 2 and load_ba_checkpoint(str(tmp_path / "none.npz")) is None
    p_res = prob._replace(poses=torch.from_numpy(state["poses"]), points=torch.from_numpy(state["points"]))
    for _ in range(4 - int(state["iter"])):
        p_res, _ = tschur.ba_step(p_res, cfg, *slots)
    np.testing.assert_allclose(p_res.poses.numpy(), p_full.poses.numpy(), atol=1e-6)
    assert float(tschur.reprojection_rmse(p_full)) < float(tschur.reprojection_rmse(prob))
