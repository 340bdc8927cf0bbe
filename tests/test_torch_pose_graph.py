"""graph/pose_graph.py of the PyTorch port against the JAX package's, on the
CPU: Gauss-Newton over a K = 8 ring with a loop edge (dense Cholesky and
block-Jacobi PCG), the backend choice, and loop-candidate search on the
drifted-loop keyframes of the JAX package's own test.

The graph is built in numpy and handed to both. The reference's optimizer
is jitted by the JAX package (one compile a config and shape: two here).
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.graph import pose_graph as jpg
from rgbd_pose_estimation_tpu.models.odometry import Keyframe as JKeyframe
from rgbd_pose_estimation_tpu.utils.config import PoseGraphConfig as JPoseGraphConfig
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_depth_scene
from rgbd_pose_estimation_tpu_torch.graph import pose_graph as tpg
from rgbd_pose_estimation_tpu_torch.icp.dense import make_icp_frame
from rgbd_pose_estimation_tpu_torch.models.odometry import Keyframe
from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig
from rgbd_pose_estimation_tpu_torch.utils.convert import config_from_reference, to_numpy

K = 8
ITERS = 8
# Both solve the same f32 normal equations (the gauge prior 1e6 beside
# weights of 1-10) with sums in different orders: poses agree to 1e-4, and
# the per-iteration costs to a relative 1e-4.
POSE_ATOL = 1e-4
COST_RTOL = 1e-4
CONFIGS = {
    "dense": JPoseGraphConfig(iters=ITERS, solver="dense"),
    "pcg": JPoseGraphConfig(iters=ITERS, solver="pcg", pcg_iters=60),
}


def _exp(xi):
    return se3_exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()


def _inv(T):
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def _ring_problem(k=K, noise=0.02, seed=0):
    """A noisy loop: k poses around a circle, odometry edges of weight 1 and
    an exact loop edge of weight 10 back to the start (the JAX package's
    ring problem, tests/unit/test_pose_graph.py)."""
    rng = np.random.default_rng(seed)
    step = _exp([0.3, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / k])
    T_gt = [np.eye(4, dtype=np.float32)]
    for _ in range(k - 1):
        T_gt.append(step @ T_gt[-1])
    ei, ej, Tm, w = [], [], [], []
    for a in range(k - 1):
        M = T_gt[a] @ _inv(T_gt[a + 1])
        Tm.append(_exp(rng.normal(size=6) * noise) @ M)
        ei.append(a)
        ej.append(a + 1)
        w.append(1.0)
    Tm.append(T_gt[0] @ _inv(T_gt[-1]))
    ei.append(0)
    ej.append(k - 1)
    w.append(10.0)
    T0 = [np.eye(4, dtype=np.float32)]
    for e in range(k - 1):
        T0.append(_inv(Tm[e]) @ T0[-1])
    return (np.stack(T_gt), np.stack(T0).astype(np.float32), np.asarray(ei, np.int32),
            np.asarray(ej, np.int32), np.stack(Tm).astype(np.float32), np.asarray(w, np.float32))


@pytest.fixture(scope="module")
def ring():
    return _ring_problem()


@pytest.fixture(scope="module")
def port_runs(ring):
    _, *args = ring
    tensors = [torch.from_numpy(a) for a in args]
    return {name: tpg.optimize_pose_graph(*tensors, config_from_reference(cfg))
            for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("solver", list(CONFIGS))
def test_optimize_pose_graph_matches_reference(ring, port_runs, solver):
    T_gt, *args = ring
    T_ref, costs_ref = (np.asarray(x) for x in jpg.optimize_pose_graph(
        *(jnp.asarray(a) for a in args), CONFIGS[solver]))
    T_opt, costs = to_numpy(port_runs[solver])
    assert T_opt.shape == (K, 4, 4) and costs.shape == (ITERS,)
    np.testing.assert_allclose(T_opt, T_ref, atol=POSE_ATOL)
    np.testing.assert_allclose(costs, costs_ref, rtol=COST_RTOL)
    # The optimizer does its job: cost falls, the end pose moves toward the
    # truth, and node 0 stays where the gauge prior holds it.
    assert costs[-1] < 0.5 * costs[0]
    assert np.abs(T_opt[-1] - T_gt[-1]).max() < np.abs(args[0][-1] - T_gt[-1]).max()
    np.testing.assert_allclose(T_opt[0], args[0][0], atol=1e-3)


def test_pcg_matches_dense_and_auto_picks_dense(ring, port_runs):
    """The two backends agree (the JAX package's own PCG test bound); "auto"
    takes the dense path at K ≤ dense_max_nodes, bit for bit; an unknown
    solver raises."""
    _, *args = ring
    tensors = [torch.from_numpy(a) for a in args]
    (T_d, c_d), (T_p, c_p) = port_runs["dense"], port_runs["pcg"]
    np.testing.assert_allclose(T_p.numpy(), T_d.numpy(), atol=2e-4)
    np.testing.assert_allclose(c_p.numpy(), c_d.numpy(), rtol=1e-3)
    auto = config_from_reference(dataclasses.replace(CONFIGS["dense"], solver="auto"))
    T_a, c_a = tpg.optimize_pose_graph(*tensors, auto)
    assert torch.equal(T_a, T_d) and torch.equal(c_a, c_d)
    with pytest.raises(ValueError, match="unknown pose-graph solver"):
        tpg.optimize_pose_graph(*tensors, dataclasses.replace(auto, solver="qr"))


def test_perfect_input_is_a_fixed_point(ring):
    T_gt, _, ei, ej, _, w = ring
    Tm = np.stack([T_gt[a] @ _inv(T_gt[b]) for a, b in zip(ei, ej)]).astype(np.float32)
    tensors = [torch.from_numpy(a) for a in (T_gt.astype(np.float32), ei, ej, Tm, w)]
    T_opt, costs = tpg.optimize_pose_graph(*tensors, config_from_reference(JPoseGraphConfig(iters=3)))
    np.testing.assert_allclose(costs.numpy(), 0.0, atol=1e-3)
    np.testing.assert_allclose(T_opt.numpy(), T_gt, atol=1e-3)


@pytest.fixture(scope="module")
def drifted_loop_keyframes():
    """The JAX package's drifted-loop case (tests/unit/test_pose_graph.py):
    keyframes 0-5 wander, keyframe 6 sees keyframe 0's view, but its
    estimated pose is drifted 2 m away. Rendered and built by the port at
    80x60 (three levels), and handed to the reference as numpy pyramids."""
    cam = CameraIntrinsics(60.0, 60.0, 39.5, 29.5, 80, 60)
    cfg = IcpConfig()
    views = [_exp([0.3 * i, 0, 0, 0, 0.15 * i, 0]) for i in range(6)] + [np.eye(4, dtype=np.float32)]
    ports, refs = [], []
    for i, T in enumerate(views):
        d, _ = synthetic_depth_scene(cam, torch.from_numpy(T))
        frame = make_icp_frame(cam, d, cfg)
        pose = T.copy()
        if i == 6:
            pose[:3, 3] += np.asarray([2.0, 2.0, 0.0], np.float32)  # drift
        ports.append(Keyframe(i, pose, frame))
        refs.append(JKeyframe(i, pose.copy(), to_numpy(frame)))
    return ports, refs


def test_loop_candidates_match_reference(drifted_loop_keyframes):
    ports, refs = drifted_loop_keyframes
    for kw in ({"max_dist": 0.5, "min_gap": 2}, {"max_dist": 2.0, "min_gap": 1}):
        pairs = tpg.loop_candidates(ports, max_candidates=20, **kw)
        assert pairs == jpg.loop_candidates(refs, max_candidates=20, **kw)
    assert (0, 6) in tpg.loop_candidates(ports, 0.5, 2, 20)  # the appearance cue
    for k_port, k_ref in zip(ports, refs):
        np.testing.assert_array_equal(k_port.descriptor, k_ref.descriptor)
    desc = tpg.keyframe_descriptor(ports[0])
    assert tpg.keyframe_descriptor(ports[0]) is desc  # cached
    assert abs(np.linalg.norm(desc) - 1.0) < 1e-5 and desc.shape == (tpg.DESCRIPTOR_DIM,)
