"""ba/cluster.py's host layout in the PyTorch port, array for array equal
to the JAX package's: the landmark clustering, the blocked problem (its
landmark and observation permutations and every field), the inverse
permutation of the points, and the collective payload of a CG iteration.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_pose_estimation_tpu.ba import cluster as jcluster
from rgbd_pose_estimation_tpu.ba.schur import BAProblem as JBAProblem
from rgbd_pose_estimation_tpu_torch.ba import cluster
from rgbd_pose_estimation_tpu_torch.ba.schur import BAProblem, with_odometry_priors


def _problem(seed, C, L, O, dead=0):
    """Random indices (some landmarks seen by a few consecutive cameras),
    ``dead`` observations of weight 0, and random states."""
    rng = np.random.default_rng(seed)
    lm = rng.integers(0, L, O).astype(np.int32)
    cam = np.clip(lm * C // L + rng.integers(-2, 3, O), 0, C - 1).astype(np.int32)
    w = np.ones(O, np.float32)
    w[rng.choice(O, dead, replace=False)] = 0.0
    poses = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(C, 3))
    fields = {"poses": poses, "points": rng.normal(size=(L, 3)).astype(np.float32),
              "cam_idx": cam, "lm_idx": lm, "obs": rng.normal(size=(O, 2)).astype(np.float32),
              "w": w, "obs_z": rng.uniform(0.5, 3.0, O).astype(np.float32)}
    return BAProblem(**{k: torch.from_numpy(v) for k, v in fields.items()})


PROBLEMS = {
    "small": dict(seed=0, C=8, L=200, O=800),
    "pruned": dict(seed=1, C=12, L=300, O=1000, dead=150),
    "wide": dict(seed=2, C=40, L=2000, O=6000),
}


def _reference(prob):
    return JBAProblem(**{k: None if v is None else jnp.asarray(v.numpy())
                         for k, v in prob._asdict().items()})


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_cluster_landmarks_equals_reference(name, n):
    prob = _problem(**PROBLEMS[name])
    args = (prob.cam_idx.numpy(), prob.lm_idx.numpy(), prob.w.numpy(),
            prob.points.shape[0], prob.poses.shape[0], n)
    block, stats = cluster.cluster_landmarks(*args)
    block0, stats0 = jcluster.cluster_landmarks(*args)
    np.testing.assert_array_equal(block, block0)
    assert stats == stats0


@pytest.mark.parametrize("name,n,priors", [("small", 4, False), ("pruned", 3, True),
                                           ("wide", 4, True)])
def test_block_ba_problem_and_unblock_equal_reference(name, n, priors):
    prob = _problem(**PROBLEMS[name])
    if priors:
        prob = with_odometry_priors(prob, 100.0)
    blocked, layout, stats = cluster.block_ba_problem(prob, n)
    blocked0, layout0, stats0 = jcluster.block_ba_problem(_reference(prob), n)
    for k in ("lm_perm", "obs_perm", "n_shards", "block_size", "obs_cap", "num_landmarks",
              "num_observations", "cam_slots", "lm_slots"):
        np.testing.assert_array_equal(getattr(layout, k), getattr(layout0, k))
    assert stats == stats0
    for k, v in blocked._asdict().items():
        v0 = getattr(blocked0, k)
        assert (v is None) == (v0 is None), k
        if v is not None:
            assert v.numpy().dtype == np.asarray(v0).dtype, k
            np.testing.assert_array_equal(v.numpy(), np.asarray(v0), err_msg=k)
    np.testing.assert_array_equal(cluster.unblock_points(blocked.points, layout),
                                  jcluster.unblock_points(blocked0.points, layout0))
    np.testing.assert_array_equal(cluster.unblock_points(blocked.points, layout),
                                  prob.points.numpy())


@pytest.mark.parametrize("C,L", [(8, 200), (64, 24576), (1, 1)])
def test_comm_bytes_per_cg_iter_equals_reference(C, L):
    for blocked in (True, False):
        for dtype_bytes in (4, 8):
            assert (cluster.comm_bytes_per_cg_iter(C, L, blocked, dtype_bytes)
                    == jcluster.comm_bytes_per_cg_iter(C, L, blocked, dtype_bytes))
    assert cluster.comm_bytes_per_cg_iter(C, L, True) == C * 6 * 4
