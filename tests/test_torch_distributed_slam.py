"""models/distributed_slam.py and the ``mesh=`` path of
models/sequence_parallel.py of the PyTorch port, on two gloo ranks, against
the JAX package's ``distributed_slam`` on a 2-device virtual CPU mesh.

One group of two rank processes (``tests/_torch_ranks.py``, suite
``dslam``) runs the port while this process computes the references: the
JAX pipeline once, without BA, over a 6-frame 64x48 rendered sequence with
every frame a keyframe (``kf_stride=1``, so that the ring finds loop
candidates to verify), its ring candidates and verified pairs recorded; the
JAX verification under a finest source stride of 4. The ranks also run the
port on a mesh of one rank (a group of one of them). The JAX stages that
run eagerly (``shard_map``, ~10 s a call on the CPU) run jitted, the same
functions, and its chunks one after another (its threads give the same
within 1e-5, its own bound).

Tolerances: the trajectory and each verified ``T_rel`` at 1e-3, the
precedent of the loop-closure tests (``LOOP_ATOL``: chained ICP tracks of
two frameworks), overlaps at rtol 2e-3; two ranks against one at 1e-4, the
reference's multi-process bound (the ranks sum in another f32 order).
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import _torch_ranks
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core import lie as jlie
from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
from rgbd_pose_estimation_tpu.icp import dense as jdense
from rgbd_pose_estimation_tpu.models import distributed_slam as jds
from rgbd_pose_estimation_tpu.models import sequence_parallel as jsequence_parallel
from rgbd_pose_estimation_tpu.parallel import sharded as jsharded
from rgbd_pose_estimation_tpu.parallel.mesh import make_mesh as jmake_mesh
from rgbd_pose_estimation_tpu.utils import config as jconfig
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence
from rgbd_pose_estimation_tpu_torch.utils.config import BAConfig, FrontendConfig

WORLD = 2
CAM = CameraIntrinsics(64.0, 64.0, 31.5, 23.5, 64, 48)
ICP = dict(levels=2, iters_per_level=(3, 4))
STRIDE4 = dict(source_stride=(4, 4), reassoc_every=2)
BA = BAConfig(outer_iters=2, cg_iters=5)
MIN_OVERLAP = 0.3  # distributed_slam's loop_min_overlap
TRAJ_ATOL = 1e-3
OVERLAP_RTOL = 2e-3
RANKS_ATOL = 1e-4


def _reference(depths, grays):
    """The JAX pipeline without BA on a (1, 2) mesh, its candidates and
    verified pairs recorded, then its verification of the same pairs from
    the same keyframe poses under the finest stride of 4 (jitted stages,
    the same functions)."""
    jcam = JCamera(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.width, CAM.height)
    jmesh = jmake_mesh(jconfig.MeshConfig(hosts=1, chips_per_host=WORLD))
    cfg = jconfig.PipelineConfig(icp=jconfig.IcpConfig(**ICP))
    seen = {}
    ring, verify = jds.ring_loop_candidates, jds.verify_loop_pairs

    def ring_kept(*a, **kw):
        seen["pairs"] = ring(*a, **kw)
        return seen["pairs"]

    def verify_kept(mesh, cam, icp_cfg, pairs, kf_poses, frame_of, **kw):
        seen["verify_in"] = (pairs, kf_poses)
        seen["verified"] = verify(mesh, cam, icp_cfg, pairs, kf_poses, frame_of, **kw)
        return seen["verified"]

    make_frame = jax.jit(jdense.make_icp_frame, static_argnums=(0, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jds, "ring_loop_candidates", ring_kept)
        mp.setattr(jds, "verify_loop_pairs", verify_kept)
        mp.setattr(jds, "icp_verify_sharded", jax.jit(jsharded.icp_verify_sharded, static_argnums=(0, 1, 2)))
        mp.setattr(jds, "ring_similarity", jax.jit(jsharded.ring_similarity, static_argnums=0))
        mp.setattr(jds, "make_icp_frame", make_frame)
        mp.setattr(jds, "se3_inverse", jax.jit(jlie.se3_inverse))
        # The chunks one after another (the threads' result within 1e-5, the
        # reference's own bound): two threads compile the tracker twice.
        mp.setattr(jds, "sequence_parallel_odometry",
                   functools.partial(jsequence_parallel.sequence_parallel_odometry, parallel=False))
        traj = jds.distributed_slam(jcam, depths, grays, jmesh, cfg, n_chunks=2, kf_stride=1,
                                    bundle_adjust=False)
        # The pyramids do not depend on the stride: the main run's, from the
        # same jitted call.
        frames = {}

        def frame_of(pos):  # every frame is a keyframe
            if pos not in frames:
                frames[pos] = make_frame(jcam, jnp.asarray(depths[pos]), cfg.icp)
            return frames[pos]

        stride = jconfig.IcpConfig(**ICP, **STRIDE4)

        stride4 = verify(jmesh, jcam, stride, *seen["verify_in"], frame_of)
    return np.asarray(traj), seen["pairs"], seen["verified"], stride4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("dslam")
    poses, depths, grays = synthetic_sequence(CAM, torch.Generator().manual_seed(7), 6, 0.008,
                                              device="cpu")
    depths, grays = [d.numpy() for d in depths], [g.numpy() for g in grays]
    frontend = FrontendConfig()
    torch.save({"cam": CAM, "depths": depths, "grays": grays, "icp_cfg": ICP, "ba_cfg": BA,
                "frontend": frontend, "stride": STRIDE4}, wd / "inputs.pt")
    procs = _torch_ranks.start("dslam", wd, WORLD)
    try:
        traj_ref, pairs_ref, verified_ref, ref_stride4 = _reference(depths, grays)
    finally:
        ranks = _torch_ranks.finish(procs, wd)
    one = {**ranks[0]["one"], **ranks[1]["one"]}
    return {"gt": poses.numpy(), "ranks": ranks, "one": one, "traj_ref": traj_ref,
            "pairs_ref": pairs_ref, "verified_ref": verified_ref, "ref_stride4": ref_stride4}


def _stage(records, name):
    return next(r for r in records if r.get("stage") == name)


def test_two_ranks_match_the_reference_pipeline(run):
    for r in run["ranks"]:
        traj = r["traj"]
        assert traj.dtype == np.float32 and traj.shape == (6, 4, 4)
        np.testing.assert_allclose(traj, run["traj_ref"], rtol=0, atol=TRAJ_ATOL)
        loops = _stage(r["records"], "loops")
        assert loops["candidates"] == len(run["pairs_ref"]) > 0
        assert loops["accepted"] == sum(o > MIN_OVERLAP for *_, o in run["verified_ref"])
    # Both ranks hold the same trajectory, which tracks the rendered truth.
    assert np.array_equal(run["ranks"][0]["traj"], run["ranks"][1]["traj"])
    assert np.abs(run["ranks"][0]["traj"] - run["gt"]).max() < 5e-3


def test_ring_loop_candidates_equal_the_reference(run):
    for r in run["ranks"]:
        assert r["pairs"] == run["pairs_ref"]


def test_verify_loop_pairs_match_the_reference(run):
    for r in run["ranks"]:
        assert [(a, b) for a, b, *_ in r["verified"]] == run["pairs_ref"]
        for (_, _, T, ovl), (_, _, T_ref, ovl_ref) in zip(r["verified"], run["verified_ref"]):
            np.testing.assert_allclose(T, np.asarray(T_ref), rtol=0, atol=TRAJ_ATOL)
            assert ovl == pytest.approx(ovl_ref, rel=OVERLAP_RTOL)


def test_two_ranks_match_one_rank_with_and_without_ba(run):
    """The pipeline on two ranks against the same call on a mesh of one, and
    the split stages cover their axes: each rank tracks one chunk, builds
    the descriptors of its keyframe span, verifies its rows of the pairs,
    detects its keyframes and drops nothing in the relayout."""
    one, ranks = run["one"], run["ranks"]
    for key in ("traj", "traj_ba"):
        for r in ranks:
            np.testing.assert_allclose(r[key], one[key], rtol=0, atol=RANKS_ATOL)
    K = _stage(ranks[0]["records"], "keyframes")["count"]
    odo = [_stage(r["records"], "odometry") for r in ranks]
    assert [o["local_chunks"] for o in odo] == [1, 1]
    assert sum(o["frames_tracked"] for o in odo) == 6 + 3  # two chunks, 3 frames of overlap
    assert sum(_stage(r["records"], "keyframes")["descriptors_local"] for r in ranks) == K == 6
    loops = [_stage(r["records"], "loops") for r in ranks]
    assert sum(lp["verify_pairs_local"] for lp in loops) == loops[0]["candidates"]
    assert all(lp["verify_pairs_local"] < loops[0]["candidates"] for lp in loops)
    builds = [_stage(r["records_ba"], "ba_build") for r in ranks]
    assert [b["detect_calls"] for b in builds] == [2, 2]  # keyframes 0, 2, 4, 5
    for r in ranks:
        ba = _stage(r["records_ba"], "ba")
        assert ba["reshard_dropped"] == 0 and ba["cost_last"] <= ba["cost_first"]
        assert np.isfinite(r["traj_ba"]).all()


def test_sequence_parallel_on_two_ranks_equals_one_process(run):
    """Three chunks over two ranks (two and one chunks), exchanged with one
    all-gather, against one process: the trajectory and its keyframes, and
    the frames each rank tracked, as the reference's multi-process test
    splits them. A poses-only chunk runner's None keyframes cross the
    exchange: return_keyframes=True still raises."""
    traj1, kfs1, stats1 = run["one"]["sp"]
    tracked = []
    for r in run["ranks"]:
        traj, kfs, stats = r["sp"]
        np.testing.assert_allclose(traj, traj1, rtol=0, atol=RANKS_ATOL)
        assert kfs == kfs1
        tracked.append(stats["frames_tracked"])
        assert stats["frames_tracked"] < stats1["frames_tracked"]
    assert [r["sp"][2]["local_chunks"] for r in run["ranks"]] == [2, 1]
    assert sum(tracked) == stats1["frames_tracked"]
    for r in run["ranks"]:
        assert r["poses_only"].shape == (7, 4, 4)
        np.testing.assert_allclose(r["poses_only"], run["one"]["poses_only"], rtol=0, atol=RANKS_ATOL)
        assert "return_keyframes=True needs chunk_runner" in r["poses_only_keyframes"]


def test_overlap_ratio_under_source_stride_rejects_every_distributed_loop(run):
    """A fault of the reference, ported as it is: verify_loop_pairs divides
    the verification track's association count, summed over the STRIDED
    sample, by the source frame's valid-normal count at full resolution. At
    a finest stride of 4 a true loop's overlap is ~1/16 of its stride-1
    value, under loop_min_overlap 0.3, and distributed_slam accepts no loop
    (the same in both packages)."""
    for r in run["ranks"]:
        full = [o for *_, o in r["verified"]]
        strided = [o for *_, o in r["verified_stride4"]]
        assert min(full) > MIN_OVERLAP
        assert max(strided) < MIN_OVERLAP
        for o4, o1 in zip(strided, full):
            assert 0.03 < o4 / o1 < 0.1
        for (_, _, T, o4), (_, _, T_ref, o4_ref) in zip(r["verified_stride4"], run["ref_stride4"]):
            assert o4 == pytest.approx(o4_ref, rel=OVERLAP_RTOL)
            np.testing.assert_allclose(T, np.asarray(T_ref), rtol=0, atol=TRAJ_ATOL)
        loops = _stage(r["records_stride4"], "loops")
        assert loops["candidates"] > 0 and loops["accepted"] == 0
