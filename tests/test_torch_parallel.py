"""The port's distributed layer (``parallel/``, ``ba/cluster.py``) on four
gloo ranks, against the JAX package on its virtual CPU mesh.

One group of four rank processes (``tests/_torch_ranks.py``, suite
``parallel``; a ``FileStore`` under the test's directory) runs every case
once while this process computes the references: the JAX package's
``score_poses_3d3d_sharded``, ``icp_jtj_sharded``, ``ba_step_sharded`` and
``block_ba_problem_device`` on a ``(2, 2)`` mesh (jitted, one signature
each), and the port's single-device functions for the rest. Tolerances are
the reference's own (``tests/distributed/test_sharded.py``): a sum across
ranks changes the f32 summation order against one device.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import _torch_ranks
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.ba import cluster as jcluster
from rgbd_pose_estimation_tpu.ba.schur import BAProblem as JBAProblem
from rgbd_pose_estimation_tpu.ops.icp_jtj import pack_icp_data
from rgbd_pose_estimation_tpu.parallel import sharded as jsharded
from rgbd_pose_estimation_tpu.parallel.mesh import config_hash as jconfig_hash
from rgbd_pose_estimation_tpu.parallel.mesh import make_mesh as jmake_mesh
from rgbd_pose_estimation_tpu.utils.config import BAConfig as JBAConfig
from rgbd_pose_estimation_tpu.utils.config import MeshConfig as JMeshConfig
from rgbd_pose_estimation_tpu_torch.ba import cluster
from rgbd_pose_estimation_tpu_torch.ba.schur import BAProblem, ba_solve, make_synthetic_ba_problem
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence
from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame, icp_track_batch, make_icp_frame
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import score_poses_3d3d
from rgbd_pose_estimation_tpu_torch.parallel.mesh import config_hash
from rgbd_pose_estimation_tpu_torch.utils.config import BAConfig, IcpConfig

WORLD = 4
C, L, OBS_PER_POINT = 8, 200, 4  # the reference test's BA problem: O = 800
CAM = CameraIntrinsics(64.0, 64.0, 31.5, 23.5, 64, 48)
ICP_CFG = dict(levels=2, iters_per_level=(3, 4))
PAIRS = 4  # loop candidates verified, one a rank


def _inputs():
    rng = np.random.default_rng(0)
    T = se3_exp(torch.from_numpy((rng.normal(size=(512, 6)) * 0.3).astype(np.float32))).numpy()
    p = rng.normal(size=(256, 3)).astype(np.float32)
    q = rng.normal(size=(256, 3)).astype(np.float32)
    m = 8 * 128 * 8
    pi = rng.normal(size=(m, 3)).astype(np.float32)
    ni = rng.normal(size=(m, 3)).astype(np.float32)
    ni /= np.linalg.norm(ni, axis=-1, keepdims=True)
    icp = [pi, pi + np.float32(0.01), ni, np.ones(m, np.float32)]
    O = L * OBS_PER_POINT
    draws = {"xi": rng.normal(size=(C, 6)), "X": rng.uniform(-1.5, 1.5, (L, 3)),
             "cam_idx": rng.integers(0, C, O), "obs_noise": rng.normal(size=(O, 2)),
             "z_noise": rng.normal(size=O), "dxi": rng.normal(size=(C, 6)),
             "X_noise": rng.normal(size=(L, 3))}
    draws = {k: v.astype(np.int32 if k == "cam_idx" else np.float32) for k, v in draws.items()}
    prob, _, _ = make_synthetic_ba_problem(None, C, L, OBS_PER_POINT, draws=draws, device="cpu")
    ba = {k: None if v is None else v.numpy() for k, v in prob._asdict().items()}
    desc = rng.normal(size=(64, 32)).astype(np.float32)
    _, depths, _ = synthetic_sequence(CAM, torch.Generator().manual_seed(3), PAIRS + 1, 0.01,
                                      device="cpu")
    frames = [make_icp_frame(CAM, d, IcpConfig(**ICP_CFG)) for d in depths]

    def stack(fs):
        return [[np.stack([f[i][lvl].numpy() for f in fs]) for lvl in range(len(fs[0][i]))]
                for i in range(3)]

    return {"T": T, "p": p, "q": q, "icp": icp, "ba": ba, "desc": desc, "cam": CAM,
            "icp_cfg": ICP_CFG, "src": stack(frames[1:]), "tgt": stack(frames[:-1]),
            "T_init": np.tile(np.eye(4, dtype=np.float32), (PAIRS, 1, 1))}


def _references(inp):
    """The JAX package's sharded functions on a (2, 2) mesh of the virtual
    CPU devices, and the port's single-device twins."""
    jm = jmake_mesh(JMeshConfig(hosts=2, chips_per_host=2))
    jprob = JBAProblem(**{k: None if v is None else jnp.asarray(v) for k, v in inp["ba"].items()})
    ref = {}
    ref["score"] = [np.asarray(a) for a in jax.jit(
        lambda T, p, q: jsharded.score_poses_3d3d_sharded(jm, T, p, q, 0.05))(
            inp["T"], inp["p"], inp["q"])]
    ref["icp"] = [np.asarray(a) for a in jax.jit(
        lambda *a: jsharded.icp_jtj_sharded(jm, pack_icp_data(*a)))(*inp["icp"])]
    out, cost = jax.jit(lambda pr: jsharded.ba_step_sharded(jm, pr, JBAConfig(cg_iters=15)))(jprob)
    ref["ba_step"] = (np.asarray(out.poses), np.asarray(out.points), float(cost))
    # The reference's relayout with its all-to-all jitted (eagerly, its
    # shard_map dispatches op by op: ~15 s a call on the CPU).
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsharded, "reshard_obs_to_blocks",
                   jax.jit(jsharded.reshard_obs_to_blocks, static_argnums=(0, 3)))
        blocked, layout, stats, dropped = jcluster.block_ba_problem_device(jm, jprob)
        over = jcluster.block_ba_problem_device(jm, jprob, obs_cap_override=16)
    ref["blocked_device"] = {
        "layout": layout, "stats": stats, "dropped": int(dropped),
        "fields": {k: np.asarray(getattr(blocked, k)) for k in ("cam_idx", "lm_idx", "obs", "w",
                                                                "obs_z")},
    }
    ref["overflow"] = (int(over[3]), over[2]["reshard_dropped_host"], np.asarray(over[0].w),
                       over[1].obs_perm)
    prob = BAProblem(**{k: None if v is None else torch.from_numpy(v) for k, v in inp["ba"].items()})
    solved, costs = ba_solve(prob, BAConfig(outer_iters=3, cg_iters=15))
    ref["solve"] = (solved.poses.numpy(), solved.points.numpy(), costs.numpy())
    ref["score_port"] = [t.numpy() for t in score_poses_3d3d(
        torch.from_numpy(inp["T"]), torch.from_numpy(inp["p"]), torch.from_numpy(inp["q"]), 0.05)]

    def frame(leaves):
        return IcpFrame(*(tuple(torch.from_numpy(a) for a in lv) for lv in leaves))

    T, stats = icp_track_batch(CAM, IcpConfig(**ICP_CFG), torch.from_numpy(inp["T_init"]),
                               frame(inp["src"]), frame(inp["tgt"]))
    ref["verify"] = (T.numpy(), stats.numpy())
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("parallel_ranks")
    inp = _inputs()
    torch.save(inp, wd / "inputs.pt")
    procs = _torch_ranks.start("parallel", wd, WORLD)
    try:
        ref = _references(inp)
    finally:
        results = _torch_ranks.finish(procs, wd)
    return inp, ref, results


def test_four_ranks_form_a_one_host_mesh_and_a_contradicting_config_raises(run):
    _, _, res = run
    assert [r["rank"] for r in res] == list(range(WORLD))
    assert all(r["shape"] == (1, WORLD) for r in res)
    assert all("mesh.hosts=2" in r["bad_config"] for r in res)


def test_score_sharded_matches_reference_mesh_and_one_device(run):
    _, ref, res = run
    for r in res:
        msac, count, rerun_equal, local_shape = r["score"]
        assert local_shape == (512 // WORLD,) and rerun_equal
        np.testing.assert_allclose(msac, ref["score"][0], rtol=1e-6)
        np.testing.assert_array_equal(count, ref["score"][1])
        np.testing.assert_allclose(msac, ref["score_port"][0], rtol=1e-6)
        np.testing.assert_array_equal(count, ref["score_port"][1])


def test_icp_jtj_sharded_matches_reference_mesh(run):
    _, ref, res = run
    for r in res:
        for a, b in zip(r["icp"], ref["icp"]):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("tables", ["slots", "incidence"])
def test_ba_step_sharded_matches_reference_mesh(run, tables):
    _, ref, res = run
    poses0, points0, cost0 = ref["ba_step"]
    for r in res:
        poses, points, cost = r["ba_step"][tables]
        np.testing.assert_allclose(cost, cost0, rtol=1e-5)
        np.testing.assert_allclose(poses, poses0, atol=2e-4)
        np.testing.assert_allclose(points, points0, atol=1e-3)
        assert r["ba_step"]["rerun_equal"]
    assert all(np.array_equal(r["ba_step"]["slots"][0], res[0]["ba_step"]["slots"][0]) for r in res)


@pytest.mark.parametrize("layout", ["blocked_host", "blocked_device"])
def test_blocked_solve_matches_one_device(run, layout):
    _, ref, res = run
    poses0, points0, costs0 = ref["solve"]
    for r in res:
        if layout == "blocked_host":
            poses, points, costs = r[layout]
        else:
            d = r[layout]
            poses, points, costs = d["poses"], d["points"], d["costs"]
            assert d["rerun_equal"]
        np.testing.assert_allclose(costs, costs0, rtol=1e-5)
        np.testing.assert_allclose(poses, poses0, atol=2e-4)
        np.testing.assert_allclose(points, points0, atol=1e-3)


def test_device_relayout_equals_reference_replay(run):
    """The layout, the resharded fields and the tables of
    ``block_ba_problem_device`` equal the reference's; nothing dropped;
    one all_to_all_single a field plus one for the valid mask."""
    _, ref, res = run
    want = ref["blocked_device"]
    for r in res:
        got = r["blocked_device"]
        assert got["dropped"] == want["dropped"] == 0
        for name in ("lm_perm", "obs_perm"):
            np.testing.assert_array_equal(getattr(got["layout"], name), getattr(want["layout"], name))
        for name in ("n_shards", "block_size", "obs_cap", "num_landmarks", "num_observations"):
            assert getattr(got["layout"], name) == getattr(want["layout"], name)
        for name in ("cam_slots", "lm_slots"):
            if getattr(want["layout"], name) is not None:
                np.testing.assert_array_equal(getattr(got["layout"], name),
                                              getattr(want["layout"], name))
        assert got["stats"] == want["stats"]
        for k, v in want["fields"].items():
            np.testing.assert_array_equal(got["fields"][k], v)
        assert got["comm"]["all_to_all"][0] == len(want["fields"]) + 1
        assert got["points_local"] == (want["layout"].block_size, 3)


def test_relayout_counts_overflow_as_reference(run):
    _, ref, res = run
    dropped0, host0, w0, perm0 = ref["overflow"]
    assert dropped0 > 0 and dropped0 == host0
    for r in res:
        dropped, host, w, perm = r["overflow"]
        assert dropped == dropped0 and host == host0
        np.testing.assert_array_equal(w, w0)
        np.testing.assert_array_equal(perm, perm0)


def test_blocked_cg_iteration_reduces_the_camera_vector_only(run):
    """Counted on the collectives: a CG iteration of the blocked step
    reduces exactly ``comm_bytes_per_cg_iter(C, L, blocked=True)`` bytes,
    the replicated step ``blocked=False``'s."""
    for r in run[2]:
        b = r["cg_bytes"]
        assert b["blocked"] == cluster.comm_bytes_per_cg_iter(b["C"], b["L"], blocked=True)
        assert b["replicated"] == cluster.comm_bytes_per_cg_iter(b["C"], b["L"], blocked=False)
        assert b["blocked"] == jcluster.comm_bytes_per_cg_iter(b["C"], b["L"], True)


def test_ring_similarity_matches_dense(run):
    inp, _, res = run
    dense = inp["desc"].astype(np.float64) @ inp["desc"].T.astype(np.float64)
    for r in res:
        np.testing.assert_allclose(r["ring"], dense, rtol=1e-5, atol=1e-5)


def test_icp_verify_sharded_matches_one_device_batch(run):
    inp, ref, res = run
    valid0 = (np.sum(inp["src"][1][0] ** 2, axis=-1) > 0.5).sum(axis=(1, 2))
    for r in res:
        T, stats, v0, local_shape = r["verify"]
        assert local_shape == (PAIRS // WORLD, 4, 4)
        np.testing.assert_allclose(T, ref["verify"][0], rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(stats, ref["verify"][1], rtol=2e-5, atol=1e-3)
        np.testing.assert_array_equal(v0, valid0)


def test_config_check_and_global_tensors(run):
    _, _, res = run
    assert config_hash(BAConfig()) == jconfig_hash(JBAConfig())
    for rank, r in enumerate(res):
        assert r["consistent"] is True and r["divergent"] is False
        local_shape, whole, rows, rows_shape, gathered, gathered_bool, eye = r["global"]
        assert local_shape == (3, 2)
        np.testing.assert_array_equal(whole, np.arange(WORLD * 6, dtype=np.float32).reshape(-1, 2))
        np.testing.assert_array_equal(rows, np.repeat(np.arange(WORLD), 2)[:, None] * np.ones(3))
        assert rows_shape == (2 * WORLD, 3)
        np.testing.assert_array_equal(gathered, [[k, 10 * k] for k in range(WORLD)])
        np.testing.assert_array_equal(gathered_bool, [[k == 1, True] for k in range(WORLD)])
        np.testing.assert_array_equal(eye, np.eye(2))


def test_dryrun_multichip_on_four_ranks(run):
    assert all(r["dryrun"] for r in run[2])


def test_one_process_meshes_raise_or_start_a_real_group():
    """In one process: a 1×1 mesh is a real gloo group of world size 1; a
    mesh of several devices raises, pointing at the commands that start
    their own ranks; a backend that cannot start (NCCL in a CPU build)
    raises, and no group is left behind (no fallback to another backend)."""
    import torch.distributed as dist

    from rgbd_pose_estimation_tpu_torch.parallel import mesh as pm
    from rgbd_pose_estimation_tpu_torch.utils.config import MeshConfig

    assert not dist.is_initialized()
    with pytest.raises(NotImplementedError, match="inside one process.*start their own, parallel/spawn.py"):
        pm.make_mesh(MeshConfig(hosts=1, chips_per_host=2), device="cpu")
    with pytest.raises(NotImplementedError, match="inside one process.*start their own, parallel/spawn.py"):
        pm.runtime_mesh(mesh_devices=2, device="cpu")
    with pytest.raises(NotImplementedError, match="inside one process.*start their own, parallel/spawn.py"):
        pm.runtime_mesh(MeshConfig(hosts=2, chips_per_host=4), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            pm.make_mesh(device="cuda:0")
        assert not dist.is_initialized()
    mesh = pm.runtime_mesh(device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1 and mesh.shape == (1, 1)
        with pytest.raises(ValueError, match="needs nccl"):
            pm.make_mesh(device="cuda:0")
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(pm.psum(mesh, x), x) and mesh.comm["all_reduce"] == [1, 24]
        assert pm.check_config_consistency(mesh, MeshConfig())
    finally:
        dist.destroy_process_group()
