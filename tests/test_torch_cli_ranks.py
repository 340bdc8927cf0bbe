"""``ba`` and ``slam`` on two ranks, on a 6-frame 160x120 ``synth``
directory, launched in the two ways a user launches them:

- two gloo ranks, each calling the port's ``main(argv)`` in its own process
  with ``--coordinator file://… --num-processes 2 --process-id r``
  (``tests/_torch_ranks.py``, suite ``cli``);
- one ``main(argv)`` call with ``--cpu --mesh-devices 2``, which starts its
  two ranks itself (``parallel/spawn.py``), made here while the first two
  ranks run.

Held, as the reference's ``tests/distributed/test_multiprocess.py`` holds
its two processes, against one process's run at ``atol 1e-4`` (the ranks
sum in another f32 order): ``ba`` in both layouts, and ``slam``. The
blocked run's device relayout dropped nothing; the ranks split the
detection, the matching, the tracking, the descriptors, the verification
and the decoding; a 2-rank ``ba`` cut by ``--fail-at-iter`` and resumed from
its checkpoint gives the uninterrupted 2-rank trajectory; and a rank that
fails fails the command that started it, with the rank's error.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import _torch_ranks
import contextlib
import io
import json
import threading

import numpy as np
import pytest

from rgbd_pose_estimation_tpu_torch.cli.main import main

WORLD = 2
SLAM_FRAMES = 10


def _run(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("cli_ranks")
    data = wd / "data"
    rc, _ = _run("synth", "--out", data, "--frames", 6, "--width", 160, "--height", 120, "--cpu")
    assert rc == 0
    base = ["ba", "--dataset", str(data), "--cpu", "--kf-interval", "2", "--intrinsics",
            "from_dataset"]
    # slam over 10 frames, so that a rank's two chunks leave frames it never decodes.
    slam_data = wd / "slam_data"
    rc, _ = _run("synth", "--out", slam_data, "--frames", SLAM_FRAMES, "--width", 80, "--height", 60,
                 "--cpu")
    assert rc == 0
    slam = ["slam", "--dataset", str(slam_data), "--cpu", "--intrinsics", "from_dataset",
            "--detector", "tpu"]
    (wd / "argv.json").write_text(json.dumps({"ba": base, "slam": slam}))
    procs = _torch_ranks.start("cli", wd, WORLD)
    # A command whose ranks fail, in a thread meanwhile: ba prints its JSON
    # only at its end, so it writes nothing to the output captured below.
    fault = []

    def cut():
        try:
            main(base + ["--out", str(wd / "cut_spawned.txt"), "--mesh-devices", str(WORLD),
                         "--fail-at-iter", "1"])
        except RuntimeError as e:
            fault.append(e)

    thread = threading.Thread(target=cut)
    thread.start()
    try:
        single = _run(*base, "--out", wd / "single.txt", "--metrics", wd / "single.jsonl")
        _run(*slam, "--out", wd / "slam_single.txt", "--metrics", wd / "slam_single.jsonl")
        _run(*slam, "--out", wd / "slam_spawned.txt", "--metrics", wd / "slam_spawned.jsonl",
             "--mesh-devices", WORLD)
    finally:
        thread.join()
        ranks = _torch_ranks.finish(procs, wd)
    spawned_fault = fault[0] if fault else None
    return wd, single, ranks, spawned_fault


def _traj(path):
    return np.loadtxt(path)


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("layout", ["blocked", "replicated"])
def test_two_ranks_match_one_process(run, layout):
    wd, (rc0, single), ranks, _ = run
    assert rc0 == 0
    a, b = _traj(wd / "single.txt"), _traj(wd / f"{layout}.txt")
    assert a.shape == b.shape == (6, 8)
    np.testing.assert_allclose(b, a, atol=1e-4)
    for r in ranks:
        rc, out = r[layout]
        assert rc == 0
        assert out["num_landmarks"] == single["num_landmarks"] > 10
        assert out["num_observations"] == single["num_observations"]
        np.testing.assert_allclose(out["costs"], single["costs"], rtol=1e-4)
        assert out["reproj_rmse_after"] < out["reproj_rmse_before"]
    # Both ranks hold the same problem and the same solution.
    for key in ("costs", "reproj_rmse_before", "reproj_rmse_after"):
        assert ranks[0][layout][1][key] == ranks[1][layout][1][key]


def test_blocked_relayout_dropped_nothing_and_ranks_split_the_front_end(run):
    wd, _, _, _ = run
    single = {r.get("stage"): r for r in _records(wd / "single.jsonl")}["ba_build"]
    builds = []
    for rank in range(WORLD):
        recs = _records(wd / f"blocked{rank}.jsonl")
        blocked = next(r for r in recs if r.get("ba_layout") == "blocked")
        assert blocked["reshard_dropped"] == 0
        builds.append(next(r for r in recs if r.get("stage") == "ba_build"))
    assert all(b["detect_calls"] < single["detect_calls"] for b in builds)
    assert sum(b["detect_calls"] for b in builds) == single["detect_calls"]
    assert sum(b["match_pairs_local"] for b in builds) == single["match_pairs_local"]


def test_two_rank_resume_after_fault_equals_one_run(run):
    wd, _, ranks, _ = run
    for r in ranks:
        assert r["fault"] == "fault injection: failing after BA iteration 3"
        rc, out = r["resumed"]
        assert rc == 0
        assert out["costs"] == r["blocked"][1]["costs"][4:]
        assert out["reproj_rmse_after"] == r["blocked"][1]["reproj_rmse_after"]
    assert np.array_equal(_traj(wd / "resumed.txt"), _traj(wd / "blocked.txt"))
    with np.load(wd / "ba.ckpt.npz") as z:
        assert int(z["iter"]) == 10


def _stage(recs, name):
    return next(r for r in recs if r.get("stage") == name)


@pytest.mark.parametrize("launch", ["coordinator", "mesh-devices"])
def test_slam_on_two_ranks_matches_one_process(run, launch):
    wd = run[0]
    one = _traj(wd / "slam_single.txt")
    two = _traj(wd / ("slam_ranks.txt" if launch == "coordinator" else "slam_spawned.txt"))
    assert one.shape == two.shape == (SLAM_FRAMES, 8)
    np.testing.assert_allclose(two, one, atol=1e-4)
    if launch == "coordinator":
        for r in run[2]:
            rc, out = r["slam"]
            assert rc == 0 and out["frames"] == SLAM_FRAMES and out["ate_rmse"] < 0.01


def test_slam_ranks_split_every_stage(run):
    """Each of the two ranks tracks one chunk, decodes only its frames and
    the keyframes its stages touch, builds the descriptors of its keyframe
    span, verifies its rows and detects its keyframes; the spans cover each
    axis, and the relayout dropped nothing. A command that started its own
    ranks logs rank 0's record."""
    wd = run[0]
    single = _records(wd / "slam_single.jsonl")
    n_tracked = _stage(single, "odometry")["frames_tracked"]
    n_kf = _stage(single, "keyframes")["count"]
    n_verify = _stage(single, "loops")["verify_pairs_local"]
    assert _stage(single, "ba_build")["detect_calls"] == n_kf
    assert _stage(single, "io")["frames_decoded"] == SLAM_FRAMES
    recs = [_records(wd / f"slam_ranks{r}.jsonl") for r in range(WORLD)]
    spawned = _records(wd / "slam_spawned.jsonl")
    for rec in recs + [spawned]:
        assert _stage(rec, "ba")["reshard_dropped"] == 0
        assert _stage(rec, "odometry")["local_chunks"] == 1
        assert _stage(rec, "odometry")["frames_tracked"] < n_tracked
        io_stage = _stage(rec, "io")
        assert io_stage["frames_decoded"] < io_stage["frames_total"] == SLAM_FRAMES
        assert io_stage["peak_cached"] <= 64
        assert _stage(rec, "ba_build")["detect_calls"] < n_kf
        assert _stage(rec, "keyframes")["descriptors_local"] < n_kf
    stages = [r["stage"] for r in spawned if "stage" in r]
    assert len(stages) == len(set(stages)) == 7  # one rank's records: rank 0's
    for key, stage, total in (("frames_tracked", "odometry", n_tracked), ("detect_calls", "ba_build", n_kf),
                              ("descriptors_local", "keyframes", n_kf),
                              ("verify_pairs_local", "loops", n_verify)):
        assert sum(_stage(rec, stage)[key] for rec in recs) == total, key


def test_a_failing_rank_fails_the_command_that_started_it(run):
    """``ba --mesh-devices 2 --fail-at-iter 1``: the command raises the
    rank's own error, its traceback attached, and no rank is left."""
    fault = run[3]
    assert isinstance(fault, RuntimeError)
    assert str(fault) == "fault injection: failing after BA iteration 1"
    assert "raised on rank" in fault.__notes__[0]
