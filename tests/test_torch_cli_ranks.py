"""``ba`` across processes: two gloo ranks, each calling the port's
``main(argv)`` in its own process with ``--coordinator file://…
--num-processes 2 --process-id r`` (``tests/_torch_ranks.py``, suite
``cli``), on a 6-frame 160x120 ``synth`` directory.

Held, as the reference's ``tests/distributed/test_multiprocess.py:320``
holds its two processes, against one process's ``ba`` at ``atol 1e-4``
(the ranks sum in another f32 order), in both layouts; the blocked run's
device relayout dropped nothing; the ranks split the detection and the
matching; and a 2-rank run cut by ``--fail-at-iter`` and resumed from its
checkpoint gives the uninterrupted 2-rank trajectory.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import _torch_ranks
import contextlib
import io
import json

import numpy as np
import pytest

from rgbd_pose_estimation_tpu_torch.cli.main import main

WORLD = 2


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
    (wd / "argv.json").write_text(json.dumps(base))
    procs = _torch_ranks.start("cli", wd, WORLD)
    try:
        single = _run(*base, "--out", wd / "single.txt", "--metrics", wd / "single.jsonl")
    finally:
        ranks = _torch_ranks.finish(procs, wd)
    return wd, single, ranks


def _traj(path):
    return np.loadtxt(path)


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("layout", ["blocked", "replicated"])
def test_two_ranks_match_one_process(run, layout):
    wd, (rc0, single), ranks = run
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
    wd, _, _ = run
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
    wd, _, ranks = run
    for r in ranks:
        assert r["fault"] == "fault injection: failing after BA iteration 3"
        rc, out = r["resumed"]
        assert rc == 0
        assert out["costs"] == r["blocked"][1]["costs"][4:]
        assert out["reproj_rmse_after"] == r["blocked"][1]["reproj_rmse_after"]
    assert np.array_equal(_traj(wd / "resumed.txt"), _traj(wd / "blocked.txt"))
    with np.load(wd / "ba.ckpt.npz") as z:
        assert int(z["iter"]) == 10
