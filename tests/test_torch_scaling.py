"""eval/scaling.py of the PyTorch port, on the CPU: each mode of the
harness at ``--cpu --devices 2`` with the smallest arguments, through its
``main(argv)``. Size 1 runs in this process (a gloo group of one rank),
size 2 in the two gloo ranks the harness starts (``parallel/spawn.py``);
every rate is positive and finite, size 1's efficiency is 1, and no group
or rank is left behind. Times on the CPU are no measurement: the report's
keys and the weak-scaling sizes are what is held."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import contextlib
import io
import json
import math

import pytest
import torch.distributed as dist

from rgbd_pose_estimation_tpu_torch.eval import scaling


def _positive(x):
    return x > 0 and math.isfinite(x)


def test_step_mode_through_main():
    """``--mode step`` (the default) at its default sizes: 4096 hypotheses
    and 512 landmarks (2048 observations) a device."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = scaling.main(["--cpu", "--devices", "2"])
    assert json.loads(out.getvalue()) == json.loads(json.dumps(report, default=str))
    assert report["mesh_sizes"] == [1, 2] and set(report) == {"mesh_sizes", "results", "efficiency"}
    for n in (1, 2):
        rates = report["results"][n]
        assert set(rates) == {"score_hyp_per_s", "ba_obs_per_s", "ba_blocked_obs_per_s"}
        assert all(_positive(v) for v in rates.values())
        assert all(_positive(v) for v in report["efficiency"][n].values())
    assert report["efficiency"][1] == {"score": 1.0, "ba": 1.0, "ba_blocked": 1.0}
    assert not dist.is_initialized()


def test_slam_mode_on_one_and_two_ranks():
    """The slam mode's weak scaling at its smallest: 2 frames a chunk and a
    device at 64x48, so 2 frames at size 1 and 4 at size 2, tracked, loop-
    checked and stitched end to end (BA's own ranks run in
    ``test_torch_distributed_slam.py``)."""
    report = scaling.run_slam(2, use_cpu_mesh=True, frames_per_chunk=2, width=64, height=48,
                              bundle_adjust=False)
    assert report["mode"] == "slam" and report["mesh_sizes"] == [1, 2]
    assert [report["results"][n]["frames"] for n in (1, 2)] == [2, 4]
    assert all(_positive(report["results"][n]["frames_per_s"]) for n in (1, 2))
    assert report["efficiency"][1] == 1.0 and _positive(report["efficiency"][2])
    assert not dist.is_initialized()


def test_devices_beyond_the_cards_raise_before_any_rank(monkeypatch):
    """On the CUDA default, a size with more ranks than cards raises before
    any rank starts (one card a rank); nothing falls back to the CPU."""
    from rgbd_pose_estimation_tpu_torch.parallel import spawn

    monkeypatch.setattr(scaling, "_step_rates", lambda *a: {"score_hyp_per_s": 1.0, "ba_obs_per_s": 1.0,
                                                           "ba_blocked_obs_per_s": 1.0})
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setattr(spawn, "run_ranks", lambda *a: pytest.fail("a rank started"))
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        scaling.run(2)
