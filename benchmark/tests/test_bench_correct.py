"""The comparison that decides ``correct`` fails what it must: the TF32
control of each cell, and each fault a cell can have planted under the
timed path, at sizes a CPU test can hold, against the cells' own limits.

Each case runs the harness end to end in a fresh process (no look for a
card), with the fault planted into the program before the run starts.
A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.small import REPO, last_line, small_root

_FAULTS = {
    # The tracker's step returns its state unchanged: every track gives T_init.
    "icp_odometry_c3.stream/state_unchanged": """
import rgbd_pose_estimation_tpu_torch.models.odometry as od
real = od.icp_track
od.icp_track = lambda cam, cfg, T_init, src, tgt: (T_init, real(cam, cfg, T_init, src, tgt)[1])
""",
    # Half of the source samples (the right half of each level) left out; the
    # normal equations over the rest.
    "icp_odometry_c3.stream/half_batch": """
import rgbd_pose_estimation_tpu_torch.models.odometry as od
from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame
real = od.icp_track
def half(f):
    vs = []
    for v in f.vertices:
        v = v.clone(); v[:, v.shape[1] // 2:] = 0.0; vs.append(v)
    return IcpFrame(tuple(vs), f.normals, f.photo)
od.icp_track = lambda cam, cfg, T_init, src, tgt: real(cam, cfg, T_init, half(src), tgt)
""",
    # The answer altered where it is produced: every track's pose moved by 1 mm.
    "icp_odometry_c3.stream/answer_altered": """
import rgbd_pose_estimation_tpu_torch.models.odometry as od
real = od.icp_track
def track(*a):
    T, stats = real(*a)
    T = T.clone(); T[0, 3] += 1e-3
    return T, stats
od.icp_track = track
""",
    # The refit returns the best hypothesis unchanged.
    "ransac3d3d_c1.bulk/state_unchanged": """
import rgbd_pose_estimation_tpu_torch.ransac.engine as en
real = en._refit_3d3d
en._refit_3d3d = lambda T, s, p, q, cfg, k: real(T, s, p, q, en.dataclasses.replace(cfg, refit_rounds=0), k)
""",
    # Half of the inliers left out of the refit; the least squares over the rest.
    "ransac3d3d_c1.bulk/half_batch": """
import rgbd_pose_estimation_tpu_torch.ransac.engine as en
real = en.horn_quaternion
def horn(p, q, weights=None, iters=12):
    w = weights.clone(); w[1::2] = 0.0
    return real(p, q, weights=w, iters=iters)
en.horn_quaternion = horn
""",
    # One answer altered where it is produced: the inlier count one too high.
    "ransac3d3d_c1.bulk/answer_altered": """
import rgbd_pose_estimation_tpu_torch.ransac.engine as en
real = en._refit_3d3d
def refit(*a):
    r = real(*a)
    return r._replace(num_inliers=r.num_inliers + 1)
en._refit_3d3d = refit
""",
}

_RUN = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
exec(sys.argv[3])
from benchmark import run
sys.exit(run.main(sys.argv[4:], root=sys.argv[2], device="cpu"))
"""


def _run(root, cell, fault=""):
    proc = subprocess.run([sys.executable, "-c", _RUN, str(REPO), str(root), fault, "--workload", cell,
                           "--seed", "3000000777", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return last_line(proc.stdout)


@pytest.mark.parametrize("case", sorted(_FAULTS))
def test_planted_fault_is_not_correct(tmp_path, case):
    cell = case.split("/")[0]
    line = _run(small_root(tmp_path), cell, _FAULTS[case])
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("cell", ["icp_odometry_c3.stream", "ransac3d3d_c1.bulk"])
def test_control_in_tf32_is_not_correct(tmp_path, cell):
    """The reference in TF32, put in the program's place, fails the cell's
    limits; the program itself passes them."""
    code = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from benchmark.harness.spec import Spec
spec = Spec(sys.argv[2])
w = spec.cell(sys.argv[3])
cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
drv = spec.client(mix["client"]).Client(cfg, mix, 3000000888, "cpu")
drv.setup()
drv.warmup()
records = drv.serve(time.perf_counter() + 1.0)
print(json.dumps({"program": drv.check(records), "control": drv.check(records, control=True),
                  "limits": spec.limits(sys.argv[3])}))
"""
    root = small_root(tmp_path)
    proc = subprocess.run([sys.executable, "-c", code, str(REPO), str(root), cell],
                          capture_output=True, text=True, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(r["program"][k] <= r["limits"][k] for k in r["limits"]), r
    assert any(r["control"][k] > r["limits"][k] for k in r["limits"]), r
