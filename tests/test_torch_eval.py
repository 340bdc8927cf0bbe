"""eval/ of the PyTorch port against the JAX package's, on the CPU: ATE after
Umeyama alignment, RPE, TUM trajectory files, timestamp association and the
metrics summary. Trajectories are made in numpy and handed to both."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import json

import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.eval import ate as jate
from rgbd_pose_estimation_tpu.eval import report as jreport
from rgbd_pose_estimation_tpu.eval import traj_io as jtraj
from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
from rgbd_pose_estimation_tpu_torch.eval import ate as tate
from rgbd_pose_estimation_tpu_torch.eval import report as treport
from rgbd_pose_estimation_tpu_torch.eval import traj_io as ttraj

# Both align with an f32 SVD of the same 3x3 cross-covariance, and RPE runs
# the same f32 pose arithmetic: errors agree to a relative 1e-5.
RTOL = 1e-5
# Except the rotational RPE: arccos of an f32 trace near 3, where the two
# frameworks' 4x4 products may round the three diagonal entries apart by a
# last bit each (3 x 6e-8 in cos θ), which moves θ ≈ 0.03 by 3 x 6e-8 / sin θ,
# up to 2e-4 of itself. Translations and ATE hold to 1e-5.
ROT_RTOL = 2e-4


@pytest.fixture(scope="module")
def trajectories():
    """A 20-frame ground truth and an estimate with drift, noise and an
    offset world frame, as (F, 4, 4) world→camera float32 poses."""
    rng = np.random.default_rng(0)
    xi = np.cumsum(rng.normal(size=(20, 6)) * 0.05, axis=0).astype(np.float32)
    gt = se3_exp(torch.from_numpy(xi)).numpy()
    noise = (rng.normal(size=(20, 6)) * 0.01).astype(np.float32)
    offset = se3_exp(torch.tensor([0.3, -0.2, 0.1, 0.05, 0.1, -0.2])).numpy()
    est = se3_exp(torch.from_numpy(noise)).numpy() @ gt @ offset
    return gt, est.astype(np.float32)


def _centers(T):
    return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_and_alignment_match_reference(trajectories, with_scale):
    gt, est = trajectories
    c_gt, c_est = _centers(gt), _centers(est) * (1.3 if with_scale else 1.0)
    ate = tate.ate_rmse(c_est, c_gt, with_scale=with_scale)
    assert 1e-3 < ate < 0.5
    np.testing.assert_allclose(ate, jate.ate_rmse(c_est, c_gt, with_scale=with_scale), rtol=RTOL)
    T, s = tate.align_umeyama(c_est, c_gt, with_scale)
    T_ref, s_ref = jate.align_umeyama(c_est, c_gt, with_scale)
    assert T.dtype == np.float32 and isinstance(s, float)
    np.testing.assert_allclose(T, T_ref, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(s, s_ref, rtol=RTOL)
    assert tate.ate_rmse(c_gt, c_gt) < 1e-5


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_reference(trajectories, delta):
    gt, est = trajectories
    out, ref = tate.rpe(est, gt, delta), jate.rpe(est, gt, delta)
    assert set(out) == set(ref) == {"trans_rmse", "rot_rmse"}
    np.testing.assert_allclose(out["trans_rmse"], ref["trans_rmse"], rtol=RTOL)
    np.testing.assert_allclose(out["rot_rmse"], ref["rot_rmse"], rtol=ROT_RTOL)
    assert 0.01 < out["rot_rmse"] < 0.05 and 0.01 < out["trans_rmse"] < 0.05


def test_tum_files_and_association_match_reference(trajectories, tmp_path):
    gt, _ = trajectories
    ts = 1305031102.175 + 0.033 * np.arange(len(gt))
    mine, theirs = tmp_path / "port.txt", tmp_path / "ref.txt"
    ttraj.write_tum_trajectory(mine, ts, gt)
    jtraj.write_tum_trajectory(theirs, ts, gt)
    assert mine.read_text() == theirs.read_text()
    t_out, p_out = ttraj.read_tum_trajectory(mine)
    t_ref, p_ref = jtraj.read_tum_trajectory(theirs)
    np.testing.assert_array_equal(t_out, t_ref)
    np.testing.assert_allclose(p_out, p_ref, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(p_out, gt, atol=1e-5)  # six decimals in the file
    # Greedy nearest-timestamp association, with jitter and missing frames.
    rng = np.random.default_rng(1)
    ts_b = np.delete(ts + rng.uniform(-0.012, 0.012, size=len(ts)), [3, 7])
    for max_diff in (0.02, 0.005):
        out = ttraj.associate_timestamps(ts, ts_b, max_diff)
        ref = jtraj.associate_timestamps(ts, ts_b, max_diff)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    assert [len(a) for a in ttraj.associate_timestamps(ts, ts + 1.0)] == [0, 0]


def test_summarize_and_table_match_reference(tmp_path):
    records = [{"frame": i, "ms": 10.0 + i, "hypotheses": 1024, "keyframe": i % 3 == 0}
               for i in range(6)]
    records += [{"ate_rmse": 0.02}, {"stage": "loops", "candidates": 4, "accepted": 2},
                {"stage": "odometry", "frames": 6, "chunks": 1}, {"stage": "other", "x": 1}]
    assert treport.summarize(records) == jreport.summarize(records)
    path = tmp_path / "run.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in records) + "\n\n")
    assert treport.load_jsonl(path) == records
    assert treport.report_table([str(path)]) == jreport.report_table([str(path)])
