"""The port's ICP experiments (``tools/reassoc_exp.py``,
``tools/photometric_exp.py``) against the JAX repository's loop, on the CPU.

The port renders the hard-mode sequence at 80x60 (4 frames, the config-3
stride); the reference's frame-to-frame loop (``make_icp_frame``,
``icp_track`` from the identity, accumulated in float64, ATE of the camera
centres) runs on the same numpy frames for one ``(cam, IcpConfig)``
signature: config 3's ICP (stride (4, 4, 2), iterations (3, 4, 6),
``reassoc_every=2``) with the photometric term at 0.1, which takes both the
association carry and the photometric rows. JAX compiles the signature's
track in ~6.5 s, ~10.5 s at the default (5, 7, 10) iterations. The full
tables against the reference, at the tools' settings, are
``python tests/port_vs_reference_checks.py tools``.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
from rgbd_pose_estimation_tpu.eval.ate import ate_rmse as jax_ate_rmse
from rgbd_pose_estimation_tpu.icp import dense as jdense
from rgbd_pose_estimation_tpu.utils.config import IcpConfig as JIcpConfig
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.tools import photometric_exp, reassoc_exp
from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig

W, H, FRAMES = 80, 60, 4
# The experiments' camera (fx = 525 at 640x480) scaled to the frames.
CAM = CameraIntrinsics(525.0 * W / 640, 525.0 * W / 640, W / 2 - 0.5, H / 2 - 0.5, W, H)
JCAM = JCamera(CAM.fx, CAM.fy, CAM.cx, CAM.cy, W, H)
SIGNATURE = dict(source_stride=(4, 4, 2), iters_per_level=(3, 4, 6), reassoc_every=2,
                 photometric_weight=0.1)


@pytest.fixture(scope="module")
def sequence():
    """The port's hard-mode sequence of the experiments' first seed."""
    return reassoc_exp.hard_sequence(CAM, reassoc_exp.SEED, FRAMES, device="cpu")


def _reference_centres(depths, intensities, cfg):
    """The reference's loop (root ``tools/photometric_exp.py:54-67``) on
    the given numpy frames."""
    make_frame = jax.jit(jdense.make_icp_frame, static_argnums=(0, 2))
    frames = [make_frame(JCAM, jnp.asarray(depths[i]), cfg, jnp.asarray(intensities[i]))
              for i in range(FRAMES)]
    T_acc = [np.eye(4)]
    for i in range(1, FRAMES):
        T, _ = jdense.icp_track(JCAM, cfg, jnp.eye(4), frames[i], frames[i - 1])
        T_acc.append(T_acc[-1] @ np.asarray(T))
    return np.stack(T_acc)[:, :3, 3]


def test_odometry_matches_reference_loop(sequence):
    poses, depths, intensities = sequence
    cfg = IcpConfig(**SIGNATURE)
    [row] = reassoc_exp.ate_rows(CAM, poses, depths, [cfg], intensities)
    gt = reassoc_exp.true_centres(poses)
    ref = _reference_centres(depths.numpy(), intensities.numpy(), JIcpConfig(**SIGNATURE))
    ref_ate = float(jax_ate_rmse(ref, gt))
    assert row["centres"].shape == ref.shape == (FRAMES, 3)
    np.testing.assert_allclose(row["centres"], ref, rtol=0, atol=2e-4)
    assert abs(row["ate_m"] - ref_ate) <= 1e-4
    # The sequence moves: the odometry is not the identity.
    assert np.abs(row["centres"][-1]).max() > 0.01


def test_every_row_is_finite(sequence):
    """Both tables at 80x60 on the port's side: every setting of
    ``reassoc_exp`` on seed 5, every weight of ``photometric_exp`` on seeds
    5, 6 and 7; the CPU's tables say that no time was measured."""
    poses, depths, _ = sequence
    rows = reassoc_exp.ate_rows(CAM, poses, depths, reassoc_exp.configs())
    assert [r["cfg"].reassoc_every for r in rows] == [1, 2, 3]
    cfgs = photometric_exp.configs()
    ates, (first_depths, _) = photometric_exp.ate_table(CAM, FRAMES, cfgs, device="cpu")
    assert torch.equal(first_depths, depths)  # seed 5's sequence, drawn anew
    assert [c.photometric_weight for c in cfgs] == [0.0, 0.1, 0.5]
    assert all(c.reassoc_every == 2 and c.source_stride == (4, 4, 2) for c in cfgs)
    values = [r["ate_m"] for r in rows] + [a for per_seed in ates for a in per_seed]
    assert len(values) == 3 + 9 and all(math.isfinite(a) for a in values)
    assert all(np.isfinite(r["centres"]).all() for r in rows)
    # At weight 0 the photometric tool tracks as reassoc_exp's k = 2 does.
    assert ates[0][0] == rows[1]["ate_m"]
    assert "not measured" in reassoc_exp.table(rows)
    assert "not measured" in photometric_exp.table(cfgs, ates)


def test_timing_needs_a_card(sequence):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, depths, intensities = sequence
    with pytest.raises(RuntimeError, match="CUDA"):
        reassoc_exp.track_ms(CAM, IcpConfig(**SIGNATURE), depths, intensities)
    with pytest.raises(RuntimeError, match="CUDA"):
        reassoc_exp.track_times(CAM, photometric_exp.configs(), depths, intensities)
    for run in (reassoc_exp.run, photometric_exp.run):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(H=H, W=W, n_frames=FRAMES)


def test_time_cells_give_median_and_range():
    """A time cell gives the median of its samples and their range, not one
    mode of them; tracks/s is at the median."""
    samples = [3.82, 2.94, 3.80, 2.95, 3.83]
    assert reassoc_exp.ms_cells(samples) == "3.80 (2.94-3.83) | 263"
    assert f"median (min-max) of {reassoc_exp.ROUNDS} graph slopes" in reassoc_exp.MS_HEADER
    rows = [{"cfg": IcpConfig(reassoc_every=k), "ate_m": 1e-3} for k in (1, 2)]
    lines = reassoc_exp.table(rows, [samples, [6.58] * 5]).splitlines()
    assert reassoc_exp.MS_HEADER in lines[0]
    assert lines[2:] == ["| 1 | 1.00 mm | 3.80 (2.94-3.83) | 263 |",
                         "| 2 | 1.00 mm | 6.58 (6.58-6.58) | 152 |"]
