"""models/frame_pair.py of the PyTorch port against the JAX package's
``FramePairEstimator``, on the CPU: both modes at 320x240 through the FAST+BRIEF
detector, one pair through host ORB, and the adaptive schedule.

The frames are the port's synthetic sequence, handed to both as numpy. JAX
draws the minimal sets (``jax.random.key(0)``, as its estimator does); the
port's estimator runs from those very sets.
"""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics as JCamera
from rgbd_pose_estimation_tpu.models.frame_pair import FramePairEstimator as JFramePair
from rgbd_pose_estimation_tpu.ransac.prosac import sample_minimal_sets as jax_sample
from rgbd_pose_estimation_tpu.utils.config import RansacConfig as JRansacConfig
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence
from rgbd_pose_estimation_tpu.ops.ransac_score import best_pose_3d3d as jbest_pose
from rgbd_pose_estimation_tpu_torch.features.frontend import matched_3d3d
from rgbd_pose_estimation_tpu_torch.models.frame_pair import (
    FramePairEstimate,
    FramePairEstimator,
)
from rgbd_pose_estimation_tpu_torch.ops.ransac_score import best_pose_3d3d
from rgbd_pose_estimation_tpu_torch.ransac.engine import (
    pad_correspondences_3d3d,
    required_hypotheses,
)
from rgbd_pose_estimation_tpu_torch.solvers.absolute_orientation import horn_quaternion
from rgbd_pose_estimation_tpu_torch.utils.convert import (
    camera_from_reference,
    config_from_reference,
)

W, H = 320, 240
JCAM = JCamera(W * 1.0, W * 1.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
CAM = camera_from_reference(JCAM)
# Padded past the ~280 matches of the pair far enough for the adaptive
# schedule's pin (a padded ratio under 0.47) and not so far that pad rows
# outnumber twice the inliers (the two-stage ranking's pin below). The 3D-3D
# config is also the adaptive test's full round, so JAX compiles it once.
MAX_CORR = 640
CFGS = {
    "3d3d": JRansacConfig(num_hypotheses=512, probe_hypotheses=64, threshold=0.02),
    "2d3d": JRansacConfig(num_hypotheses=256, threshold=0.01),
}
# The engines' parity tolerance (tests/test_torch_engine.py): on the CPU the
# reference scores every hypothesis exactly, the port ranks them with its
# production two-stage scorer, so the two may enter the refit from different
# near-tied hypotheses, which share one refit basin to 2e-3.
POSE_ATOL = 2e-3
TRUTH_TOL = 0.02  # tests/unit/test_tpu_features.py's gate against ground truth


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(5)
    poses, depths, intens = synthetic_sequence(CAM, g, 2, motion_scale=0.01, device="cpu")
    poses = poses.numpy()
    T_ab = poses[1] @ np.linalg.inv(poses[0])
    return [i.numpy() for i in intens], [d.numpy() for d in depths], T_ab


def _images(frames, mode):
    (ga, gb), (da, db), _ = frames
    return (ga, da, gb, db) if mode == "3d3d" else (ga, da, gb)


def _check_against_reference(frames, mode, detector):
    jcfg = CFGS[mode]
    key = jax.random.key(0)
    ref = JFramePair(JCAM, jcfg, mode=mode, max_corr=MAX_CORR, detector=detector)
    r = ref.estimate(*_images(frames, mode), key=key)
    m = jcfg.sample_size if mode == "3d3d" else 3
    idx = np.asarray(jax_sample(key, MAX_CORR, jcfg.num_hypotheses, m, jcfg.prosac))
    est = FramePairEstimator(CAM, config_from_reference(jcfg), mode=mode, max_corr=MAX_CORR,
                             detector=detector, device="cpu")
    out = est.estimate(*_images(frames, mode), samples=idx)
    assert isinstance(out, FramePairEstimate) and out.pose.dtype == np.float32
    assert out.num_matches == r.num_matches >= 30
    assert out.valid == r.valid is True
    assert out.num_hypotheses == r.num_hypotheses
    np.testing.assert_allclose(out.pose, r.pose, atol=POSE_ATOL)
    assert abs(out.num_inliers - r.num_inliers) <= 2
    T_ab = frames[2]
    for pose in (out.pose, r.pose):
        assert np.abs(pose[:3, :3] - T_ab[:3, :3]).max() < TRUTH_TOL
        assert np.abs(pose[:3, 3] - T_ab[:3, 3]).max() < TRUTH_TOL
    return est, out


@pytest.mark.parametrize("mode", ["3d3d", "2d3d"])
def test_frame_pair_matches_reference(frames, mode):
    est, out = _check_against_reference(frames, mode, "tpu")
    # The port's own sampler (a torch.Generator seeded 0 by default) finds
    # the same pose within the ground-truth gate, and reruns repeat it.
    own = est.estimate(*_images(frames, mode))
    again = est.estimate(*_images(frames, mode))
    np.testing.assert_array_equal(own.pose, again.pose)
    assert own.valid and np.abs(own.pose - out.pose).max() < TRUTH_TOL


def test_frame_pair_orb_matches_reference(frames):
    pytest.importorskip("cv2")
    _check_against_reference(frames, "3d3d", "orb")


def test_frame_pair_adaptive_ratio_divides_by_padded_n(frames):
    """A fault of the reference, ported as it is: the frame pair pads the
    correspondences to ``max_corr`` before the adaptive schedule, which
    divides the probe's inliers by the PADDED count. With under 300 matches
    in 640 rows the ratio looks like ~0.43, the bound asks for ~86 samples
    instead of 64, and the full round runs, although nearly every match is
    an inlier."""
    jcfg = CFGS["3d3d"]
    ref = JFramePair(JCAM, jcfg, max_corr=MAX_CORR, detector="tpu", adaptive=True)
    r = ref.estimate(*_images(frames, "3d3d"))
    padded = FramePairEstimator(CAM, config_from_reference(jcfg), max_corr=MAX_CORR,
                                detector="tpu", adaptive=True, device="cpu")
    out = padded.estimate(*_images(frames, "3d3d"))
    assert out.num_hypotheses == r.num_hypotheses == 64 + 512
    assert out.num_matches == r.num_matches and out.valid and r.valid
    assert out.num_inliers >= 0.9 * out.num_matches
    conf = jcfg.confidence
    assert required_hypotheses(out.num_inliers / MAX_CORR, 3, conf) > 64
    assert required_hypotheses(out.num_inliers / out.num_matches, 3, conf) <= 64
    # Padded to its own match count, the same pair stops after the probe.
    tight = dataclasses.replace(padded, max_corr=out.num_matches)
    assert tight.estimate(*_images(frames, "3d3d")).num_hypotheses == 64


def test_two_stage_ranking_picks_a_pad_hypothesis_when_pads_outnumber_twice_the_inliers(frames):
    """A fault of the reference's production (TPU) scorer, ported as it is:
    the fast ranking's bf16 quad form cancels catastrophically on the ~1e4
    pad sentinels, so a hypothesis built from a sample with a pad row scores
    about half of the pad rows at zero cost. Where pad rows outnumber twice
    the inliers, every group's fast argmin is such a hypothesis and the
    exact re-score can only choose among them. Here 276 matches padded to
    1024 rows: the port and the reference's two-stage scorer (bf16-emulated
    on the CPU) pick the same hypothesis, which has no real inlier, while
    the exact scorer (the reference's CPU branch) finds one with ~250."""
    (ga, gb), (da, db), _ = frames
    p, q = matched_3d3d(CAM, ga, da, gb, db, detector="tpu", device="cpu")
    pp, qq = pad_correspondences_3d3d(torch.from_numpy(p), torch.from_numpy(q), 1024)
    idx = torch.from_numpy(np.array(jax_sample(jax.random.key(0), 1024, 512, 3, True)))
    T = horn_quaternion(pp[idx.long()], qq[idx.long()])
    tau2 = 0.02**2
    best, score = best_pose_3d3d(T, pp, qq, 0.02)
    args = [jax.numpy.asarray(a.numpy()) for a in (T, pp, qq)]
    ref_best, ref_score = jbest_pose(*args, 0.02, impl="two_stage")
    exact_best, exact_score = jbest_pose(*args, 0.02, impl="exact")
    assert int(best) == int(ref_best)
    assert float(score) / tau2 > 1024 - 2 and float(ref_score) / tau2 > 1024 - 2
    assert float(exact_score) / tau2 < 1024 - 200


def test_frame_pair_arguments():
    assert FramePairEstimator(CAM).device == "cuda"  # the card unless told otherwise
    est = FramePairEstimator(CAM, device="cpu", detector="tpu")
    img = np.zeros((H, W), np.float32)
    with pytest.raises(ValueError, match="depth for both"):
        est.estimate(img, img, img)
    with pytest.raises(ValueError, match="adaptive"):
        dataclasses.replace(est, adaptive=True).estimate(
            img, img, img, img, samples=np.zeros((4, 3), np.int32))
