"""The port's ``entry.py`` against the JAX repository's ``__graft_entry__.py``:
the flagship step's configuration and example arguments, and its pose from
the reference's own correspondences and minimal sets."""

import _port_test_settings  # noqa: F401  (first: one torch thread a process)
import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from rgbd_pose_estimation_tpu.data import synthetic as jsyn
from rgbd_pose_estimation_tpu.ransac.prosac import sample_minimal_sets as jax_sample
from rgbd_pose_estimation_tpu_torch import entry as tentry
from rgbd_pose_estimation_tpu_torch.ops import _build
from rgbd_pose_estimation_tpu_torch.parallel import dryrun
from rgbd_pose_estimation_tpu_torch.ransac import engine as tengine
from rgbd_pose_estimation_tpu_torch.utils.convert import config_from_reference, to_torch

POSE_TOL = 0.05  # the bench's accuracy gate


@pytest.fixture(scope="module")
def reference():
    """The reference entry's step, compiled as one jit region (as its
    docstring says), on its own example arguments; and the ground truth of its
    problem (``key(0)``, as ``entry()`` draws it). The entry's problem
    generator is jitted once (eagerly it compiles every primitive)."""
    correspondences = jax.jit(jsyn.synthetic_correspondences,
                              static_argnames=("n", "outlier_frac", "noise"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsyn, "synthetic_correspondences", correspondences)
        fn, (key, p, q) = jentry.entry()
    pose, num_inliers = jax.jit(fn)(key, p, q)
    T_gt = correspondences(jax.random.key(0), **tentry.EXAMPLE)[2]
    cfg = inspect.getclosurevars(fn).nonlocals["cfg"]
    return {"fn": fn, "key": key, "p": np.asarray(p), "q": np.asarray(q), "cfg": cfg,
            "pose": np.asarray(pose), "num_inliers": float(num_inliers), "T_gt": np.asarray(T_gt)}


def test_entry_has_the_reference_config_and_shapes(reference):
    fn, (gen, p, q) = tentry.entry(device="cpu")
    assert tentry.CONFIG == config_from_reference(reference["cfg"])
    assert (tentry.CONFIG.num_hypotheses, tentry.CONFIG.threshold) == (1024, 0.05)
    for own, ref in ((p, reference["p"]), (q, reference["q"])):
        assert own.shape == ref.shape == (512, 3)
        assert own.dtype == torch.float32 and ref.dtype == np.float32
        assert own.device.type == "cpu"
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
    # The sampler's generator is seeded 1, the data's 0 (the reference's key(1), key(0)).
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(tentry.SAMPLER_SEED).get_state())
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip


def test_entry_pose_matches_reference_from_its_minimal_sets(reference):
    """On the reference entry's p, q and the minimal sets JAX draws from its
    key, the port's estimate is the reference's pose within 2e-3 (the
    engine's contract, tests/test_torch_engine.py), and both are within
    0.05 of the truth. CPU tensors launch no kernel."""
    cfg = config_from_reference(reference["cfg"])
    idx = np.asarray(jax_sample(reference["key"], 512, cfg.num_hypotheses, cfg.sample_size,
                                reference["cfg"].prosac))
    before = _build.launch_counts()
    res = tengine._estimate_from_samples(*to_torch((idx, reference["p"], reference["q"]), "cpu"), cfg)
    assert _build.launch_counts() == before
    pose = res.pose.numpy()
    np.testing.assert_allclose(pose, reference["pose"], atol=2e-3)
    assert abs(float(res.num_inliers) - reference["num_inliers"]) <= 2
    assert np.abs(pose - reference["T_gt"]).max() < POSE_TOL
    assert np.abs(reference["pose"] - reference["T_gt"]).max() < POSE_TOL


def test_entry_step_on_the_cpu():
    """``fn(*args)`` on the CPU: a pose within 0.05 of the port's own example
    problem's truth, ~30% of the rows outliers, nothing launched."""
    fn, args = tentry.entry(device="cpu")
    before = _build.launch_counts()
    pose, num_inliers = fn(*args)
    assert _build.launch_counts() == before
    _, _, T_gt, inliers = tentry.example_problem("cpu")
    assert pose.shape == (4, 4) and num_inliers.shape == ()
    assert float((pose - T_gt).abs().max()) < POSE_TOL
    assert abs(float(num_inliers) - float(inliers.sum())) <= 5


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
