"""Entry points of the port: the flagship step and the multi-device dry run.

Counterpart of the JAX repository's ``__graft_entry__.py``:

- :func:`entry` returns the flagship forward step and its example
  arguments. The flagship is the batched RANSAC frame-pair estimator
  (configurations 1-2): PROSAC sampling, the minimal moments (K1), Horn's
  solve of every minimal set, the bf16 fast ranking (K2), the exact
  re-score of the finalists (K3) and the weighted refit. The reference
  compiles it as one jit region; here it is one eager call that reads
  nothing back, so a CUDA graph can capture it whole;
- :func:`dryrun_multichip` is ``parallel/dryrun.py``'s, re-exported.

Run on the card (``device="cpu"`` runs the plain versions of the kernels)::

    from rgbd_pose_estimation_tpu_torch.entry import entry
    fn, args = entry()
    pose, num_inliers = fn(*args)
"""

from __future__ import annotations

import torch

from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_correspondences
from rgbd_pose_estimation_tpu_torch.parallel.dryrun import dryrun_multichip
from rgbd_pose_estimation_tpu_torch.ransac.engine import estimate_pose_3d3d
from rgbd_pose_estimation_tpu_torch.utils.config import RansacConfig

__all__ = ["CONFIG", "EXAMPLE", "dryrun_multichip", "entry", "example_problem"]

CONFIG = RansacConfig(num_hypotheses=1024, threshold=0.05)
# The example problem: 512 correspondences, 30% outliers, 3 mm noise.
EXAMPLE = dict(n=512, outlier_frac=0.3, noise=0.003)
DATA_SEED, SAMPLER_SEED = 0, 1


def _generator(seed: int, device) -> torch.Generator:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "entry() runs on the CUDA device and there is none; pass device='cpu' to run on the CPU"
        )
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def example_problem(device="cuda"):
    """The example arguments' problem: ``(p, q, T_gt, inlier_mask)`` from
    ``synthetic_correspondences`` drawn with a generator seeded
    ``DATA_SEED`` on ``device`` (the reference draws from ``key(0)``: the two
    random streams differ, so the numbers do too)."""
    return synthetic_correspondences(_generator(DATA_SEED, device), device=device, **EXAMPLE)


def entry(device="cuda"):
    """The flagship forward step and its example arguments.

    Returns ``(fn, (generator, p, q))``: ``fn(generator, p, q)`` runs
    ``estimate_pose_3d3d`` with :data:`CONFIG` and returns ``(pose (4, 4),
    num_inliers ())``, both on ``device``; ``generator`` is the sampler's,
    seeded ``SAMPLER_SEED`` on ``device``. On the card a call launches K1,
    K2 and K3 once each.
    """

    def fn(generator, p, q):
        res = estimate_pose_3d3d(generator, p, q, CONFIG)
        return res.pose, res.num_inliers

    p, q, _, _ = example_problem(device)
    return fn, (_generator(SAMPLER_SEED, device), p, q)
