"""Photometric-term experiment: ATE and track time against ``photometric_weight``.

Counterpart of the JAX repository's ``tools/photometric_exp.py``. The
DVO-style intensity residual (``IcpConfig.photometric_weight``) fixes the
flat-wall degeneracy of point-to-plane ICP, and no shipped config turns it
on; this measures what it buys and costs on the 10-frame 640x480 hard-mode
sequence at the config-3 stride and ``reassoc_every=2``, for weights
{0, 0.1, 0.5} and sequences of seeds {5, 6, 7}:

- accuracy (any device): the ATE of frame-to-frame odometry on each seed's
  sequence, as in ``tools/reassoc_exp.py``; a frame carries its intensity
  only when the weight is above 0;
- time (the card only): one track of frame 1 onto frame 0 of the first
  seed's sequence for each weight, CUDA-graph slopes taken in turns
  (``tools/reassoc_exp.py::track_times``), their median and range.

On the card the two routes are different kernels: at weight 0 a step is one
launch of the fused ICP step (``ops/icp_jtj.py::icp_assoc_jtj_jtr``); above
0 the step makes its residual rows in PyTorch and accumulates them with K4
(``ops/icp_jtj.py::icp_jtj_jtr``), one launch a step.

    python -m rgbd_pose_estimation_tpu_torch.tools.photometric_exp [--cpu]

prints the card's name and power limit and a markdown table (``--cpu``: the
ATE column only, on the CPU).
"""

from __future__ import annotations

import argparse

import torch

from rgbd_pose_estimation_tpu_torch.tools.reassoc_exp import (
    CONFIG3_STRIDE,
    MS_HEADER,
    ate_rows,
    camera,
    hard_sequence,
    ms_cells,
    track_times,
)
from rgbd_pose_estimation_tpu_torch.tools.roofline import device_line, require_cuda
from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig

WEIGHTS = (0.0, 0.1, 0.5)
SEEDS = (5, 6, 7)
REASSOC = 2


def configs(stride=CONFIG3_STRIDE, reassoc=REASSOC, weights=WEIGHTS):
    return [
        IcpConfig(source_stride=tuple(stride), reassoc_every=reassoc, photometric_weight=w)
        for w in weights
    ]


def ate_table(cam, n_frames, cfgs, seeds=SEEDS, device="cuda"):
    """ATE in metres, ``ates[c][s]`` for config ``c`` on the sequence of seed
    ``seeds[s]``; also returns the first seed's ``(depths, intensities)``,
    the frames the track times are taken on."""
    ates = [[] for _ in cfgs]
    first = None
    for seed in seeds:
        poses, depths, intensities = hard_sequence(cam, seed, n_frames, device)
        if first is None:
            first = (depths, intensities)
        for c, row in enumerate(ate_rows(cam, poses, depths, cfgs, intensities)):
            ates[c].append(row["ate_m"])
    return ates, first


def table(cfgs, ates, ms=None):
    """The reference's markdown table; ``ms`` the ``track_times`` samples of
    each config, or None."""
    lines = [f"| photometric_weight | ATE RMSE (per seed, mm) | {MS_HEADER} |",
             "|---|---|---|---|"]
    for c, cfg in enumerate(cfgs):
        per_seed = " / ".join(f"{a * 1e3:.2f}" for a in ates[c])
        lines.append(f"| {cfg.photometric_weight} | {per_seed} | "
                     f"{ms_cells(None if ms is None else ms[c])} |")
    return "\n".join(lines)


def run(H=480, W=640, n_frames=10, stride=CONFIG3_STRIDE, reassoc=REASSOC,
        weights=WEIGHTS, seeds=SEEDS, device="cuda"):
    """Print the table (on the card: the card's name and power limit above
    it, and the track times). Returns ``(ates, ms)``: ``ms`` the
    ``track_times`` samples, None on the CPU."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        require_cuda()
        print(device_line())
    cam = camera(H, W)
    print(f"hard sequence: {n_frames} frames {W}x{H}, stride={tuple(stride)}, "
          f"reassoc_every={reassoc}, seeds={list(seeds)}")
    cfgs = configs(stride, reassoc, weights)
    ates, (depths, intensities) = ate_table(cam, n_frames, cfgs, seeds, device)
    ms = track_times(cam, cfgs, depths, intensities) if on_card else None
    print(table(cfgs, ates, ms))
    return ates, ms


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="the ATE column only, on the CPU")
    run(device="cpu" if ap.parse_args().cpu else "cuda")
