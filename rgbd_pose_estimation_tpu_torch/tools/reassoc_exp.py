"""Association-reuse experiment: ATE and track time against ``reassoc_every``.

Counterpart of the JAX repository's ``tools/reassoc_exp.py``. Classic ICP
alternation allows several minimize steps over one association
(``IcpConfig.reassoc_every``); this measures what that costs in accuracy and
saves in time on the 10-frame 640x480 hard-mode sequence (handheld motion,
Kinect-style depth: ``data/synthetic.py::synthetic_sequence_hard``) at the
config-3 stride, for ``reassoc_every`` in {1, 2, 3}:

- accuracy (:func:`ate_rows`, any device): frame-to-frame odometry from the
  identity, each track accumulated on the host in float64, then the ATE
  RMSE of the camera centres against ground truth;
- time (:func:`track_ms`, the card only): the CUDA-graph slope of chained
  tracks of frame 1 onto frame 0 (``tools/roofline.py::timeit_chain``),
  ``ROUNDS`` of them a setting taken in turns with the other settings
  (:func:`track_times`); the table gives their median and their range.

On the card a depth-only step with nearest association is one launch of the
fused ICP step (``ops/icp_jtj.py::icp_assoc_jtj_jtr``), whichever
``reassoc_every``: a carried step reads the map of target pixels its fresh
step left. The sequence comes from a ``torch.Generator`` seeded 5 (the
reference's ``key(5)``; the two random streams differ, so the numbers do).

    python -m rgbd_pose_estimation_tpu_torch.tools.reassoc_exp [--cpu]

prints the card's name and power limit and a markdown table (``--cpu``: the
ATE column only, on the CPU).
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_sequence_hard
from rgbd_pose_estimation_tpu_torch.eval.ate import ate_rmse
from rgbd_pose_estimation_tpu_torch.icp.dense import icp_track, make_icp_frame
from rgbd_pose_estimation_tpu_torch.tools.roofline import device_line, require_cuda, timeit_chain
from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig

SETTINGS = (1, 2, 3)  # reassoc_every
SEED = 5
CONFIG3_STRIDE = (4, 4, 2)
# Graph slopes a setting, taken in turns with the other settings. The slopes
# of these tracks are bimodal (two values ~25% apart for the same work), so
# a table gives the median and the range of all of them, not one mode.
ROUNDS = 5


def camera(H: int = 480, W: int = 640) -> CameraIntrinsics:
    """The experiments' camera: fx = fy = 525, centred."""
    return CameraIntrinsics(fx=525.0, fy=525.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)


def hard_sequence(cam: CameraIntrinsics, seed: int, n_frames: int, device="cuda"):
    """``(poses, depths, intensities)`` of the hard-mode sequence drawn from a
    generator seeded ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    poses, depths, intensities, _ = synthetic_sequence_hard(cam, gen, n_frames, device=device)
    return poses, depths, intensities


def true_centres(poses) -> np.ndarray:
    """Camera centres of world→camera poses: ``inv(gt)[:3, 3]``."""
    return np.stack([np.linalg.inv(g)[:3, 3] for g in np.asarray(poses.cpu())])


def odometry_centres(cam: CameraIntrinsics, cfg: IcpConfig, depths, intensities=None) -> np.ndarray:
    """Frame-to-frame odometry: each frame tracked onto the one before it
    from the identity, the tracks accumulated on the host in float64. The
    intensity enters the frames only when ``cfg.photometric_weight > 0``.
    Returns the ``(F, 3)`` camera centres in the first camera's frame."""
    photo = cfg.photometric_weight > 0 and intensities is not None
    frames = [
        make_icp_frame(cam, depths[i], cfg, intensity=intensities[i] if photo else None)
        for i in range(depths.shape[0])
    ]
    eye = torch.eye(4, dtype=torch.float32, device=depths.device)
    T_acc = [np.eye(4)]
    for i in range(1, len(frames)):
        T, _ = icp_track(cam, cfg, eye, frames[i], frames[i - 1])
        T_acc.append(T_acc[-1] @ T.cpu().numpy())
    return np.stack(T_acc)[:, :3, 3]


def ate_rows(cam: CameraIntrinsics, poses, depths, cfgs, intensities=None):
    """One row a config: ``{"cfg", "centres", "ate_m"}`` of
    :func:`odometry_centres` against the true centres."""
    gt = true_centres(poses)
    rows = []
    for cfg in cfgs:
        centres = odometry_centres(cam, cfg, depths, intensities)
        rows.append({"cfg": cfg, "centres": centres, "ate_m": ate_rmse(centres, gt)})
    return rows


def configs(stride=CONFIG3_STRIDE):
    return [IcpConfig(source_stride=tuple(stride), reassoc_every=k) for k in SETTINGS]


def track_ms(cam: CameraIntrinsics, cfg: IcpConfig, depths, intensities=None) -> float:
    """Milliseconds of one track of frame 1 onto frame 0 on the card: the
    CUDA-graph slope of 2 and 12 chained tracks. Raises ``RuntimeError``
    without a card."""
    require_cuda()
    if not depths.is_cuda:
        raise RuntimeError("track_ms times tracks on the CUDA device: pass depths there")
    photo = cfg.photometric_weight > 0 and intensities is not None
    src, tgt = (
        make_icp_frame(cam, depths[i], cfg, intensity=intensities[i] if photo else None)
        for i in (1, 0)
    )

    def step(T):
        return icp_track(cam, cfg, T, src, tgt)[0]

    return timeit_chain(step, torch.eye(4, device=depths.device), n1=2, n2=12) * 1e3


def track_times(cam: CameraIntrinsics, cfgs, depths, intensities=None):
    """``ROUNDS`` samples of :func:`track_ms` a config (ms), the configs
    taken in turns: ``samples[c]`` for config ``c``."""
    samples = [[] for _ in cfgs]
    for _ in range(ROUNDS):
        for c, cfg in enumerate(cfgs):
            samples[c].append(track_ms(cam, cfg, depths, intensities))
    return samples


# The time columns' header: what a cell of them holds.
MS_HEADER = f"track ms, median (min-max) of {ROUNDS} graph slopes | tracks/s at the median"


def ms_cells(samples):
    """The time cells of one row from its ``samples`` (ms), or None."""
    if samples is None:
        return "not measured (CPU) | not measured (CPU)"
    med = statistics.median(samples)
    return f"{med:.2f} ({min(samples):.2f}-{max(samples):.2f}) | {1e3 / med:.0f}"


def table(rows, ms=None):
    """The reference's markdown table; ``ms`` the :func:`track_times`
    samples of each row, or None."""
    lines = [f"| reassoc_every | ATE RMSE | {MS_HEADER} |", "|---|---|---|---|"]
    for i, row in enumerate(rows):
        lines.append(f"| {row['cfg'].reassoc_every} | {row['ate_m'] * 1e3:.2f} mm | "
                     f"{ms_cells(None if ms is None else ms[i])} |")
    return "\n".join(lines)


def run(H=480, W=640, n_frames=10, stride=CONFIG3_STRIDE, device="cuda"):
    """Print the table (on the card: the card's name and power limit above
    it, and the track times). Returns ``(rows, ms)``: ``ms`` the
    :func:`track_times` samples, None on the CPU."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        require_cuda()
        print(device_line())
    cam = camera(H, W)
    print(f"hard sequence: {n_frames} frames {W}x{H}, stride={tuple(stride)}")
    poses, depths, _ = hard_sequence(cam, SEED, n_frames, device)
    rows = ate_rows(cam, poses, depths, configs(stride))
    ms = track_times(cam, [r["cfg"] for r in rows], depths) if on_card else None
    print(table(rows, ms))
    return rows, ms


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="the ATE column only, on the CPU")
    run(device="cpu" if ap.parse_args().cpu else "cuda")
