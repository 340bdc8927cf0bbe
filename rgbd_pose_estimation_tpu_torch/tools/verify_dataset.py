"""Real-data readiness kit: is a TUM or ICL-NUIM directory fit to run?

Counterpart of the JAX repository's ``tools/verify_dataset.py``. Pointed at
a dataset directory, it checks every assumption the port makes about data
on disk, then prints the commands that give the ATE of record (TUM
fr1/desk). Each check prints PASS, FAIL or WARN with its evidence:

  1. layout       rgb.txt/depth.txt exist and the files they name resolve
                  (or the raw ICL-NUIM POV-Ray layout is detected)
  2. association  rgb<->depth timestamp pairing coverage and largest gap at
                  the benchmark's 20 ms tolerance
  3. decode       16-bit depth PNGs decode bit for bit the same through the
                  native core (libpng, ``data/native_loader.py``) and the
                  standard-library codec (``data/png.py``); byte order is
                  the classic failure: a big-endian PNG read as
                  little-endian shows up as values x256
  4. depth scale  depth/5000 lands in an indoor range (median 0.2-15 m),
                  and the map is smooth (a byteswapped map is noise)
  5. intrinsics   the preset the directory's name implies, an
                  intrinsics.txt that overrides it, image size vs preset
  6. groundtruth  the GT file parses, frames find their GT, the motion
                  between frames is a handheld camera's
  7. commands     ``odom``, ``slam`` and ``eval`` of the port's CLI

Where the native library cannot be built (no libpng headers), the decode
check says "stdlib codec only"; the reference compares its native core with
OpenCV instead. The kit does no device work and needs no card.

    python -m rgbd_pose_estimation_tpu_torch.tools.verify_dataset <dataset_dir>

Exit code 0 if no check failed, 1 otherwise.
"""

from __future__ import annotations

import os
import shlex
import sys
import zlib

import numpy as np

from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.data import native_loader, png
from rgbd_pose_estimation_tpu_torch.data.icl_nuim import IclNuimSequence, icl_nuim_intrinsics
from rgbd_pose_estimation_tpu_torch.data.tum import TumSequence, _read_file_list
from rgbd_pose_estimation_tpu_torch.eval.traj_io import associate_timestamps

CLI = "python -m rgbd_pose_estimation_tpu_torch.cli.main"

_RESULTS = []


def _report(status: str, name: str, msg: str):
    _RESULTS.append((status, name, msg))
    print(f"[{status:4s}] {name}: {msg}")


def _is_raw_icl(root: str) -> bool:
    try:
        names = os.listdir(root)
    except OSError:
        return False
    return any(n.endswith(".depth") for n in names) and not os.path.exists(
        os.path.join(root, "depth.txt")
    )


def check_layout(root: str) -> str:
    """Returns ``"tum"``, ``"icl_raw"`` or ``""`` (fail)."""
    if _is_raw_icl(root):
        n_depth = sum(1 for n in os.listdir(root) if n.endswith(".depth"))
        gts = [n for n in os.listdir(root) if n.endswith(".gt.freiburg")]
        _report(
            "PASS",
            "layout",
            f"raw ICL-NUIM POV-Ray layout: {n_depth} .depth frames, "
            f"gt={gts[0] if gts else 'MISSING'}",
        )
        return "icl_raw"
    ok = True
    for f in ("rgb.txt", "depth.txt"):
        if not os.path.exists(os.path.join(root, f)):
            _report("FAIL", "layout", f"missing {f} (not a TUM-format dir)")
            ok = False
    if not ok:
        return ""
    missing = 0
    for lst in ("rgb.txt", "depth.txt"):
        _, files = _read_file_list(os.path.join(root, lst))
        for f in files[:: max(1, len(files) // 50)]:  # about 50 of them
            if not os.path.exists(os.path.join(root, f)):
                missing += 1
    if missing:
        _report("FAIL", "layout", f"{missing} referenced files missing on disk")
        return ""
    _report("PASS", "layout", "TUM layout, referenced files resolve")
    return "tum"


def check_association(root: str):
    seq = TumSequence(root)
    rgb_ts, _ = _read_file_list(os.path.join(root, "rgb.txt"))
    dep_ts, _ = _read_file_list(os.path.join(root, "depth.txt"))
    n = len(seq)
    if n == 0:
        _report("FAIL", "association", "0 associated frames at 20 ms tolerance")
        return None
    cov = n / max(min(len(rgb_ts), len(dep_ts)), 1)
    # The largest associated gap, recomputed here as evidence.
    ia, ib = associate_timestamps(rgb_ts, dep_ts, 0.02)
    gap = float(np.abs(rgb_ts[ia] - dep_ts[ib]).max()) if len(ia) else 0.0
    status = "PASS" if cov > 0.8 else "WARN"
    _report(
        status,
        "association",
        f"{n} frames associated ({cov*100:.0f}% of streams), max gap {gap*1e3:.1f} ms",
    )
    return seq


def check_decode(root: str, seq) -> None:
    probes = [0, len(seq) // 2, len(seq) - 1]
    native_ok = native_loader.native_available()
    worst = 0
    for i in probes:
        path = os.path.join(seq.root, seq.depth_files[i])
        try:
            ref = png.read_png(path)
        except (OSError, ValueError, zlib.error) as e:
            _report("FAIL", "decode", f"the stdlib codec cannot read {path}: {e}")
            return
        if ref.dtype != np.uint16 or ref.ndim != 2:
            _report(
                "FAIL",
                "decode",
                f"{path}: depth dtype {ref.dtype}, {ref.ndim} dims, expected uint16 "
                "(8-bit depth PNGs cannot carry TUM 1/5000 range)",
            )
            return
        if native_ok:
            nat = native_loader.decode_depth16(path)
            if nat.shape != ref.shape or not np.array_equal(nat, ref):
                nd = int(np.sum(nat != ref)) if nat.shape == ref.shape else -1
                # The classic byte-order failure: one decoder applying the
                # PNG big-endian convention and the other not differs by
                # exactly a byteswap.
                swapped = nat.shape == ref.shape and np.array_equal(nat.byteswap(), ref)
                _report(
                    "FAIL",
                    "decode",
                    f"native vs stdlib mismatch on {path}: {nd} px differ"
                    + (" — BYTESWAP (16-bit endianness bug)" if swapped else ""),
                )
                return
        worst = max(worst, int(ref.max()))
    src = ("native==stdlib bit-identical" if native_ok
           else "stdlib codec only (native library unavailable)")
    _report("PASS", "decode", f"{len(probes)} probe frames, {src}, max raw {worst}")


def check_depth_scale(seq) -> None:
    _, _, depth = seq.frame(0)
    valid = depth[depth > 0]
    if valid.size == 0:
        _report("WARN", "depth-scale", "frame 0 has no valid depth")
        return
    med = float(np.median(valid))
    if 0.2 <= med <= 15.0:
        _report(
            "PASS",
            "depth-scale",
            f"median depth {med:.2f} m at 1/5000 (indoor-plausible), "
            f"valid {valid.size/depth.size*100:.0f}%",
        )
    elif med > 50.0:
        _report(
            "FAIL",
            "depth-scale",
            f"median {med:.1f} m — x256 byte-order artifact or millimeter "
            "scale (use scale 1/1000?)",
        )
    else:
        _report("WARN", "depth-scale", f"median {med:.2f} m outside 0.2-15 m")

    # Smoothness: a byteswapped 16-bit depth map often stays in range (a
    # byteswap of 5k-30k lands in 2k-60k) but becomes high-frequency noise,
    # the low byte's fine variation landing in the high byte. Real depth is
    # locally smooth: the MEDIAN |step| between horizontally adjacent valid
    # pixels is millimetres (speckle and edges move the tail, not the median).
    a, b = depth[:, :-1], depth[:, 1:]
    both = (a > 0) & (b > 0)
    if both.sum() > 100:
        dmed = float(np.median(np.abs(a[both] - b[both])))
        # Real RGB-D surfaces step a few mm a pixel at the median, even at
        # coarse resolution; a byteswap multiplies the smooth low-byte
        # variation by 256 (steps >= 0.05 m at 1/5000).
        if dmed > 0.05:
            _report(
                "FAIL",
                "depth-smooth",
                f"median adjacent-pixel depth step {dmed:.3f} m vs median "
                f"depth {med:.2f} m — depth is spatial noise (byteswapped "
                "16-bit PNG or corrupt data)",
            )
        else:
            _report(
                "PASS",
                "depth-smooth",
                f"median adjacent-pixel step {dmed*1e3:.1f} mm (smooth)",
            )


def guess_intrinsics(root: str) -> str:
    name = os.path.basename(os.path.normpath(root)).lower()
    if "freiburg1" in name or "fr1" in name:
        return "tum_fr1"
    if "icl" in name or "living_room" in name or "office" in name or _is_raw_icl(root):
        return "icl_nuim"
    return "tum_default"


def check_intrinsics(root: str, seq) -> str:
    override = os.path.join(root, "intrinsics.txt")
    if os.path.exists(override):
        with open(override) as f:
            vals = f.read().split()
        _report(
            "PASS",
            "intrinsics",
            f"intrinsics.txt present (fx={vals[0]}, fy={vals[1]}) — use "
            "--intrinsics from_dataset",
        )
        return "from_dataset"
    preset = guess_intrinsics(root)
    cam = {
        "tum_fr1": CameraIntrinsics.tum_fr1(),
        "tum_default": CameraIntrinsics.tum_default(),
        "icl_nuim": icl_nuim_intrinsics(),
    }[preset]
    _, gray, _ = seq.frame(0)
    h, w = gray.shape
    if (w, h) != (cam.width, cam.height):
        _report(
            "WARN",
            "intrinsics",
            f"preset {preset} is {cam.width}x{cam.height} but frames are "
            f"{w}x{h} — intrinsics will be auto-scaled; verify fx/fy",
        )
    else:
        _report(
            "PASS",
            "intrinsics",
            f"directory implies --intrinsics {preset} "
            f"(fx={cam.fx}, {cam.width}x{cam.height} matches frames)",
        )
    return preset


def check_groundtruth(seq) -> bool:
    if seq.gt_timestamps is None:
        _report(
            "WARN",
            "groundtruth",
            "no groundtruth.txt — odometry runs, ATE of record impossible",
        )
        return False
    idx, poses = seq.groundtruth_aligned()
    cov = len(idx) / max(len(seq), 1)
    if cov < 0.5:
        _report(
            "FAIL",
            "groundtruth",
            f"only {cov*100:.0f}% of frames have GT within 20 ms",
        )
        return False
    rel = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)
    step = float(np.median(rel)) if len(rel) else 0.0
    status = "PASS" if step < 0.2 else "WARN"
    plausible = "handheld-plausible" if step < 0.2 else "LARGE — check units/format"
    _report(
        status,
        "groundtruth",
        f"{len(idx)} frames matched ({cov*100:.0f}%), median inter-frame "
        f"motion {step*1e3:.1f} mm ({plausible})",
    )
    return True


def record_commands(root: str, intrinsics: str, has_gt: bool):
    """The CLI commands of the ATE of record, each as the arguments that
    follow ``cli.main``: ``odom`` with the pose graph, ``slam``, and with
    ground truth ``eval`` of the ``slam`` trajectory."""
    cmds = [
        ["odom", "--dataset", root, "--out", "traj_odom.txt", "--intrinsics", intrinsics,
         "--pose-graph"],
        ["slam", "--dataset", root, "--out", "traj_slam.txt", "--intrinsics", intrinsics,
         "--mesh-devices", "1"],
    ]
    if has_gt:
        cmds.append(["eval", "--est", "traj_slam.txt", "--gt", os.path.join(root, "groundtruth.txt")])
    return cmds


def main(root: str) -> int:
    # A second call in the same process starts from no results.
    del _RESULTS[:]
    print(f"# Dataset readiness: {root}\n")
    kind = check_layout(root)
    if not kind:
        return 1
    if kind == "icl_raw":
        seq = IclNuimSequence(root)
        _report("PASS", "icl-load", f"{len(seq)} raw ICL frames load")
        intr = "icl_nuim"
        has_gt = seq.gt_timestamps is not None
    else:
        seq = check_association(root)
        if seq is None:
            return 1
        check_decode(root, seq)
        check_depth_scale(seq)
        intr = check_intrinsics(root, seq)
        has_gt = check_groundtruth(seq)

    fails = sum(1 for s, _, _ in _RESULTS if s == "FAIL")
    print(f"\n# {len(_RESULTS)} checks: {fails} FAIL, "
          f"{sum(1 for s, _, _ in _RESULTS if s == 'WARN')} WARN")
    if fails == 0:
        print("\n# ATE-of-record commands (metric of record: TUM fr1/desk ATE RMSE):")
        for cmd in record_commands(root, intr, has_gt):
            print(f"{CLI} {cmd[0]} \\")
            print(f"    {shlex.join(cmd[1:])}")
        if not has_gt:
            print("# (no groundtruth.txt: obtain GT to compute the ATE)")
    return 1 if fails else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
