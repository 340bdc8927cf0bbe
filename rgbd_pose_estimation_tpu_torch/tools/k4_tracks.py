"""The dense-ICP tracks that go through K4 (``ops/icp_jtj.py::icp_jtj_jtr``),
timed so that two checkouts can be set side by side on one card.

The photometric and the bilinear track at 160x120, three levels, on the
frame pair of ``chip_smoke.py``'s phase ``icp_track`` (the analytic scene,
the same pose): K4 runs once a Gauss-Newton step, 22 times a track. For
each track it prints

- ``eager_ms``: one track as the program runs it, CUDA events around it
  (the host's launching included), every sample and their median;
- ``graph_ms``: the CUDA-graph slope of chained tracks
  (``tools/roofline.py::timeit_chain``), measured ``--repeats`` times;
- the device's kernels and busy time of one track, and K4's kernels and
  their device time in it, under ``torch.profiler``;

and for K4's wrapper alone, at the rows of the photometric track's finest
level, the host's microseconds a call (calls back to back, the card keeping
up), the device's kernels and time a call, and where the package keeps
K4's ticket on the host (``ops/icp_jtj.py::_ticket``), the host's
microseconds of finding it.

    python rgbd_pose_estimation_tpu_torch/tools/k4_tracks.py [--root CHECKOUT]

``--root`` is the checkout whose package is timed (default: the one holding
this file). The file calls only what a parent and its change both have
(and the ticket where there is one), so one copy of it times both. Prints one JSON line, the card's
name and power limit in it. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--repeats", type=int, default=7, help="graph slopes a track")
    ap.add_argument("--tracks", type=int, default=20, help="eager tracks timed a track")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
    from rgbd_pose_estimation_tpu_torch.core.lie import se3_exp
    from rgbd_pose_estimation_tpu_torch.data.synthetic import synthetic_depth_scene
    from rgbd_pose_estimation_tpu_torch.icp.dense import icp_track, level_step, make_icp_frame
    from rgbd_pose_estimation_tpu_torch.ops import icp_jtj
    from rgbd_pose_estimation_tpu_torch.tools.roofline import timeit_chain
    from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig

    if not torch.cuda.is_available():
        raise SystemExit("k4_tracks: no CUDA card")
    import rgbd_pose_estimation_tpu_torch as package

    dev = "cuda"
    cam = CameraIntrinsics(525.0, 525.0, 319.5, 239.5, 640, 480).scaled(0.25)
    T_gt = se3_exp(torch.tensor([0.01, -0.008, 0.005, 0.01, -0.012, 0.008], device=dev))
    eye = torch.eye(4, device=dev)

    def events_ms(fn):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
                rows.append((ev.key, ev.count, us))
        return rows

    out = {"root": str(pathlib.Path(package.__file__).resolve().parents[1])}
    photo_rows = None
    for name, cfg, intensity in (("photometric_160x120", IcpConfig(photometric_weight=0.5), True),
                                 ("bilinear_160x120", IcpConfig(association="bilinear"), False)):
        da, ia = synthetic_depth_scene(cam, eye)
        db, ib = synthetic_depth_scene(cam, T_gt)
        tgt = make_icp_frame(cam, da, cfg, ia if intensity else None)
        src = make_icp_frame(cam, db, cfg, ib if intensity else None)
        T, _ = icp_track(cam, cfg, eye, src, tgt)
        err = float((T @ T_gt - eye).abs().max())
        for _ in range(3):
            icp_track(cam, cfg, eye, src, tgt)
        torch.cuda.synchronize()
        eager = [events_ms(lambda: icp_track(cam, cfg, eye, src, tgt)) for _ in range(args.tracks)]
        rows = profiled(lambda: icp_track(cam, cfg, eye, src, tgt))
        graph = [1e3 * timeit_chain(lambda T: icp_track(cam, cfg, T, src, tgt)[0], eye, n1=4, n2=36)
                 for _ in range(args.repeats)]
        out[name] = {
            "pose_max_err": err,
            "eager_ms_median": statistics.median(eager), "eager_ms": eager,
            "graph_ms_min": min(graph), "graph_ms_median": statistics.median(graph), "graph_ms": graph,
            "device_kernels": sum(r[1] for r in rows),
            "device_busy_ms": sum(r[2] for r in rows) / 1e3,
            "k4_device_kernels": sum(r[1] for r in rows if "icp_jtj_" in r[0]),
            "k4_device_ms": sum(r[2] for r in rows if "icp_jtj_" in r[0]) / 1e3,
        }
        if intensity:
            photo_rows = level_step(cam, cfg, src, tgt, 0)[1](eye)[0]

    # K4's wrapper alone on the photometric track's finest rows.
    p, q, n, w = photo_rows
    k4 = lambda: icp_jtj.icp_jtj_jtr(p, q, n, w)  # noqa: E731
    for _ in range(50):
        k4()
    torch.cuda.synchronize()
    host_us = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(2000):
            k4()
        host_us.append((time.perf_counter() - t0) / 2000 * 1e6)
        torch.cuda.synchronize()
    rows = profiled(lambda: [k4() for _ in range(100)])
    out["k4_wrapper"] = {
        "M": p.shape[0],
        "host_us_a_call": host_us, "host_us_a_call_min": min(host_us),
        "host_us_a_call_median": statistics.median(host_us),
        "device_kernels_a_call": sum(r[1] for r in rows) / 100,
        "device_us_a_call": sum(r[2] for r in rows if "icp_jtj_" in r[0]) / 100,
    }
    if hasattr(icp_jtj, "_ticket"):
        t0 = time.perf_counter()
        for _ in range(20000):
            icp_jtj._ticket(p.device)
        out["k4_wrapper"]["ticket_host_us_a_call"] = (time.perf_counter() - t0) / 20000 * 1e6
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
