"""A copy of the benchmark at sizes a CPU test can hold: the same files,
clients, readers, references and limits, with each cell's configuration and
mix cut down (a 160x120 camera, at which every level of the track still
takes its steps, and 12-frame sequences; 4 problems of 256
correspondences and 512 hypotheses)."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]


def _edit(path: pathlib.Path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def small_root(tmp) -> pathlib.Path:
    tmp = pathlib.Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp / "benchmark"

    def camera(c):
        cam = c["camera"]
        for k in ("fx", "fy", "cx", "cy"):
            cam[k] /= 4
        cam["width"], cam["height"] = 160, 120

    _edit(b / "configs/icp_odometry_c3.json", camera)
    _edit(b / "traffic/stream.json",
          lambda m: m.update(frames=12, warmup_frames=4, trace_skip=2, trace_requests=6))
    _edit(b / "traffic/bulk.json",
          lambda m: m.update(pool=4, correspondences=256, hypotheses=512, warmup_requests=1,
                             trace_skip=1, trace_requests=3))
    return tmp


def last_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
