"""Structured JSONL metrics.

Own copy of the JAX package's ``utils/metrics.py`` (framework-free there
too; ``tests/test_torch_package.py`` holds the two equal), so that the port
imports nothing of that package. Every pipeline stage appends one JSON
record per frame (frame id, ms/frame, overlap, keyframe flag, ...), and
``summary()`` aggregates the run.
"""

from __future__ import annotations

import json
import time
from typing import Optional

#: The ONE definition of the "hypotheses" metric: the number of candidate
#: POSES whose residuals were scored against the full correspondence set,
#: i.e. the K dimension the MSAC scoring kernel actually processes. A 3D-3D
#: minimal sample contributes 1 pose; a P3P sample contributes its 4 quartic
#: roots; an adaptive schedule reports the SUM of its rounds' poses.
#: ``RansacResult.num_hypotheses`` follows this definition on every engine
#: path, and ``hypotheses_per_s`` in :meth:`MetricsLogger.summary` therefore
#: means poses scored per second.
HYPOTHESES_DEFINITION = "candidate poses scored against all correspondences"


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "a") if path else None
        self.records = []

    def log(self, **fields):
        rec = {"t": time.time(), **fields}
        self.records.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def summary(self) -> dict:
        frames = [r for r in self.records if "frame" in r]
        out = {"num_records": len(self.records), "num_frames": len(frames)}
        if frames:
            ms = [r["ms"] for r in frames if "ms" in r]
            if ms:
                out["mean_ms_per_frame"] = sum(ms) / len(ms)
                out["frames_per_s"] = 1000.0 / out["mean_ms_per_frame"]
            hyp = [r["hypotheses"] for r in frames if "hypotheses" in r]
            if hyp and ms:
                out["hypotheses_per_s"] = sum(hyp) / (sum(ms) / 1000.0)
        return out

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
