"""Aggregate metrics JSONL files into one measurement table.

Own copy of the JAX package's ``eval/report.py`` (pure Python): one row per
run, filled from the JSONL records the pipelines emit (utils/metrics.py).
Usable as a module or
``python -m rgbd_pose_estimation_tpu_torch.eval.report run1.jsonl run2.jsonl``.
"""

from __future__ import annotations

import json
import sys


def load_jsonl(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# Per-stage scaling observables surfaced into the summary: the numbers a
# multi-process run's JSONL carries for each stage.
_STAGE_KEYS = {
    "odometry": ("frames", "chunks", "local_chunks", "frames_tracked"),
    "io": ("frames_decoded", "frames_total", "peak_cached"),
    "keyframes": ("count", "descriptors_local"),
    "loops": ("candidates", "accepted", "verify_pairs_local",
              "pyramids_built"),
    "ba_build": ("detector", "detect_calls", "match_pairs_local",
                 "num_landmarks", "num_observations"),
    "ba": ("layout", "reshard_dropped", "cost_first", "cost_last"),
}


def summarize(records) -> dict:
    frames = [r for r in records if "frame" in r]
    out = {"num_frames": len(frames)}
    ms = [r["ms"] for r in frames if "ms" in r]
    if ms:
        out["mean_ms_per_frame"] = sum(ms) / len(ms)
        out["frames_per_s"] = 1000.0 / out["mean_ms_per_frame"]
    hyp = [r["hypotheses"] for r in frames if "hypotheses" in r]
    if hyp and ms:
        out["hypotheses_per_s"] = sum(hyp) / (sum(ms) / 1000.0)
    kf = [r for r in frames if r.get("keyframe")]
    out["num_keyframes"] = len(kf)
    ate = [r["ate_rmse"] for r in records if "ate_rmse" in r]
    if ate:
        out["ate_rmse"] = ate[-1]
    stages = {}
    for r in records:
        name = r.get("stage")
        if name in _STAGE_KEYS:
            stages.setdefault(name, {}).update(
                {k: r[k] for k in _STAGE_KEYS[name] if k in r}
            )
    if stages:
        out["stages"] = stages
    return out


def report_table(paths) -> str:
    rows = []
    for p in paths:
        s = summarize(load_jsonl(p))
        rows.append((p, s))
    cols = ["num_frames", "frames_per_s", "hypotheses_per_s", "num_keyframes", "ate_rmse"]
    # Scaling-observable columns (dotted stage.key), shown when any run
    # carries them — this is the per-process split a pod run reports.
    stage_cols = [
        "odometry.frames_tracked", "io.frames_decoded",
        "ba_build.detect_calls", "loops.verify_pairs_local",
        "ba.reshard_dropped",
    ]

    def stage_get(s, dotted):
        st, k = dotted.split(".")
        return s.get("stages", {}).get(st, {}).get(k)

    active = [c for c in stage_cols if any(stage_get(s, c) is not None for _, s in rows)]
    allc = cols + active
    lines = ["| run | " + " | ".join(allc) + " |",
             "|" + "---|" * (len(allc) + 1)]
    for p, s in rows:
        vals = [
            f"{s[c]:.4g}" if isinstance(s.get(c), float) else str(s.get(c, "—"))
            for c in cols
        ] + [str(v) if (v := stage_get(s, c)) is not None else "—" for c in active]
        lines.append(f"| {p} | " + " | ".join(vals) + " |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(report_table(sys.argv[1:]))
