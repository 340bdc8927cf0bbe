"""Readings that the limits of a cell's comparison are set from.

    python benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 13

For each seed of ``--seeds``: the cell's set-up, a window of ``--seconds``
on the timed path at the cell's own sizes and load, and the compared
numbers of what it produced (the lower readings). For each seed of
``--control-seeds``: the same data, and the reference computed in TF32 put
in the program's place (the upper readings). One JSON line a reading on
standard output; where the client keeps its per-request gaps (``gaps``),
the line adds their 90th and 99th percentiles, their largest and how many
exceed 1e-3, for numbers not compared yet. Needs the card, as ``run.py``
does.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness.spec import Spec  # noqa: E402


def readings(spec, cell, seeds, seconds, control, device):
    w = spec.cell(cell)
    config, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    Client = spec.client(mix["client"]).Client
    for seed in seeds:
        drv = Client(config, mix, seed, device)
        drv.setup()
        drv.warmup()
        # The window decides which requests are judged; the control answers
        # the same ones in the program's place.
        records = drv.serve(time.perf_counter() + seconds)
        drv.release()
        t = time.perf_counter()
        compared = drv.check(records, control=control)
        gaps = getattr(drv, "gaps", None)
        if gaps:
            p90, p99 = np.percentile(gaps, [90, 99])
            compared.update(gaps_n=len(gaps), gap_p90=float(p90), gap_p99=float(p99), gap_max=max(gaps),
                            gaps_over_1e3=sum(g > 1e-3 for g in gaps))
        yield {"cell": cell, "seed": seed, "kind": "control" if control else "program",
               "requests": len(records), "check_s": time.perf_counter() - t, **compared}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = Spec(ROOT)
    for seeds, control in ((args.seeds, False), (args.control_seeds, True)):
        seeds = [int(s) for s in seeds.split(",") if s]
        for rec in readings(spec, args.workload, seeds, args.seconds, control, args.device):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
