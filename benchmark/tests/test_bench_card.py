"""The comparison at each cell's own size, on the card: a short window of
the program passes the cell's limits, and the TF32 control of the same
requests fails them. Skips without a card (decided inside the test).

    python -m pytest benchmark/tests/test_bench_card.py -q --confcutdir=benchmark
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness.spec import Spec
from benchmark.tests.small import REPO


@pytest.mark.parametrize("cell,seconds", [("icp_odometry_c3.stream", 13.0), ("ransac3d3d_c1.bulk", 6.0)])
def test_program_passes_and_control_fails_at_cell_size(cell, seconds):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own sizes on the card")
    spec = Spec(REPO)
    w = spec.cell(cell)
    config, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    limits = spec.limits(cell)
    drv = spec.client(mix["client"]).Client(config, mix, 3_000_000_999, "cuda")
    drv.setup()
    drv.warmup()
    records = drv.serve(time.perf_counter() + seconds)
    drv.release()
    program, control = drv.check(records), drv.check(records, control=True)
    assert all(program[k] <= limits[k] for k in limits), (program, limits)
    assert any(control[k] > limits[k] for k in limits), (control, limits)
