"""CPU tests of the benchmark's harness: lookups by name, the result line,
the frozen generators, the count functions and the import rules."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.frozen import profiler, synthetic
from benchmark.harness.spec import Spec
from benchmark.tests.small import REPO, last_line, small_root

SEED = 3_000_000_019  # above 2**31: seeds are any whole number to a little over it
CELLS = ["icp_odometry_c3.stream", "ransac3d3d_c1.bulk"]


# Runs the harness on the CPU (no look for a card) in a fresh process: the
# repository's test settings load JAX into the test process, which the
# harness refuses.
_RUN = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from benchmark import run
sys.exit(run.main(sys.argv[3:], root=sys.argv[2], device="cpu"))
"""


def _run(root, cell, trace, seconds=1.0, seed=SEED, stderr=None):
    proc = subprocess.run([sys.executable, "-c", _RUN, str(REPO), str(root), "--workload", cell,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                          capture_output=True, text=True, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    if stderr is not None:
        stderr.append(proc.stderr)
    return proc.returncode, last_line(proc.stdout)


def test_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    """A configuration, a mix, limits, a metric and a cell added as files and
    entries alone are run, with no edit to a file the benchmark has."""
    root = small_root(tmp_path)
    b = root / "benchmark"
    cfg = json.loads((b / "configs/ransac3d3d_c1.json").read_text())
    cfg["name"] = "dummy_cfg"
    cfg["ransac"]["threshold"] = 0.04
    (b / "configs/dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic/bulk.json").read_text())
    mix["hypotheses"] = 256
    (b / "traffic/dummy_mix.json").write_text(json.dumps(mix))
    (b / "limits/dummy_cfg.dummy_mix.json").write_text(
        (b / "limits/ransac3d3d_c1.bulk.json").read_text())
    (b / "metrics/dummy.requests.py").write_text(
        "def read(ctx):\n    return float(len(ctx['records']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "test", "file": "benchmark/configs/dummy_cfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg", "traffic": "dummy_mix",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "dummy.requests", "unit": "requests", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["dummy_cfg.dummy_mix"]})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index("pair_estimates_per_s")][
        "workloads"].append("dummy_cfg.dummy_mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = _run(root, "dummy_cfg.dummy_mix", 0)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "pair_estimates_per_s", "dummy.requests"}
    assert line["metrics"]["dummy.requests"]["value"] == line["attempted"]
    assert Spec(root).config("dummy_cfg")["ransac"]["threshold"] == 0.04


# A client of its own for a second mix under config 1: the bulk client's
# loop over the pool, from its last problem down.
_REVERSED_CLIENT = """
import importlib.util, pathlib, sys

_spec = importlib.util.spec_from_file_location("_bulk_client", pathlib.Path(__file__).with_name("ransac_3d3d.py"))
_bulk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_bulk)


class Client(_bulk.Client):
    def setup(self):
        super().setup()
        self.p, self.q = self.p.flip(0), self.q.flip(0)
        print("reversed pool", file=sys.stderr)
"""


def test_mix_with_a_client_of_its_own_under_an_existing_configuration(tmp_path):
    """A second mix under an existing configuration names a new client; the
    mix, the client, the limits and the cell are added as files and entries
    alone, and no file the benchmark has is edited."""
    root = small_root(tmp_path)
    b = root / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    (b / "clients/reversed_pool.py").write_text(_REVERSED_CLIENT)
    mix = json.loads((b / "traffic/bulk.json").read_text())
    mix["client"] = "reversed_pool"
    (b / "traffic/reversed.json").write_text(json.dumps(mix))
    (b / "limits/ransac3d3d_c1.reversed.json").write_text((b / "limits/ransac3d3d_c1.bulk.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ransac3d3d_c1.reversed", "config": "ransac3d3d_c1",
                               "traffic": "reversed", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ransac3d3d_c1.bulk" in m.get("workloads", []):
            m["workloads"].append("ransac3d3d_c1.reversed")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    err = []
    rc, line = _run(root, "ransac3d3d_c1.reversed", 0, stderr=err)
    assert rc == 0 and line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"setup_s", "pair_estimates_per_s"}
    assert "reversed pool" in err[0]
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(tmp_path, cell, trace):
    root = small_root(tmp_path)
    rc, line = _run(root, cell, trace, seconds=4.0)  # a p95 needs 20 requests in the window
    assert rc == 0
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert list(line) == keys + ["compared"]  # the compared numbers come last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    spec = Spec(root)
    expected = spec.per_layer(cell) if trace else spec.end_to_end(cell)
    # On the CPU no device metric is reported: nothing ran on a card.
    host_only = {m["name"] for m in expected if m["source"] == "host_clock"}
    assert set(line["metrics"]) == host_only
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for k, v in line["compared"].items():
        assert set(v) == {"value", "limit"}


def test_frozen_generators_are_deterministic_for_a_seed():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        p, q, T, inl = synthetic.synthetic_correspondences(g, 64, 0.4, 0.003, batch=(2,), device="cpu")
        poses = synthetic.handheld_trajectory(g, 5, device="cpu")
        depth = synthetic.kinect_degrade(g, synthetic.render_depth((64.7, 64.6, 39.8, 31.9, 80, 60), poses))
        return [p, q, T, inl, poses, depth]

    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[5], c[5])
    assert (a[5] > 0).float().mean() > 0.3  # the scene fills the frame but its 8-pixel border


def _module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  REPO / "benchmark/metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_count_functions_match_hand_counts():
    icp = _module("icp_fused_step_roofline")
    # 300 samples: 300 x (3 + 3 floats) read, 300 association ints, 250 valid
    # samples x (3 + 3 floats) gathered, 12 floats of T, 64 floats written.
    assert icp.bytes_per_call(300, 250) == 300 * 24 + 300 * 4 + 250 * 24 + 12 * 4 + 64 * 4
    k1 = _module("k1_moments_roofline")
    # K = 4 sets of m = 3 indices (12 ints), 16 x 4 moments, 8 rows of p and q.
    assert k1.bytes_per_call(4, 3, 8) == 12 * 4 + 64 * 4 + 8 * 6 * 4
    assert k1.ops_per_call(4, 3) == 4 * 3 * (3 + 3 + 9 + 9)
    k2 = _module("k2_fast_rank_roofline")
    peaks = {"bf16_flops_per_s": 1.0, "f32_flops_per_s": 1.0}
    assert k2.seconds_of_ops(2, 3, peaks) == 2 * 17 * 6 + 3 * 6
    assert k2.bytes_per_call(2, 3) == 4 * (34 + 51 + 2)


def test_profiler_reduction_by_hand():
    device = [("kern_a(int)", 0, 10_000), ("Memcpy HtoD", 5_000, 20_000), ("kern_b", 50_000, 60_000),
              ("kern_a(int)", 100_000, 101_000)]
    host = [("aten::outer", 15_000, 90_000), ("aten::inner", 20_000, 40_000), ("aten::x", 95_000, 99_000)]
    s = profiler.reduce(device, host, 1e-4)
    assert s["busy_s"] == pytest.approx((20_000 + 10_000 + 1_000) / 1e9)
    assert s["kernel_launches"] == 3
    # Gaps: 20-50 us opens inside aten::inner, 60-100 us inside aten::outer.
    assert dict((n, v) for n, v in s["idle_gaps"]) == pytest.approx(
        {"aten::inner": 30e-6, "aten::outer": 40e-6})
    assert profiler.kernel_time(s, "kern_a") == (2, pytest.approx(11e-6))
    assert profiler.kernel_time(s, "kern") == (0, 0.0)  # whole words only


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "rgbd_pose_estimation_tpu_torch_x", None)
    assert "rgbd_pose_estimation_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rgbd_pose_estimation_tpu.core", None)
    assert "rgbd_pose_estimation_tpu" in run.forbidden_modules()


# Loads every module of the given groups; with a small root, also runs each
# cell once (trace 1) in the same process. Prints the top-level names loaded.
_IMPORT_CHECK = """
import importlib.util, io, json, pathlib, sys
repo, small = pathlib.Path(sys.argv[1]), sys.argv[2]
sys.path.insert(0, str(repo))
import torch
torch.set_num_threads(2)
from benchmark import run
for group in sys.argv[3:]:
    for f in sorted((repo / "benchmark" / group).glob("*.py")):
        spec = importlib.util.spec_from_file_location("x_" + f.stem.replace(".", "_"), f)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
if small != "-":
    for cell in ("icp_odometry_c3.stream", "ransac3d3d_c1.bulk"):
        rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "0.5", "--trace", "1"],
                      root=small, device="cpu", out=io.StringIO())
        assert rc == 0, rc
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(small, *groups):
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK, str(REPO), str(small), *groups],
                         capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package(tmp_path):
    loaded = _loaded(small_root(tmp_path), "harness", "clients", "metrics", "reference", "frozen", "tools")
    assert not loaded & {"jax", "jaxlib", "flax", "rgbd_pose_estimation_tpu"}
    assert "rgbd_pose_estimation_tpu_torch" in loaded  # the clients did run the port


def test_reference_imports_nothing_of_the_port():
    loaded = _loaded("-", "reference", "frozen")
    assert not loaded & {"jax", "jaxlib", "flax", "rgbd_pose_estimation_tpu", "rgbd_pose_estimation_tpu_torch"}
    for f in (REPO / "benchmark/reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "collections", "__future__", "benchmark"}, (f, n)
                assert not n.startswith("benchmark.") or n.startswith("benchmark.reference"), (f, n)


def test_no_card_exits_nonzero_and_prints_nothing():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[1], "--seed", str(SEED),
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=REPO)
    assert proc.returncode != 0 and proc.stdout == ""


def test_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    root = small_root(tmp_path)  # BENCHMARK.json and benchmark/, no port
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from benchmark import run; "
            "sys.exit(run.main(sys.argv[2:], root=sys.argv[1], device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code, str(root), "--workload", CELLS[1], "--seed", "1",
                           "--seconds", "1"], capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "rgbd_pose_estimation_tpu_torch" in proc.stderr
