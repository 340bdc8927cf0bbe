"""Finds everything of a cell by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits, the client its mix names
and the reader of each of its metrics. Nothing here knows a cell, a mix or
a metric: a later cell is added by files and entries alone, its mix naming
an existing client or a new one in ``benchmark/clients/``."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys


class Spec:
    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def client(self, name: str):
        return _load(self.dir / "clients" / f"{name}.py", f"_bench_client_{name}")

    def reader(self, metric: str):
        """The ``read(ctx)`` of a metric: its own file, named as the metric."""
        mod = _load(self.dir / "metrics" / f"{metric}.py", "_bench_metric_" + metric.replace(".", "_"))
        return mod.read

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """Every per-layer entry lists the cells it is read in."""
        return [m for m in self.bench["per_layer"] if cell in m["workloads"]]


def _load(path: pathlib.Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod
