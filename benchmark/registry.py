"""Finds what BENCHMARK.json names, by name, in files of their own.

* a configuration: the `file` its entry in `configs` gives (JSON);
* a traffic mix: `benchmark/traffic/<traffic>.json`;
* a per-layer metric: `benchmark/metrics/<name>.py`, a reader with
  `read(ctx) -> float | None`;
* a configuration's system under test: `benchmark/systems/<system>.py`,
  the module named by the configuration's `system` key.

Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Benchmark:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / HERE.name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The `read` function of benchmark/metrics/<metric>.py."""
        spec = importlib.util.spec_from_file_location(
            f"benchmark.metrics.{metric}",
            self.dir / "metrics" / f"{metric}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def system(name: str):
    """The module benchmark/systems/<name>.py."""
    return importlib.import_module(f"benchmark.systems.{name}")
