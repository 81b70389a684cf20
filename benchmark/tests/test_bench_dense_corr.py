"""dense_corr_kernel_share: its reader on made-up counters, and its entry
in BENCHMARK.json (the exact cell only, the correction build's layer)."""
from __future__ import annotations

import json

from benchmark import registry

BENCH = registry.Benchmark()
NAME = "dense_corr_kernel_share"


class _Ctx:
    def __init__(self, counts):
        self.trace, self.counts, self.iterations = None, counts, 1
        self.shapes, self.peaks, self.peak_bytes = {}, {}, 0


def test_dense_corr_kernel_share():
    read = BENCH.reader(NAME)
    assert read(_Ctx({"dense.corr": 25, "dense_corr_kernel": 25})) == 1.0
    assert read(_Ctx({"dense.corr": 25, "dense_corr_kernel": 5})) == 0.2
    # a program without the kernel, or nothing built: nothing to read
    assert read(_Ctx({"dense.corr": 25, "dense.factor": 25})) is None
    assert read(_Ctx({"dense_corr_kernel": 3})) is None
    assert read(_Ctx({})) is None


def test_entry_lists_the_exact_cell():
    spec = json.loads((BENCH.root / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert m["workloads"] == ["bal_dubrovnik356_exact.per_camera_calib"]
    assert m["layer"] == {x["name"]: x for x in spec["per_layer"]}[
        "dense_corr_dev_ms"]["layer"]
    assert (m["moves"], m["better"], m["source"]) == (
        "lm_iter_ms", "higher", "program_counter")
