"""BENCHMARK.json against the benchmark's contract, and everything it
names found by name: an added configuration, traffic mix or metric needs
new files and entries only."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import registry
from conftest import ROOT, shrink

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "-m", "benchmark.run"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    everything = [x["name"] for x in
                  SPEC["configs"] + SPEC["workloads"] + metrics]
    assert all(NAME.match(n) for n in everything)
    assert len(set(everything)) == len(everything)


def test_every_cell_reports_what_it_must():
    bench = registry.Benchmark()
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer(w["name"])


def test_everything_named_is_found():
    bench = registry.Benchmark()
    for w in SPEC["workloads"]:
        cfg = bench.config(w["config"])
        assert cfg["name"] == w["config"]
        assert registry.system(cfg["system"]).Cell
        assert bench.traffic(w["traffic"])["lm_iterations"] >= 1
    for m in SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_configuration_states_its_source(name):
    cfg = registry.Benchmark().config(name)
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    assert cfg["source"] == entry["source"]
    assert "bal" in cfg["source"] and cfg["problem"].startswith("problem-")
    pub = cfg["published"]
    for k in ("cameras", "points", "observations"):
        assert cfg[k] == pub[k] or k in entry["reduced"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["assumed"]
    assert set(cfg["limits"]) <= {"cost_gap", "excess_cost", "pixel_gap",
                                  "pixel_gap_max"}


def test_added_files_are_found_by_name(tmp_path):
    root = shrink(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    d = root / "benchmark"
    cfg = json.loads((d / "configs" / "bal_venice1778.json").read_text())
    cfg["name"] = "bal_venice1778_b"
    (d / "configs" / "bal_venice1778_b.json").write_text(json.dumps(cfg))
    traffic = json.loads((d / "traffic" / "shared_calib.json").read_text())
    traffic["intrinsics_groups"] = "per_camera"
    (d / "traffic" / "per_camera_b.json").write_text(json.dumps(traffic))
    (d / "metrics" / "solves.py").write_text(
        "def read(ctx):\n    return float(ctx.iterations)\n")
    spec["configs"].append({"name": "bal_venice1778_b", "source": "x",
                            "file": "benchmark/configs/bal_venice1778_b.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "b.per_camera", "config": "bal_venice1778_b",
                              "traffic": "per_camera_b", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "solves", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "lm_iter_ms",
                              "workloads": ["b.per_camera"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = registry.Benchmark(root)
    assert bench.config("bal_venice1778_b")["name"] == "bal_venice1778_b"
    assert bench.traffic("per_camera_b")["intrinsics_groups"] == "per_camera"
    assert [m["name"] for m in bench.per_layer("b.per_camera")][-1] == "solves"

    class Ctx:
        iterations = 7
    assert bench.reader("solves")(Ctx()) == 7.0
