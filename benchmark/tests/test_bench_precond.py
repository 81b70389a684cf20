"""The SCHUR_JACOBI preconditioner's metrics: precond_roofline's byte and
operation counts at the PCG cells' shapes and its reader on a made-up
trace, precond_kernel_share's reader on made-up counters, and both
entries in BENCHMARK.json (the two PCG cells only, the preconditioner's
layer)."""
from __future__ import annotations

import json

import pytest

from benchmark import registry
from benchmark.trace import Trace

BENCH = registry.Benchmark()
PEAKS = json.loads((BENCH.dir / "peaks.json").read_text())
SPEC = json.loads((BENCH.root / "BENCHMARK.json").read_text())
PCG_CELLS = ["bal_venice1778.shared_calib",
             "bal_final13682.per_camera_calib"]
# the cells' shapes as systems/bundle_adjust.Cell.shapes() gives them: the
# observations padded to a multiple of 512, P = 3, bf16 jacobians
FINAL = {"M": 28_987_904, "Nc": 13_682, "Np": 4_456_117, "P": 3,
         "matvec_bytes": 2}
VENICE = {"M": 5_002_240, "Nc": 1_778, "Np": 993_923, "P": 3,
          "matvec_bytes": 2}


def _module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, BENCH.dir / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape,gb,ms", [(FINAL, 1.79, 0.53),
                                         (VENICE, 0.32, 0.094)],
                         ids=["final", "venice"])
def test_precond_roofline_counts(shape, gb, ms):
    """Per observation 24 bf16 jacobian values (48 B) and two int32 ids
    (8 B); 36 B of Hpp^-1 a point; Hcc in and its inverse out, 288 B a
    camera. Operations: 459 an observation at P = 3, under half of the
    bytes' time."""
    mod = _module("precond_roofline")
    nbytes, ops = mod.bytes_ops(**shape)
    assert nbytes == (shape["M"] * (48 + 8) + 36 * shape["Np"] +
                      288 * shape["Nc"])
    assert round(nbytes / 1e9, 2) == gb
    assert nbytes / PEAKS["hbm_bytes_per_s"] * 1e3 == pytest.approx(ms,
                                                                   rel=0.01)
    # V (9 x 3 entries of 2 products), T (27 of 3), the 21 + 6 upper
    # values (3 products each), an FMA two operations; 27 adds
    assert ops == shape["M"] * (2 * (54 + 81 + 63 + 18) + 27) == \
        shape["M"] * 459
    assert ops / PEAKS["f32_ops_per_s"] < \
        0.5 * nbytes / PEAKS["hbm_bytes_per_s"]
    # a group count, if a cell's shapes gave one, is not read
    assert mod.bytes_ops(**shape, Ng=13_682) == (nbytes, ops)


class _Ctx:
    def __init__(self, trace, counts, shapes=VENICE):
        self.trace, self.counts, self.iterations = trace, counts, 2
        self.shapes, self.peaks, self.peak_bytes = shapes, PEAKS, 0


def test_precond_roofline_reader():
    """Two builds, each range holding 1 ms of device work launched inside
    it (a kernel outside any range is not counted)."""
    mod = _module("precond_roofline")
    nbytes, ops = mod.bytes_ops(**VENICE)
    least = max(nbytes / PEAKS["hbm_bytes_per_s"],
                ops / PEAKS["f32_ops_per_s"])
    ranges = [("ba.precond", 0, 100), ("ba.cg", 100, 200),
              ("ba.precond", 1_000, 1_100)]
    ops_ = [("k", 10, 300, 700_300), ("k", 20, 800_000, 1_100_000),
            ("cg", 150, 1_200_000, 9_000_000),
            ("k", 1_050, 9_000_000, 10_000_000)]
    trace = Trace((0, 10_000_000), ranges, ops_, [])
    got = mod.read(_Ctx(trace, {"precond.build": 2}))
    assert got == pytest.approx(100 * least * 2 / 2e-3)
    # no build counted (the parent, a plain-only program, or a cell
    # without the preconditioner), no trace or no range: nothing to read
    assert mod.read(_Ctx(trace, {})) is None
    assert mod.read(_Ctx(None, {"precond.build": 2})) is None
    assert mod.read(_Ctx(Trace((0, 10), [], [], []),
                         {"precond.build": 2})) is None


def test_precond_kernel_share():
    read = _module("precond_kernel_share").read
    assert read(_Ctx(None, {"precond.build": 25,
                            "precond_kernel": 25})) == 1.0
    assert read(_Ctx(None, {"precond.build": 25,
                            "precond_kernel": 5})) == 0.2
    # no launches (a program without the kernel, the plain route) or no
    # builds: nothing to read
    assert read(_Ctx(None, {"precond.build": 25})) is None
    assert read(_Ctx(None, {"precond_kernel": 3})) is None
    assert read(_Ctx(None, {})) is None


@pytest.mark.parametrize("name,unit,source", [
    ("precond_kernel_share", "share", "program_counter"),
    ("precond_roofline", "%", "device_trace")])
def test_entries_list_the_pcg_cells(name, unit, source):
    m = {m["name"]: m for m in SPEC["per_layer"]}
    assert m[name]["workloads"] == PCG_CELLS
    assert m[name]["layer"] == m["precond_dev_ms"]["layer"]
    assert (m[name]["unit"], m[name]["source"], m[name]["better"],
            m[name]["moves"]) == (unit, source, "higher", "lm_iter_ms")
    assert BENCH.reader(name) is not None
