"""The exact-solver cell (systems/bundle_adjust_exact.py) on the CPU at a
small size, and its readers: the byte and operation counts at BAL
Dubrovnik-356's shapes, the shares on a made-up trace, and None where a
reader has nothing to read."""
from __future__ import annotations

import json

import pytest

from benchmark import registry, run
from benchmark.systems import bundle_adjust_exact as sysx
from benchmark.trace import Trace
from conftest import TINY, shrink

WORKLOAD = "bal_dubrovnik356_exact.per_camera_calib"
SEED = 2**33 + 18
READERS = ("dense_corr_dev_ms", "factor_dev_ms", "dense_corr_roofline",
           "factor_roofline", "factor_failed_share")
BENCH = registry.Benchmark()
PEAKS = json.loads((BENCH.dir / "peaks.json").read_text())
# Dubrovnik-356 as the cell prepares it: 1,255,268 observations padded to
# a multiple of 512, a group a camera, focal, k1 and k2 optimised, and
# the ordered pairs of observations of one point the card counted
DUBROVNIK = {"M": 1_255_424, "Nc": 356, "Ng": 356, "Np": 226_730, "P": 3,
             "pairs": 7_749_474}


@pytest.fixture
def tiny(tmp_path):
    counts = dict(TINY, bal_dubrovnik356_exact=(30, 3000, 16600))
    return registry.Benchmark(shrink(tmp_path, counts))


def test_the_cell_runs_and_checks_its_path(tiny):
    """Set-up, a window, the path check and the judge: correct, with one
    factorization an LM step and no Schur product."""
    res = run.run_cell(WORKLOAD, SEED, 0.1, False, device="cpu", bench=tiny)
    assert res["correct"], res["compared"]
    assert res["compared"]["kernel_path"]["value"] == 1
    assert set(res["metrics"]) == {"lm_iter_ms", "setup_s"}


def test_the_cell_counts_what_its_readers_need(tiny):
    cfg = tiny.config("bal_dubrovnik356_exact")
    cell = sysx.Cell(cfg, tiny.traffic("per_camera_calib"), SEED, "cpu")
    win = cell.window(0.1)
    ok, msg = cell.path_check(win)
    assert ok, msg
    s = cell.shapes()
    assert (s["Nc"], s["Ng"], s["P"]) == (30, 30, 3)
    assert s["M"] % 512 == 0 and s["pairs"] > s["M"] // 2
    c = win.counts
    assert c["dense.corr"] == c["dense.factor"] == win.iterations
    assert c["dense.pairs"] == s["pairs"] * len(win.answers)
    # a window whose factorizations do not match its LM steps fails
    c = dict(c, **{"dense.factor": win.iterations - 1})
    assert not cell.path_check(type(win)(win.wall_s, win.answers, c))[0]


def test_unchanged_fault_is_not_correct(tiny):
    res = run.run_cell(WORKLOAD, SEED, 0.1, False, device="cpu",
                       solve=sysx.FAULTS["unchanged"], bench=tiny)
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
    over = [k for k, v in res["compared"].items()
            if k != "kernel_path" and v["value"] > v["limit"]]
    assert over, res["compared"]


def _module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, BENCH.dir / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dense_corr_counts_at_dubrovnik():
    """378 operations a pair at P = 3 (2.93 GFLOP over the 7.75M pairs),
    342 an observation; about 0.18 GB: the jacobians and ids 108 B an
    observation, Hpp^-1 36 B a point, the four tables 41 MB. Bytes bound
    it, at some 0.055 ms."""
    nbytes, ops = _module("dense_corr_roofline").bytes_ops(**DUBROVNIK)
    M, Nc, pairs = DUBROVNIK["M"], DUBROVNIK["Nc"], DUBROVNIK["pairs"]
    assert ops == pairs * 378 + M * 342
    assert pairs * 378 == pytest.approx(2.93e9, rel=1e-3)
    tables = 4 * Nc * Nc * (36 + 18 + 18 + 9)
    assert tables == pytest.approx(41.06e6, rel=1e-3)
    assert nbytes == M * 108 + DUBROVNIK["Np"] * 36 + tables
    least = max(nbytes / PEAKS["hbm_bytes_per_s"],
                ops / PEAKS["f32_ops_per_s"])
    assert least == nbytes / PEAKS["hbm_bytes_per_s"]
    assert least == pytest.approx(0.0552e-3, rel=1e-2)


def test_factor_counts_at_dubrovnik():
    """D = 6 * 356 + 3 * 356 = 3,204 unknowns: D^3/3 = 11.0 GFLOP and the
    solves' 2 D^2; the matrix, 41 MB, read and its factor written. The
    operations bound it, at some 0.164 ms."""
    nbytes, ops = _module("factor_roofline").bytes_ops(**DUBROVNIK)
    D = 3204
    assert nbytes == 2 * D * D * 4 and D * D * 4 == pytest.approx(41.06e6,
                                                                rel=1e-3)
    assert ops == pytest.approx(11.0e9, rel=2e-3)
    least = ops / PEAKS["f32_ops_per_s"]
    assert least > nbytes / PEAKS["hbm_bytes_per_s"]
    assert least == pytest.approx(0.164e-3, rel=1e-2)


class _Ctx:
    def __init__(self, trace=None, counts=None, iterations=0, shapes=None):
        self.trace, self.counts = trace, counts or {}
        self.iterations, self.shapes = iterations, shapes or {}
        self.peaks, self.peak_bytes = PEAKS, 0


def _trace():
    # two LM iterations: a build of 40 us and a factorization of 5 us each
    ranges, ops = [], []
    for t in (0, 100_000):
        ranges += [("ba.dense_corr", t, t + 1000),
                   ("ba.factor", t + 1000, t + 2000)]
        ops += [("corr", t + 10, t + 10_000, t + 50_000),
                ("potrf", t + 1010, t + 50_000, t + 55_000)]
    return Trace((0, 200_000), ranges, ops, [])


def test_readers_on_a_made_up_trace():
    counts = {"dense.corr": 2, "dense.factor": 2, "dense.factor_failed": 1,
              "lm.accepted": 1, "lm.rejected": 1}
    ctx = _Ctx(_trace(), counts, 2, DUBROVNIK)
    assert BENCH.reader("dense_corr_dev_ms")(ctx) == pytest.approx(0.040)
    assert BENCH.reader("factor_dev_ms")(ctx) == pytest.approx(0.005)
    assert BENCH.reader("factor_failed_share")(ctx) == 0.5
    for name, ns in (("dense_corr_roofline", 40_000),
                     ("factor_roofline", 5_000)):
        nbytes, ops = _module(name).bytes_ops(**DUBROVNIK)
        least = max(nbytes / PEAKS["hbm_bytes_per_s"],
                    ops / PEAKS["f32_ops_per_s"])
        assert BENCH.reader(name)(ctx) == pytest.approx(100 * least / ns
                                                        * 1e9)
    counts.pop("dense.factor_failed")
    assert BENCH.reader("factor_failed_share")(ctx) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_on_an_empty_context(name):
    """No trace, no counts, no shapes (a run of a port without the dense
    solver's ranges and counters): None, never 0."""
    assert BENCH.reader(name)(_Ctx()) is None
    # a trace without the ranges, with the counters
    ctx = _Ctx(Trace((0, 10), [], [], []),
               {"dense.corr": 1, "dense.factor": 1}, 1, DUBROVNIK)
    if name == "factor_failed_share":
        assert BENCH.reader(name)(ctx) == 0.0
    else:
        assert BENCH.reader(name)(ctx) is None
