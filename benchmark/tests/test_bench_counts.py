"""The kernels' byte and operation counts against hand counts, and the
roofline readers on a made-up trace."""
from __future__ import annotations

import json

import pytest

from benchmark import registry
from benchmark.trace import Trace

BENCH = registry.Benchmark()
PEAKS = json.loads((BENCH.dir / "peaks.json").read_text())
# a tiny shape: 4 observations, 3 cameras, 2 points, 3 intrinsics
SHAPE = {"M": 4, "Nc": 3, "Np": 2, "P": 3, "matvec_bytes": 2}


def _module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, BENCH.dir / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_schur_pass1_counts():
    # jacobians (12 + 6 + 6) bf16 values an observation: 48 B each; obs_cam
    # and obs_pt 8 B; u out 8 B; vc in 3 x 24; vg in 3 x 4; wp out 2 x 12
    nbytes, ops = _module("schur_pass1_roofline").bytes_ops(**SHAPE)
    assert nbytes == 4 * 48 + 4 * 8 + 4 * 8 + 72 + 12 + 24
    # u = Jc vc + Ji vg: 2 rows of 6 + 3 FMAs (36 operations); Jp^T u:
    # 6 FMAs (12); 3 adds into wp
    assert ops == 4 * (36 + 12 + 3)


def test_schur_pass2_counts():
    nbytes, ops = _module("schur_pass2_roofline").bytes_ops(**SHAPE)
    # jacobians 48 B, ids 8 B, u 8 B an observation; zp 2 x 12; yc out
    # 3 x 24; yg out (2P x 2) x 4
    assert nbytes == 4 * (48 + 8 + 8) + 24 + 72 + 48
    # Jp z: 6 FMAs (12); 2 subtractions; Jc^T d: 12 FMAs (24) and 6 adds;
    # Ji^T d: 2 x 3 FMAs (12)
    assert ops == 4 * (12 + 2 + 24 + 6 + 24)


def test_ba_blocks_counts():
    nbytes, ops = _module("ba_blocks_roofline").bytes_ops(**SHAPE)
    # float32 jc 12, ji 6, jp 6, r 2 values and two ids an observation;
    # per point 12 and per camera 42 float32 out; X (6 x 6) and Y (6 x 2)
    assert nbytes == 4 * (26 * 4 + 8) + 2 * 48 + 3 * 168 + 4 * (36 + 12)
    # per observation 12 point and 42 camera values of 2 products and a
    # sum and an add (4 operations); X 2P x 2P and Y 2P x 2 FMAs
    assert ops == 4 * (12 * 4 + 42 * 4 + 8 * 9 + 8 * 3)


class _Ctx:
    def __init__(self, trace, counts, iterations=1, shapes=SHAPE):
        self.trace, self.counts, self.iterations = trace, counts, iterations
        self.shapes, self.peaks, self.peak_bytes = shapes, PEAKS, 0


def _trace(ops, ranges=(), window=(0, 10_000)):
    return Trace(window, list(ranges), list(ops), [])


@pytest.mark.parametrize("metric,kernels", [
    ("schur_pass1_roofline", ["schur_pass1_kernel"]),
    ("schur_pass2_roofline", ["schur_pass2_obs_kernel",
                              "schur_pass2_cam_kernel"]),
    ("ba_blocks_roofline", ["ba_blocks_sweep_kernel",
                            "ba_blocks_group_kernel"])])
def test_roofline_reader(metric, kernels):
    mod = _module(metric)
    nbytes, ops = mod.bytes_ops(**SHAPE)
    least = max(nbytes / PEAKS["hbm_bytes_per_s"],
                ops / PEAKS["f32_ops_per_s"])
    # two launches, each kernel of a launch 1 us
    trace = _trace([(f"void (anonymous namespace)::{k}<float>(...)", 0,
                     t, t + 1000) for t in (0, 5000) for k in kernels])
    got = mod.read(_Ctx(trace, {mod.COUNTER: 2}))
    assert got == pytest.approx(100 * least * 2 / (2e-6 * len(kernels)))
    # nothing launched: nothing to read (never a 0)
    assert mod.read(_Ctx(trace, {})) is None
    assert mod.read(_Ctx(_trace([]), {mod.COUNTER: 2})) is None
