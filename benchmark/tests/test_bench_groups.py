"""The grouped Schur kernels' metrics: their byte and operation counts
against hand counts, their readers on a made-up trace, and their kernel
names apart from the one-group kernels' (the trace matches names by
substring)."""
from __future__ import annotations

import json

import pytest

from benchmark import registry
from benchmark.trace import Trace

BENCH = registry.Benchmark()
PEAKS = json.loads((BENCH.dir / "peaks.json").read_text())
# a tiny shape: 4 observations, 3 cameras, 3 groups, 2 points, 3
# intrinsics
SHAPE = {"M": 4, "Nc": 3, "Np": 2, "P": 3, "matvec_bytes": 2, "Ng": 3}
ROOFLINES = ("schur_groups_pass1_roofline", "schur_groups_pass2_roofline")


def _module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, BENCH.dir / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_schur_groups_pass1_counts():
    nbytes, ops = _module("schur_groups_pass1_roofline").bytes_ops(**SHAPE)
    # per observation: jacobians 48 B, camera and point ids 8 B, group id
    # 4 B, u out 8 B; vc in 3 x 24; vg in 3 groups x 3 x 4; wp out 2 x 12
    assert nbytes == 4 * (48 + 8 + 4 + 8) + 72 + 36 + 24
    # u: 2 rows of 6 + 3 FMAs (36 operations); Jp^T u: 6 FMAs (12); 3 adds
    assert ops == 4 * (36 + 12 + 3)


def test_schur_groups_pass2_counts():
    nbytes, ops = _module("schur_groups_pass2_roofline").bytes_ops(**SHAPE)
    # per observation: jacobians 48 B, point id and camera order 8 B,
    # group order 4 B, u 8 B; zp 2 x 12; yc out 3 x 24; yg out 3 x 3 x 4
    assert nbytes == 4 * (48 + 8 + 4 + 8) + 24 + 72 + 36
    # Jp z: 12; 2 subtractions; Jc^T d: 24 and 6 adds; Ji^T d: 3 outputs
    # of 2 FMAs (12) and 3 adds
    assert ops == 4 * (12 + 2 + 24 + 6 + 12 + 3)


@pytest.mark.parametrize("metric", ROOFLINES)
def test_groups_counts_leave_the_table_out_without_a_group_count(metric):
    """Shapes without Ng: the (Ng, P) table is not counted, so the share
    stays a lower bound on the time whatever the grouping."""
    bytes_ops = _module(metric).bytes_ops
    shape = {k: v for k, v in SHAPE.items() if k != "Ng"}
    nbytes, ops = bytes_ops(**shape)
    assert (nbytes, ops) == (bytes_ops(**SHAPE)[0] - 3 * 3 * 4,
                             bytes_ops(**SHAPE)[1])
    # the group count is read, not taken from the cameras
    assert bytes_ops(**{**SHAPE, "Ng": 7})[0] == nbytes + 7 * 3 * 4


class _Ctx:
    def __init__(self, trace, counts, iterations=1, shapes=SHAPE):
        self.trace, self.counts, self.iterations = trace, counts, iterations
        self.shapes, self.peaks, self.peak_bytes = shapes, PEAKS, 0


def _trace(ops):
    return Trace((0, 100_000), [], list(ops), [])


@pytest.mark.parametrize("metric,kernels", [
    ("schur_groups_pass1_roofline", ["schur_groups_pass1_kernel"]),
    ("schur_groups_pass2_roofline", ["schur_groups_pass2_obs_kernel",
                                     "schur_groups_segsum_kernel",
                                     "schur_groups_segsum_kernel"])])
def test_groups_roofline_reader(metric, kernels):
    mod = _module(metric)
    nbytes, ops = mod.bytes_ops(**SHAPE)
    least = max(nbytes / PEAKS["hbm_bytes_per_s"],
                ops / PEAKS["f32_ops_per_s"])
    # two launches, each kernel of a launch 1 us; the one-group kernels
    # beside them are not counted
    names = [f"void (anonymous namespace)::{k}<3>(...)" for k in kernels]
    others = ["void (anonymous namespace)::schur_pass1_kernel<float, 1>()",
              "void (anonymous namespace)::schur_pass2_obs_kernel<float>()",
              "void (anonymous namespace)::schur_pass2_cam_kernel()"]
    trace = _trace([(n, 0, t + 1000 * i, t + 1000 * i + 1000)
                    for t in (0, 50_000)
                    for i, n in enumerate(names + others)])
    got = mod.read(_Ctx(trace, {mod.COUNTER: 2, "schur_pass1": 2}))
    assert got == pytest.approx(100 * least * 2 / (2e-6 * len(kernels)))
    # nothing launched: nothing to read (never a 0)
    assert mod.read(_Ctx(trace, {})) is None
    assert mod.read(_Ctx(_trace([]), {mod.COUNTER: 2})) is None
    assert mod.read(_Ctx(None, {mod.COUNTER: 2})) is None


def test_kernel_names_do_not_match_each_other():
    """No reader's kernel pattern is part of another family's kernel
    names, so the one-group rooflines never count the grouped kernels and
    the grouped ones never count the one-group kernels."""
    grouped = [k for m in ROOFLINES for k in _module(m).KERNELS]
    shared = [k for m in ("schur_pass1_roofline", "schur_pass2_roofline",
                          "ba_blocks_roofline") for k in _module(m).KERNELS]
    for a in grouped:
        for b in shared:
            assert a not in b and b not in a, (a, b)


def test_schur_groups_share():
    read = _module("schur_groups_share").read
    assert read(_Ctx(None, {"schur_matvec": 50,
                            "schur_pass1_groups": 50})) == 1.0
    assert read(_Ctx(None, {"schur_matvec": 50,
                            "schur_pass1_groups": 10})) == 0.2
    # a program without the grouped kernels, or nothing run: nothing
    assert read(_Ctx(None, {"schur_matvec": 50, "schur_pass1": 50})) is None
    assert read(_Ctx(None, {})) is None


def test_entries_list_the_final_cell():
    spec = json.loads((BENCH.root / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in spec["per_layer"]}
    for name in ("schur_groups_share",) + ROOFLINES:
        m = got[name]
        assert m["workloads"] == ["bal_final13682.per_camera_calib"]
        assert m["layer"] == "CG and its Schur products: range ba.cg"
        assert m["moves"] == "lm_iter_ms" and m["better"] == "higher"
