"""The host-sync readers on made-up traces and counts: sync_idle_share
counts the idle gaps that open inside a ba.sync range and last past its
end, and no other;
host_syncs_per_iter and lm_rejected_share read the program's counters;
each reads None where it has nothing to read (the parent of the counters
and ranges, a run without a trace)."""
from __future__ import annotations

import pytest

from benchmark import registry
from benchmark.trace import Trace

BENCH = registry.Benchmark()


class _Ctx:
    def __init__(self, trace=None, counts=None, iterations=10):
        self.trace, self.counts = trace, counts or {}
        self.iterations = iterations
        self.shapes, self.peaks, self.peak_bytes = {}, {}, 0


def _trace(ranges):
    # busy 0-100, 300-400, 600-700, 900-1000: gaps open at 100, 400, 700
    ops = [("k", s, s, s + 100) for s in (0, 300, 600, 900)]
    return Trace((0, 1000), list(ranges), ops, [])


@pytest.mark.parametrize("ranges,want", [
    # the gap that opens at 400 inside ba.sync counts, its 200 ns whole
    ([("ba.cg", 350, 390), ("ba.sync", 390, 450), ("ba.cg", 450, 800)],
     200 / 1000),
    # gaps that open inside ba.cg (100, 700) do not; ba.sync holds none
    ([("ba.cg", 50, 150), ("ba.sync", 150, 160), ("ba.cg", 650, 750)],
     0.0),
    # a gap that opens outside every range (400) does not
    ([("ba.sync", 150, 160), ("ba.rhs", 450, 500)], 0.0),
    # a gap that opens and closes inside ba.sync (100-300: the device's
    # own pause while the host waits) does not; 400-600 does
    ([("ba.sync", 90, 350), ("ba.sync", 395, 420)], 200 / 1000),
    # every gap opens inside ba.sync and outlasts it: the whole idle share
    ([("ba.sync", 90, 110), ("ba.sync", 395, 420), ("ba.sync", 700, 710)],
     600 / 1000)])
def test_sync_idle_share(ranges, want):
    read = BENCH.reader("sync_idle_share")
    assert read(_Ctx(_trace(ranges))) == pytest.approx(want)
    idle = BENCH.reader("device_idle_share")(_Ctx(_trace(ranges)))
    assert read(_Ctx(_trace(ranges))) <= idle


def test_sync_idle_share_reads_nothing_without_sync_ranges():
    read = BENCH.reader("sync_idle_share")
    assert read(_Ctx(None)) is None
    assert read(_Ctx(_trace([("ba.cg", 50, 150)]))) is None


def test_host_syncs_per_iter():
    read = BENCH.reader("host_syncs_per_iter")
    counts = {"sync.cg_stop": 150, "sync.lm_step": 10, "sync.upload": 32,
              "schur_matvec": 150, "lm.accepted": 9, "lm.rejected": 1}
    assert read(_Ctx(counts=counts)) == pytest.approx(19.2)
    assert read(_Ctx(counts={"schur_matvec": 150})) is None
    assert read(_Ctx(counts=counts, iterations=0)) is None


def test_lm_rejected_share():
    read = BENCH.reader("lm_rejected_share")
    assert read(_Ctx(counts={"lm.accepted": 9, "lm.rejected": 1})) == \
        pytest.approx(0.1)
    assert read(_Ctx(counts={"lm.accepted": 5})) == 0.0
    assert read(_Ctx(counts={"schur_matvec": 150})) is None
