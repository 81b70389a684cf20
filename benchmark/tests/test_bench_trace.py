"""The trace reader's arithmetic on made-up events: operations placed at
the runtime call that launched them, busy and idle time, host time."""
from __future__ import annotations

from benchmark.trace import Trace


def _trace():
    ranges = [("ba.cg", 100, 300), ("ba.inner", 400, 500)]
    # (name, launch, start, end): a kernel launched inside ba.cg runs
    # after it has closed, one launched in ba.inner, one outside both
    ops = [("k1", 150, 320, 420), ("k2", 450, 460, 480),
           ("k3", 600, 610, 700), ("k4", 200, 350, 380)]
    waits = [(250, 290), (480, 520)]
    return Trace((0, 1000), ranges, ops, waits)


def test_device_time_follows_the_launch():
    t = _trace()
    assert t.range_device_ns("ba.") == {"ba.cg": 100 + 30,
                                        "ba.inner": 20}


def test_busy_is_the_union():
    t = _trace()
    assert t.busy_intervals() == [[320, 420], [460, 480], [610, 700]]
    assert abs(t.busy_s() - 210e-9) < 1e-15


def test_host_time_leaves_out_runtime_calls():
    # ba.cg 200 less the 40 of its wait; ba.inner 100 less the 20 of the
    # wait that starts inside it
    assert _trace().range_host_ns("ba.") == 160 + 80


def test_idle_by_range_and_top_ops():
    t = _trace()
    idle = dict(t.idle_by_range("ba."))
    assert abs(sum(idle.values()) - (1000 - 210) * 1e-9) < 1e-15
    assert abs(idle["ba.cg"] - 320e-9) < 1e-15
    assert abs(idle["ba.inner"] - 40e-9) < 1e-15
    assert [name for name, _ in t.top_ops(2)] == ["k1", "k3"]
