"""Reads torch.profiler's raw events into what the per-layer metrics need.

Frozen from chip_smoke.py's `_profile`, which read the raw kineto events
(building torch's event tree costs about 1 ms an event) and gave a
range the device time of the kernels launched by torch operators that
started inside it. Kernels launched through ctypes (the port's CUDA
kernels) have no torch operator, so that reader left them out of every
range. Here every device operation is placed at the host time of the
CUDA runtime call that launched it (the runtime event with its
correlation id), and a range counts the device time of every operation
launched inside it, whoever launched it. Where no runtime event is
found, the operator's start stands in, as before.

A range's host time excludes the CUDA runtime calls inside it: those
that wait for the device (synchronisations, device-to-host copies) and
the launches, which block once the device is far enough behind. What is
left is the host's own work: Python and the operators' dispatch.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time

import numpy as np

WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window_ns: tuple               # (start, end) of the traced window
    ranges: list                   # (name, start_ns, end_ns), host
    ops: list                      # (name, launch_ns, start_ns, end_ns)
    waits: list                    # (start_ns, end_ns) of runtime calls
    read_s: float = 0.0            # seconds the events took to read
    unplaced: int = 0              # operations placed by their operator

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        a, b = self.window_ns
        spans = sorted((max(s, a), min(e, b)) for _, _, s, e in self.ops
                       if e > a and s < b)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1][1] = e
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def _by_launch(self):
        order = sorted(self.ops, key=lambda o: o[1])
        launch = [o[1] for o in order]
        cum = np.concatenate([[0], np.cumsum([o[3] - o[2] for o in order])])
        return launch, cum

    def range_device_ns(self, prefix: str) -> dict:
        """{range name: device ns of the operations launched inside it}
        for the ranges whose names start with `prefix`."""
        launch, cum = self._by_launch()
        out = collections.Counter()
        for name, a, b in self.ranges:
            if name.startswith(prefix):
                out[name] += int(cum[bisect.bisect_right(launch, b)] -
                                 cum[bisect.bisect_left(launch, a)])
        return dict(out)

    def range_host_ns(self, prefix: str) -> int:
        """Host ns inside the ranges named `prefix*`, less the CUDA runtime
        calls inside them (ranges of one prefix do not nest)."""
        waits = sorted(self.waits)
        starts = [w[0] for w in waits]
        total = 0
        for name, a, b in self.ranges:
            if not name.startswith(prefix):
                continue
            total += b - a
            i = bisect.bisect_left(starts, a)
            while i < len(waits) and waits[i][0] < b:
                total -= min(waits[i][1], b) - waits[i][0]
                i += 1
        return total

    def kernel_ns(self, names) -> tuple:
        """(device ns, operations) of the device operations whose names
        contain any of `names`."""
        ns = n = 0
        for op, _, s, e in self.ops:
            if any(k in op for k in names):
                ns += e - s
                n += 1
        return ns, n

    def top_ops(self, n=10):
        tot = collections.Counter()
        for op, _, s, e in self.ops:
            tot[op[:160]] += e - s
        return [[k, v / 1e9] for k, v in tot.most_common(n)]

    def idle_by_range(self, prefix: str, n=10):
        """Device idle seconds inside the window, summed by the range
        (named `prefix*`) open on the host at each gap's midpoint."""
        busy = self.busy_intervals()
        a, b = self.window_ns
        edges = [a] + [x for iv in busy for x in iv] + [b]
        rs = sorted((s, e, name) for name, s, e in self.ranges
                    if name.startswith(prefix))
        rstart = [r[0] for r in rs]
        tot = collections.Counter()
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(rstart, mid) - 1
            name = (rs[i][2] if i >= 0 and rs[i][1] >= mid
                    else f"outside {prefix}* ranges")
            tot[name] += g1 - g0
        return [[k, v / 1e9] for k, v in tot.most_common(n)]


@contextlib.contextmanager
def profiled(prefix: str):
    """Profile CPU and CUDA activity around the block, which runs inside a
    range named bench.window; yields a list that holds the Trace once
    the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    out = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
            torch.cuda.synchronize()
    out.append(read(prof, prefix))


def read(prof, prefix: str) -> Trace:
    from torch.autograd import DeviceType
    t0 = time.perf_counter()
    ranges, waits, dev = [], [], []
    op_start, launch_at = {}, {}
    window = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith("cu"):
                launch_at[ev.correlation_id()] = ev.start_ns()
                waits.append((ev.start_ns(), ev.end_ns()))
            elif name == WINDOW:
                window = (ev.start_ns(), ev.end_ns())
            else:
                if name.startswith(prefix):
                    ranges.append((name, ev.start_ns(), ev.end_ns()))
                if ev.linked_correlation_id() == 0:
                    op_start[ev.correlation_id()] = ev.start_ns()
        elif ev.device_type() == DeviceType.CUDA and \
                not ev.is_user_annotation():
            dev.append((name, ev.correlation_id(),
                        ev.linked_correlation_id(), ev.start_ns(),
                        ev.end_ns()))
    ops, unplaced = [], 0
    for name, corr, linked, s, e in dev:
        at = launch_at.get(corr)
        if at is None:
            unplaced += 1
            at = op_start.get(linked, s)
        ops.append((name, at, s, e))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    return Trace(window, ranges, ops, waits, time.perf_counter() - t0,
                 unplaced)
