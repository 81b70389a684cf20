"""sync_idle_share: the share of the traced window taken by device-idle
gaps that a host wait drained: each opens while the host is inside one
of the port's "ba.sync" ranges (utils/dispatch host_sync, around each
host read of a device value) and lasts past that range's end, so the
card had nothing queued when the host came back from the read. A gap
that opens and closes inside the range is the device's own pause
between operations it already held, and does not count.
device_idle_share less this share is the idle time of a host that fell
behind while it enqueued work.

Source: the device trace, the gaps between the operations' union inside
the window, each placed by its start and end against the program's
ranges."""
import bisect

RANGE = "ba.sync"


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    syncs = sorted((a, b) for name, a, b in tr.ranges if name == RANGE)
    if not syncs:
        return None
    starts = [a for a, _ in syncs]
    w0, w1 = tr.window_ns
    edges = [w0] + [x for iv in tr.busy_intervals() for x in iv] + [w1]
    idle = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        i = bisect.bisect_right(starts, g0) - 1
        if i >= 0 and syncs[i][1] > g0 and g1 >= syncs[i][1]:
            idle += g1 - g0
    return idle / 1e9 / tr.window_s
