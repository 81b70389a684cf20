"""device_idle_share: the share of the traced window in which no operation
ran on the device (1 - busy / window).

Source: the device trace (the union of the operations' intervals inside
the window's range)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s() / ctx.trace.window_s
