"""lm_host_ms: host ms per LM iteration spent inside the port's `ba.*`
ranges of bundle_adjust, less the CUDA runtime calls in them (waits for
the device, and launches, which block once the device is far enough
behind): the host's own cost of enqueueing an iteration's
work, Python and the operators' dispatch.

Source: the spans of the program (torch.profiler ranges) and the CUDA
runtime calls in the trace, over the traced window's LM iterations."""
PREFIX = "ba."


def read(ctx):
    if ctx.trace is None or not ctx.iterations:
        return None
    if not any(r[0].startswith(PREFIX) for r in ctx.trace.ranges):
        return None
    return ctx.trace.range_host_ns(PREFIX) / 1e6 / ctx.iterations
