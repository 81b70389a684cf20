"""blocks_dev_ms: device ms per LM iteration of the operations launched
inside the port's `ba.blocks` ranges: the undamped normal-equation blocks: the ba_blocks kernel on the kernel path, the plain index_add_ sweep otherwise.

Source: the device trace, each operation placed at the runtime call that
launched it (benchmark/trace.py), over the traced window's LM
iterations."""
RANGE = "ba.blocks"


def read(ctx):
    if ctx.trace is None or not ctx.iterations:
        return None
    ns = ctx.trace.range_device_ns(RANGE).get(RANGE)
    return None if ns is None else ns / 1e6 / ctx.iterations
