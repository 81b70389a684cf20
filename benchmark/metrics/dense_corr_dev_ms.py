"""dense_corr_dev_ms: device ms per LM iteration of the operations
launched inside the port's `ba.dense_corr` ranges: the dense Schur
solver's correction blocks, Hcp Hpp^-1 Hpc and its group parts, built
from every pair of observations of a point.

Source: the device trace, each operation placed at the runtime call that
launched it (benchmark/trace.py), over the traced window's LM
iterations."""
RANGE = "ba.dense_corr"


def read(ctx):
    if ctx.trace is None or not ctx.iterations:
        return None
    ns = ctx.trace.range_device_ns(RANGE).get(RANGE)
    return None if ns is None else ns / 1e6 / ctx.iterations
