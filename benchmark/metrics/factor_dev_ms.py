"""factor_dev_ms: device ms per LM iteration of the operations launched
inside the port's `ba.factor` ranges: the dense Schur solver's assembly
of the damped reduced camera system, its Cholesky factorization and the
two triangular solves.

Source: the device trace, each operation placed at the runtime call that
launched it (benchmark/trace.py), over the traced window's LM
iterations."""
RANGE = "ba.factor"


def read(ctx):
    if ctx.trace is None or not ctx.iterations:
        return None
    ns = ctx.trace.range_device_ns(RANGE).get(RANGE)
    return None if ns is None else ns / 1e6 / ctx.iterations
