"""cg_dev_ms: device ms per LM iteration of the operations launched
inside the port's `ba.cg` ranges: the preconditioned CG loop, with the Schur products: the schur_pass1 and schur_pass2 kernels on the kernel path, gathers, einsums and index_add_ otherwise.

Source: the device trace, each operation placed at the runtime call that
launched it (benchmark/trace.py), over the traced window's LM
iterations."""
RANGE = "ba.cg"


def read(ctx):
    if ctx.trace is None or not ctx.iterations:
        return None
    ns = ctx.trace.range_device_ns(RANGE).get(RANGE)
    return None if ns is None else ns / 1e6 / ctx.iterations
