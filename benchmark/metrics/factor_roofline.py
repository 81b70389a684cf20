"""factor_roofline: the least time the window's factorizations (counter
"dense.factor", range `ba.factor`) could take on the card over the
device time they took, %.

The damped reduced camera system has D = 6 Nc + P Ng unknowns. The least
time of one factorization and solve is the larger of its bytes over the
HBM rate and its float32 operations over the float32 rate
(benchmark/peaks.json): D^3/3 + 2 D^2 operations (the Cholesky
factorization and the two triangular solves) and 2 * D^2 * 4 bytes (the
assembled matrix read, its factor written). The device time is every
operation launched inside the `ba.factor` ranges, the assembly of the
matrix among them."""
RANGE = "ba.factor"
COUNTER = "dense.factor"


def bytes_ops(Nc, Ng, P, **_):
    """Bytes and operations of one factorization and solve."""
    D = 6 * Nc + P * Ng
    return 2 * D * D * 4, D ** 3 / 3 + 2 * D * D


def read(ctx):
    factors = ctx.counts.get(COUNTER, 0)
    if ctx.trace is None or not factors or "Ng" not in ctx.shapes:
        return None
    ns = ctx.trace.range_device_ns(RANGE).get(RANGE)
    if not ns:
        return None
    nbytes, ops = bytes_ops(**ctx.shapes)
    least = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                ops / ctx.peaks["f32_ops_per_s"])
    return 100.0 * least * factors / (ns / 1e9)
