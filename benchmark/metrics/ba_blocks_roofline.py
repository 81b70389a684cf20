"""ba_blocks_roofline: the least time the ba_blocks launches of the
window could take on the card over the device time they took, %.

One launch is two kernels, `ba_blocks_sweep_kernel` (the point and
camera sums) and `ba_blocks_group_kernel` (the group partials); both
count. The least time of one launch is the larger of its bytes over the
HBM rate and its float32 operations over the float32 rate
(benchmark/peaks.json), counted from the cell's shapes as chip_smoke.py's
`ba_blocks` phase counts them: the float32 jacobians and residuals and
the two index arrays read once, each output written once; per
observation 9+3 point and 36+6 camera values, two products and a sum
each, then an add, and the group products."""
KERNELS = ("ba_blocks_sweep_kernel", "ba_blocks_group_kernel")
COUNTER = "ba_blocks"


def bytes_ops(M, Nc, Np, P, **_):
    """Bytes and operations of one launch (float32 inputs)."""
    nbytes = ((12 + 2 * P + 6 + 2) * 4 * M + 8 * M + 48 * Np + 168 * Nc +
              4 * (4 * P * P + 4 * P))
    ops = M * (12 * 4 + 42 * 4 + 8 * P * P + 8 * P)
    return nbytes, ops


def read(ctx):
    launches = ctx.counts.get(COUNTER, 0)
    if ctx.trace is None or not launches:
        return None
    ns, _ = ctx.trace.kernel_ns(KERNELS)
    if not ns:
        return None
    nbytes, ops = bytes_ops(**ctx.shapes)
    least = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                ops / ctx.peaks["f32_ops_per_s"])
    return 100.0 * least * launches / (ns / 1e9)
