"""schur_pass1_roofline: the least time the schur_pass1 launches of the
window could take on the card over the device time they took, %.

The least time of one launch is the larger of its bytes over the HBM
rate and its float32 operations over the float32 rate (benchmark/
peaks.json), counted from the cell's shapes as chip_smoke.py's
`_bytes_ops` counts them: each input read once, each output written
once, an FMA two operations. The launches are the program's count, the
device time the trace's `schur_pass1_kernel` operations."""
KERNELS = ("schur_pass1_kernel",)
COUNTER = "schur_pass1"


def bytes_ops(M, Nc, Np, P, matvec_bytes, **_):
    """Bytes and operations of one launch."""
    jac = (12 + 2 * P + 6) * M * matvec_bytes
    # jacobians, ids, vc, vg in; u (2, M), wp (Np, 3) out
    nbytes = jac + 8 * M + 24 * Nc + 4 * P + 8 * M + 12 * Np
    # u: 2(6+P) FMAs; Jpᵀu: 6 FMAs; 3 adds into wp
    ops = M * (4 * (6 + P) + 12 + 3)
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
