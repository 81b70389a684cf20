"""schur_groups_pass1_roofline: the least time the grouped pass-1
launches of the window (fused_matvec.pass1_groups, counter
"schur_pass1_groups") could take on the card over the device time they
took, %.

The least time of one launch is the larger of its bytes over the HBM
rate and its float32 operations over the float32 rate (benchmark/
peaks.json), counted from the cell's shapes as schur_pass1_roofline
counts them (each input read once, each output written once, an FMA two
operations), plus the group ids (4 B an observation) and vg, an (Ng, P)
f32 table in place of the one group's (P,), counted where the cell's
shapes give the group count Ng. Where they give none, the table is left
out (under 0.01% of the bytes at BAL Final), so the share stays a lower
bound on the time whatever the grouping. The device time is the trace's
`schur_groups_pass1_kernel` operations."""
KERNELS = ("schur_groups_pass1_kernel",)
COUNTER = "schur_pass1_groups"


def bytes_ops(M, Nc, Np, P, matvec_bytes, Ng=0, **_):
    """Bytes and operations of one launch."""
    jac = (12 + 2 * P + 6) * M * matvec_bytes
    # jacobians, camera and point ids, group ids, vc, vg in; u (2, M),
    # wp (Np, 3) out
    nbytes = jac + 8 * M + 4 * M + 24 * Nc + 4 * P * Ng + 8 * M + 12 * Np
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
