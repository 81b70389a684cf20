"""schur_groups_pass2_roofline: the least time the grouped pass-2
launches of the window (fused_matvec.pass2_groups, counter
"schur_pass2_groups") could take on the card over the device time they
took, %.

One launch is three kernels: `schur_groups_pass2_obs_kernel` (stage A,
per observation) and two `schur_groups_segsum_kernel` (stage B, the
camera and the group sums); all count. The least time of one launch is
the larger of its bytes over the HBM rate and its float32 operations
over the float32 rate (benchmark/peaks.json), counted from the cell's
shapes as schur_pass2_roofline counts them (each input read once, each
output written once, an FMA two operations), plus the group index (4 B
an observation) and yg, an (Ng, P) f32 table in place of the one group's
(2P, 2), counted where the cell's shapes give the group count Ng. Where
they give none, the table is left out (under 0.01% of the bytes at BAL
Final). Stage A's row workspaces are not counted either, so the share
stays a lower bound on the time."""
KERNELS = ("schur_groups_pass2_obs_kernel", "schur_groups_segsum_kernel")
COUNTER = "schur_pass2_groups"


def bytes_ops(M, Nc, Np, P, matvec_bytes, Ng=0, **_):
    """Bytes and operations of one launch."""
    jac = (12 + 2 * P + 6) * M * matvec_bytes
    # jacobians, ids, group index, u, zp in; yc (Nc, 6), yg (Ng, P) out
    nbytes = (jac + 8 * M + 4 * M + 8 * M + 12 * Np + 24 * Nc +
              4 * P * Ng)
    # Jp·z: 6 FMAs; 2 subs; Jcᵀd: 12 FMAs, 6 adds; Jiᵀd: 2P FMAs, P adds
    ops = M * (12 + 2 + 24 + 6 + 4 * P + P)
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
