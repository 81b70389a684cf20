"""schur_pass2_roofline: the least time the schur_pass2 launches of the
window could take on the card over the device time they took, %.

One launch is two kernels, `schur_pass2_obs_kernel` (stage A, per
observation) and `schur_pass2_cam_kernel` (stage B, the camera sums);
both count. The least time of one launch is the larger of its bytes
over the HBM rate and its float32 operations over the float32 rate
(benchmark/peaks.json), counted from the cell's shapes as
chip_smoke.py's `_bytes_ops` counts them: each input read once, each
output written once, an FMA two operations."""
KERNELS = ("schur_pass2_obs_kernel", "schur_pass2_cam_kernel")
COUNTER = "schur_pass2"


def bytes_ops(M, Nc, Np, P, matvec_bytes, **_):
    """Bytes and operations of one launch."""
    jac = (12 + 2 * P + 6) * M * matvec_bytes
    # jacobians, ids, u, zp in; yc (Nc, 6), yg (2P, 2) out
    nbytes = jac + 8 * M + 8 * M + 12 * Np + 24 * Nc + 16 * P
    # Jp·z: 6 FMAs; 2 subs; Jcᵀd: 12 FMAs, 6 adds; Jiᵀd: 4P FMAs
    ops = M * (12 + 2 + 24 + 6 + 8 * P)
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
