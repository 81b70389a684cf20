"""precond_roofline: the least time the window's SCHUR_JACOBI builds
(counter "precond.build", range `ba.precond`) could take on the card over
the device time they took, %.

The least time of one build is the larger of its bytes over the HBM rate
and its float32 operations over the float32 rate (benchmark/peaks.json),
counted from the cell's shapes as the other rooflines count (each input
read once, each output written once, an FMA two operations):

* bytes: per observation the jacobians in the matvec type (12 + 2P + 6
  values) and the camera and point ids (int32); Hpp^-1 (9 float32 a
  point) in; per camera Hcc (36 float32) in and the inverse block (36
  float32) out. The shapes give no group count, so the group ids and
  the group blocks are left out, as schur_groups_pass1_roofline leaves
  its group table out without one: the share stays a lower bound;
* operations: per observation V = [Jc | Ji]^T Jp ((6 + P) x 3 entries of
  2 products), T = V Hpp^-1 (3 products each), the 21 upper values of
  T_U U^T and the P(P + 1)/2 of T_Ug Ug^T (3 products each), an FMA two
  operations: 2 (153 + 15P + 3P(P + 1)/2); and the sums, one add a
  value: 21 + P(P + 1)/2.

The device time is every operation launched inside the `ba.precond`
ranges (the corrections, the damping, the inverses): the same work
whatever implements it. Nothing to read (None) where no build was
counted: a program without the counter, or a cell without the
preconditioner."""
RANGE = "ba.precond"
COUNTER = "precond.build"


def bytes_ops(M, Nc, Np, P, matvec_bytes, **_):
    """Bytes and operations of one build."""
    tri = P * (P + 1) // 2
    nbytes = M * ((12 + 2 * P + 6) * matvec_bytes + 8) + 36 * Np + 288 * Nc
    ops = M * (2 * (153 + 15 * P + 3 * tri) + 21 + tri)
    return nbytes, ops


def read(ctx):
    builds = ctx.counts.get(COUNTER, 0)
    if ctx.trace is None or not builds:
        return None
    ns = ctx.trace.range_device_ns(RANGE).get(RANGE)
    if not ns:
        return None
    nbytes, ops = bytes_ops(**ctx.shapes)
    least = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                ops / ctx.peaks["f32_ops_per_s"])
    return 100.0 * least * builds / (ns / 1e9)
