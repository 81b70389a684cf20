"""dense_corr_roofline: the least time the window's correction builds
(counter "dense.corr", range `ba.dense_corr`) could take on the card
over the device time they took, %.

The least time of one build is the larger of its bytes over the HBM rate
and its float32 operations over the float32 rate (benchmark/peaks.json),
counted from the cell's shapes as the other rooflines count (each input
read once, each output written once, an FMA two operations):

* bytes: the float32 jacobians (12 + 2P + 6 values an observation), the
  camera, group and point ids (int32), Hpp^-1 (9 float32 a point) in;
  the four (Nc or Ng)-squared float32 tables out: the camera-camera
  corrections (36 a pair of cameras), the camera-group corrections and
  Hcg (6P each) and the group-group corrections (P^2). The list of
  observation pairs the port forms once a solve is not counted: it is a
  product of the ids, which a build can walk itself;
* operations: per observation U = Jc^T Jp, Ug = Ji^T Jp, T = U Hpp^-1,
  Tg = Ug Hpp^-1 and Hcg's Jc^T Ji, 180 + 54P; per ordered pair of
  observations of one point (`pairs`, k == l included) the three blocks
  T_k U_l^T, T_k Ug_l^T, Tg_k Ug_l^T, 2 * 3 * (36 + 6P + P^2).

The device time is every operation launched inside the `ba.dense_corr`
ranges."""
RANGE = "ba.dense_corr"
COUNTER = "dense.corr"


def bytes_ops(M, Nc, Ng, Np, P, pairs, **_):
    """Bytes and operations of one build."""
    nbytes = (M * ((12 + 2 * P + 6) * 4 + 3 * 4) + Np * 9 * 4 +
              4 * (36 * Nc * Nc + 2 * 6 * P * Nc * Ng + P * P * Ng * Ng))
    ops = M * (180 + 54 * P) + pairs * 6 * (36 + 6 * P + P * P)
    return nbytes, ops


def read(ctx):
    builds = ctx.counts.get(COUNTER, 0)
    if ctx.trace is None or not builds or not ctx.shapes.get("pairs"):
        return None
    ns = ctx.trace.range_device_ns(RANGE).get(RANGE)
    if not ns:
        return None
    nbytes, ops = bytes_ops(**ctx.shapes)
    least = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                ops / ctx.peaks["f32_ops_per_s"])
    return 100.0 * least * builds / (ns / 1e9)
