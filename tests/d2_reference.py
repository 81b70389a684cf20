"""The JAX package's readings on the inputs of chip_smoke.py's D2 phases,
on the CPU in float32 (as on a TPU), with the port's beside them where
a gate compares the two.

    JAX_PLATFORMS=cpu python tests/d2_reference.py \
        [--parts akaze akaze_incremental cascade_24 l1_qp \
                 incremental_same_db] \
        [--seeds 0 1 2 3 4] [--out result.json]

Parts (each prints one JSON line per run and one summary line):

* akaze: create_descriptor_extractor("AKAZE") of both packages on the 8
  views of `frontend` and on the 5 MP view (chip_smoke.akaze_views):
  JAX's valid features per view, the port's on the CPU, and the share of
  the port's keypoints with a JAX keypoint at the same level within
  0.5 px (chip_smoke.kp_level_agree), pooled over the 8 views: the
  floor of the card-vs-CPU agreement.
* akaze_incremental: JAX's ReconstructionBuilder(INCREMENTAL) on the
  port's CPU AKAZE features of the 8 views, with FeatureMatcherOptions
  and IncrementalOptions seeded with each seed: views and mean
  reprojection error (chip_smoke.model_report).
* cascade_24: JAX's INCREMENTAL builder on the 24 views of
  `incremental_24` (the port's CPU SIFT features, Fisher-vector pairs,
  8 neighbours) with matcher="cascade_hashing", the hasher and the
  localization seeded with each seed; then JAX's FeatureMatcher without
  verification on the builder's pairs, brute force and cascade hashing:
  the share of the brute force's symmetric putative matches the cascade
  hasher also keeps (chip_smoke.kept_share), JAX's and the port's (its
  own basis from the same seed, on the CPU).
* incremental_same_db: one database of the port's CPU matching of the
  24 views (cascade hashing, seed 0), and both packages'
  incremental_reconstruction on it at each seed (not a gate: whether the
  two back ends agree on the same inputs).
* l1_qp: JAX's l1_solve, constrained_l1_solve, QPSolver and
  qp_solve_box on solver_problems.l1_problem / qp_problem of each seed
  in float32: the RMS error against the truth (L1) and the
  projected-gradient residual (QP) after the full runs and after
  chip_smoke.QP_EARLY_ITERS iterations, and the port's on the CPU.

The summary's `gate` is JAX's worst reading over the seeds: the values
chip_smoke.py's D2 constants hold.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import global_reference as gr  # noqa: E402
import incremental_reference as ir  # noqa: E402
from theiasfm_tpu import image as jimage  # noqa: E402
from theiasfm_tpu.math import l1_solver as jl1  # noqa: E402
from theiasfm_tpu.matching import FeatureMatcher as JFM  # noqa: E402
from theiasfm_tpu.matching import FeatureMatcherOptions as JFMOptions  # noqa
from theiasfm_tpu.matching import database as jdb  # noqa: E402
from theiasfm_tpu.sfm import reconstruction as jreco  # noqa: E402
from theiasfm_tpu.sfm import reconstruction_builder as jrb  # noqa: E402
from theiasfm_tpu.sfm.pipeline import incremental as jinc  # noqa: E402
from theiasfm_tpu_torch import solver_problems as sp  # noqa: E402
from theiasfm_tpu_torch.image import create_descriptor_extractor  # noqa
from theiasfm_tpu_torch.sfm import reconstruction_builder as trb  # noqa


def _emit(rec):
    print(json.dumps(rec), flush=True)
    return rec


def akaze_features(views, extract):
    out = []
    for im in views:
        k, d, v = extract(im)
        out.append((np.asarray(k), np.asarray(d), np.asarray(v)))
    return out


def part_akaze(_seeds):
    views, _, big = cs.akaze_views()
    jx = jimage.create_descriptor_extractor("AKAZE")
    port = create_descriptor_extractor("AKAZE", device="cpu")
    t0 = time.perf_counter()
    jf = akaze_features(views, jx)
    jbig = akaze_features([big], jx)[0]
    t1 = time.perf_counter()
    pf = akaze_features(views, port)
    pbig = akaze_features([big], port)[0]
    t2 = time.perf_counter()
    hits = [cs.kp_level_agree(p, j) for p, j in zip(pf, jf)]
    back = [cs.kp_level_agree(j, p) for p, j in zip(pf, jf)]
    big_hits = cs.kp_level_agree(pbig, jbig)
    rec = dict(
        part="akaze", jax_counts=[int(v.sum()) for _, _, v in jf],
        port_counts=[int(v.sum()) for _, _, v in pf],
        jax_big=int(jbig[2].sum()), port_big=int(pbig[2].sum()),
        port_in_jax=sum(h for h, _ in hits) / sum(n for _, n in hits),
        port_in_jax_per_view=[h / n for h, n in hits],
        jax_in_port=sum(h for h, _ in back) / sum(n for _, n in back),
        big_port_in_jax=big_hits[0] / big_hits[1],
        jax_s=t1 - t0, port_s=t2 - t1)
    _emit(rec)
    return dict(part="akaze", gate=dict(
        AKAZE_JAX_COUNTS=rec["jax_counts"],
        AKAZE_BIG_JAX_COUNT=rec["jax_big"],
        AKAZE_AGREE_MIN=rec["port_in_jax"]))


def _jax_db(arrays, priors):
    db = jdb.InMemoryFeaturesAndMatchesDatabase()
    for n, (k, d) in arrays.items():
        db.put_features(n, jdb.KeypointsAndDescriptors(n, k, d))
        db.put_intrinsics_prior(n, jreco.CameraIntrinsicsPrior(**priors[n]))
    return db


def _jax_build(arrays, priors, names, cams, seed, matcher, n_views):
    kw = {}
    if n_views >= 24:
        kw = dict(select_image_pairs_with_global_descriptors=True,
                  num_nearest_neighbors_for_global_descriptor_matching=8)
    opts = jrb.ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL",
        matching=JFMOptions(seed=seed, matcher=matcher),
        incremental_options=jinc.IncrementalOptions(seed=seed), **kw)
    b = jrb.ReconstructionBuilder(opts, _jax_db(arrays, priors))
    for n in names:
        b.add_image(n)
    t0 = time.perf_counter()
    n_pairs = b.extract_and_match_features()
    t1 = time.perf_counter()
    models = b.build_reconstruction()
    t2 = time.perf_counter()
    rec = dict(seed=seed, matcher=matcher, views=n_views,
               pairs_verified=n_pairs, models=len(models),
               extract_and_match_s=t1 - t0, reconstruct_s=t2 - t1)
    rec.update(cs.model_report(models[0], cams) if models else
               dict(views_estimated=0, reproj_mean_px=None))
    return rec, b


def _worst(runs, n_views):
    return [min(r["views_estimated"] for r in runs) / n_views,
            max((r["reproj_mean_px"] or np.inf) for r in runs)]


def part_akaze_incremental(seeds):
    views, cams, _ = cs.akaze_views()
    names = [f"view{i:03d}" for i in range(len(views))]
    port = create_descriptor_extractor("AKAZE", device="cpu")
    arrays = {n: (k[v], d[v]) for n, (k, d, v) in
              zip(names, akaze_features(views, port))}
    priors = {n: dict(image_width=640, image_height=480, focal_length=600.0,
                      principal_point=(320.0, 240.0)) for n in names}
    runs = []
    for seed in seeds:
        rec, _ = _jax_build(arrays, priors, names, cams, seed,
                            "brute_force", len(names))
        runs.append(_emit(dict(part="akaze_incremental", **rec)))
    return dict(part="akaze_incremental",
                gate=dict(AKAZE_INCR_GATE=_worst(runs, len(names))))


def _putative(arrays, priors, pairs, matcher, seed):
    db = _jax_db(arrays, priors)
    m = JFM(JFMOptions(seed=seed, matcher=matcher,
                       perform_geometric_verification=False), db)
    m.set_image_pairs_to_match(pairs)
    m.match_images()
    return cs.putative_sets(db, pairs)


def _port_putative(arrays, priors, pairs, seed):
    """The port's cascade hasher (its own basis from `seed`, the card's
    basis too) on the CPU, verification off."""
    db = cs.features_db_from_arrays(arrays, priors)
    m = cs.FeatureMatcher(cs.FeatureMatcherOptions(
        seed=seed, matcher="cascade_hashing",
        perform_geometric_verification=False), db, device="cpu")
    m.set_image_pairs_to_match(pairs)
    m.match_images()
    return cs.putative_sets(db, pairs)


def part_cascade_24(seeds):
    cams, names, arrays, priors = ir.features(24)
    runs = []
    for seed in seeds:
        rec, b = _jax_build(arrays, priors, names, cams, seed,
                            "cascade_hashing", 24)
        pairs = b._matcher._pairs
        cas = _putative(arrays, priors, pairs, "cascade_hashing", seed)
        bf = _putative(arrays, priors, pairs, "brute_force", seed)
        port_cas = _port_putative(arrays, priors, pairs, seed)
        rec.update(part="cascade_24", pairs=len(pairs),
                   bf_kept_share=cs.kept_share(bf, cas),
                   port_bf_kept_share=cs.kept_share(bf, port_cas),
                   putative_cascade=sum(len(v) for v in cas.values()),
                   putative_bf=sum(len(v) for v in bf.values()))
        runs.append(_emit(rec))
    return dict(part="cascade_24", gate=dict(
        CASCADE_GATE=_worst(runs, 24),
        CASCADE_SHARE_MIN=min(r["bf_kept_share"] for r in runs)))


def jax_l1_qp(seed):
    """JAX's readings on the seed's problems in float32, as
    chip_smoke.l1_qp_readings takes the port's."""
    lp, qp = sp.l1_problem(seed), sp.qp_problem(seed)
    f = {k: jnp.asarray(v, jnp.float32) for k, v in {**lp, **qp}.items()}
    s = jl1.QPSolver(f["P"], f["q"], max_num_iterations=cs.QP_ITERS)
    s.set_lower_bound(f["lo"])
    s.set_upper_bound(f["hi"])
    early = jl1.QPSolver(f["P"], f["q"], max_num_iterations=cs.QP_EARLY_ITERS)
    early.set_lower_bound(f["lo"])
    early.set_upper_bound(f["hi"])
    box = f["P"], f["q"], f["lo"], f["hi"]
    x = {"l1_solve": jl1.l1_solve(f["A"], f["b"], iters=cs.L1_ITERS),
         "constrained_l1_solve": jl1.constrained_l1_solve(
             f["A"], f["b"], f["C"], f["d"], iters=cs.L1_ITERS),
         "QPSolver": s.solve(), "QPSolver@early": early.solve(),
         "qp_solve_box": jl1.qp_solve_box(*box, iters=cs.QP_BOX_ITERS),
         "qp_solve_box@early": jl1.qp_solve_box(*box,
                                                iters=cs.QP_EARLY_ITERS)}
    x = {k: np.asarray(v) for k, v in x.items()}
    return {k: (v, sp.l1_recovery(v, lp["x_true"]) if "l1" in k else
                sp.qp_kkt(v, **qp)) for k, v in x.items()}


def part_l1_qp(seeds):
    runs = []
    for seed in seeds:
        jx = jax_l1_qp(seed)
        port, _ = cs.l1_qp_readings("cpu", seed)
        rec = dict(part="l1_qp", seed=seed)
        for k, (x, reading) in jx.items():
            xp = port[k][0]
            rec[k] = dict(jax=reading, port_cpu=port[k][1],
                          port_vs_jax_rel=float(np.linalg.norm(xp - x) /
                                                np.linalg.norm(x)))
        runs.append(_emit(rec))
    return dict(part="l1_qp", gate=dict(L1_QP_GATE={
        k: max(r[k]["jax"] for r in runs) for k in
        ("l1_solve", "constrained_l1_solve", "QPSolver@early",
         "qp_solve_box@early")}), full_runs={
        k: dict(jax=[r[k]["jax"] for r in runs],
                port_cpu=[r[k]["port_cpu"] for r in runs])
        for k in ("QPSolver", "qp_solve_box")})


def part_incremental_same_db(seeds):
    """Both packages' incremental_reconstruction on one database: the
    (reconstruction, view graph) the port's CPU builder hands its
    incremental estimator on the 24 views (cascade hashing, seed 0), run
    by each package at each seed: where the two back ends land on the
    same inputs."""
    cams, names, arrays, priors = ir.features(24)
    b = cs.ReconstructionBuilder(cs.ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL",
        select_image_pairs_with_global_descriptors=True,
        num_nearest_neighbors_for_global_descriptor_matching=8,
        matching=cs.FeatureMatcherOptions(matcher="cascade_hashing")),
        cs.features_db_from_arrays(arrays, priors), device="cpu")
    for n in names:
        b.add_image(n)
    b.extract_and_match_features()
    got = {}
    real = trb.incremental_reconstruction

    def grab(recon, graph, *a, **k):
        got["inputs"] = copy.deepcopy((recon, graph))
        return {"success": False}
    trb.incremental_reconstruction = grab
    try:
        b.build_reconstruction()
    finally:
        trb.incremental_reconstruction = real
    runs = []
    for seed in seeds:
        for package in ("jax", "port"):
            recon, graph = copy.deepcopy(got["inputs"])
            if package == "jax":
                recon, graph = gr.to_jax(recon, graph)
                ok = jinc.incremental_reconstruction(
                    recon, graph, jinc.IncrementalOptions(seed=seed))
            else:
                ok = cs.tinc.incremental_reconstruction(
                    recon, graph, cs.tinc.IncrementalOptions(seed=seed),
                    device="cpu")
            rec = dict(part="incremental_same_db", package=package,
                       seed=seed)
            rec.update(cs.model_report(recon, cams) if ok["success"] else
                       dict(views_estimated=0, reproj_mean_px=None))
            runs.append(_emit(rec))
    return dict(part="incremental_same_db", reproj_mean_px={
        p: [r["reproj_mean_px"] for r in runs if r["package"] == p]
        for p in ("jax", "port")})


PARTS = dict(akaze=part_akaze, akaze_incremental=part_akaze_incremental,
             cascade_24=part_cascade_24, l1_qp=part_l1_qp,
             incremental_same_db=part_incremental_same_db)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", nargs="+", choices=list(PARTS),
                    default=["akaze", "akaze_incremental", "cascade_24",
                             "l1_qp"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", False)
    summary = [PARTS[p](args.seeds) for p in args.parts]
    print(json.dumps(dict(summary=summary)), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(summary))


if __name__ == "__main__":
    main()
