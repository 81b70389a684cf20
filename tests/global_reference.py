"""The JAX package's global and hybrid pipelines (and the port's) on the
inputs of chip_smoke.py's phases `global_1dsfm`, `global_24` and
`hybrid`, on the CPU.

    JAX_PLATFORMS=cpu python tests/global_reference.py \
        --part city|global_24|hybrid [--seeds ...] [--views N] \
        [--points N] [--x64] [--only jax|port] [--out result.json]

- `city`: bench_problem.build_city_scene(default_rng(seed), views,
  points, 0.5 px, 5% outlier edges) (553 views and 14,000 points by
  default, the phase's scene; seeds 0-9), built once in numpy and handed
  to both packages as the same Reconstruction and ViewGraph, then
  global_reconstruction with GlobalOptions(). Printed per run: views and
  tracks estimated, the reprojection error, and after a similarity
  alignment to the true cameras the rotation errors and the position
  errors in scene units (chip_smoke.city_report), the same reading of
  the cameras before the first triangulation (`poses`,
  chip_smoke.PoseSpy), and the stage seconds.
- `global_24`: the 24 views of the phase `incremental_24`
  (tests/incremental_reference.py's features: the port's SIFT on the
  CPU, Fisher-vector pairs with 8 neighbours) in
  ReconstructionBuilder(GLOBAL) with every other option at its default
  but FeatureMatcherOptions(seed=seed) (seeds 0-9).
- `hybrid`: the 8 views of the phase `incremental` in
  ReconstructionBuilder(HYBRID), likewise (seeds 0-9).
- `global_24_db`: both packages on one database. The port's CPU builder
  matches the 24 views (FeatureMatcherOptions(seed=seed)) and assembles
  the Reconstruction and ViewGraph it hands its estimator; JAX's
  global_reconstruction then runs on that input (the same ids, tracks
  and edges), and so does the port's, in float32 (and the port also in
  float64) or, with --x64, JAX in x64 beside the port in float64.
  Printed per run: the model's reading, and per global stage (the
  cycle filter, rotation averaging, the orientation filter, the
  translation refinement, the 1DSfM filter, LUD, triangulation, the
  track filter) the largest difference from the first run's output.

JAX runs in float32, as on a TPU, unless --x64; the port in float32 on
the CPU. The last line is the summary the phase's gate is set from
(PERF.md, the global cells): JAX's worst reading over the seeds (for
`city`, over a float32 run and an --x64 run). Each part runs ten seeds:
the outcomes are chaotic or unstable in JAX itself, and a few seeds'
worst reading underestimated its range. `global_24_db` runs seeds 0-4
(--db-cache DIR keeps each seed's database for a second, --x64, run). A seed takes some 30 s (`city`,
JAX), 1-2 min (`hybrid`) or 5 min (`global_24`) on 8 CPU cores.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import pickle
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import incremental_reference as ir  # noqa: E402
from theiasfm_tpu.matching import FeatureMatcherOptions as JFMOptions  # noqa
from theiasfm_tpu.matching import database as jdb  # noqa: E402
from theiasfm_tpu.sfm import reconstruction as jreco  # noqa: E402
from theiasfm_tpu.sfm import reconstruction_builder as jrb  # noqa: E402
from theiasfm_tpu.sfm.global_pose import cycle_filter as jcf  # noqa: E402
from theiasfm_tpu.sfm.pipeline import global_pipeline as jgp  # noqa: E402
from theiasfm_tpu.sfm.view_graph import TwoViewInfo as JTwoViewInfo  # noqa
from theiasfm_tpu.sfm.view_graph import ViewGraph as JViewGraph  # noqa
from theiasfm_tpu_torch.bench_problem import build_city_scene  # noqa: E402
from theiasfm_tpu_torch.convert import features_db_from_arrays  # noqa
from theiasfm_tpu_torch.matching import FeatureMatcherOptions  # noqa: E402
from theiasfm_tpu_torch.sfm import reconstruction_builder as trb  # noqa
from theiasfm_tpu_torch.sfm.pipeline import global_pipeline as tgp  # noqa


def to_jax(recon, graph):
    """The port's Reconstruction and ViewGraph as the JAX package's: the
    same ids, the same observation order within each view and the same
    edge order."""
    jrec = jreco.Reconstruction()
    for v in sorted(recon.views):
        view = recon.views[v]
        assert jrec.add_view(view.name, group=recon.view_groups[v]) == v
        cam = jrec.views[v].camera
        cam.intrinsics = np.array(view.camera.intrinsics, float)
        cam.image_width = view.camera.image_width
        cam.image_height = view.camera.image_height
    for t in sorted(recon.tracks):
        assert jrec.add_track() == t
        for v in sorted(recon.tracks[t].views):
            jrec.add_observation(v, t, recon.views[v].features[t])
    jg = JViewGraph()
    for (v1, v2), info in graph.edges().items():
        jg.add_edge(v1, v2, JTwoViewInfo(**dataclasses.asdict(info)))
    return jrec, jg


def run_city(package, seed, n_views, n_points):
    t0 = time.perf_counter()
    recon, graph, extrs = build_city_scene(np.random.default_rng(seed),
                                           n_views, n_points)
    if package == "jax":
        recon, graph = to_jax(recon, graph)
        with cs.PoseSpy(jgp, extrs) as spy:
            summary = jgp.global_reconstruction(recon, graph,
                                                jgp.GlobalOptions())
    else:
        with cs.PoseSpy(tgp, extrs) as spy:
            summary = tgp.global_reconstruction(
                recon, graph, tgp.GlobalOptions(), device="cpu")
    rec = dict(package=package, part="city", seed=seed, views=n_views,
               points=n_points, success=summary["success"],
               timings=summary.get("timings"),
               wall_s=time.perf_counter() - t0, poses=spy.report)
    rec.update(cs.city_report(recon, extrs))
    rec["meets_large_scale_rule"] = bool(
        summary["success"] and rec["views_estimated"] >= 0.95 * n_views
        and rec["median_position_err"] < 0.3)
    return rec


def builder_options(mod, fm_options, kind, seed, n_views):
    kw = {}
    if n_views >= 24:
        kw = dict(select_image_pairs_with_global_descriptors=True,
                  num_nearest_neighbors_for_global_descriptor_matching=8)
    return mod.ReconstructionBuilderOptions(
        reconstruction_estimator_type=kind, matching=fm_options(seed=seed),
        **kw)


def run_builder(package, kind, seed, cams, names, arrays, priors):
    if package == "jax":
        db = jdb.InMemoryFeaturesAndMatchesDatabase()
        for n, (k, d) in arrays.items():
            db.put_features(n, jdb.KeypointsAndDescriptors(n, k, d))
            db.put_intrinsics_prior(n, jreco.CameraIntrinsicsPrior(
                **priors[n]))
        b = jrb.ReconstructionBuilder(builder_options(
            jrb, JFMOptions, kind, seed, len(names)), db)
    else:
        b = trb.ReconstructionBuilder(builder_options(
            trb, FeatureMatcherOptions, kind, seed, len(names)),
            features_db_from_arrays(arrays, priors), device="cpu")
    for n in names:
        b.add_image(n)
    t0 = time.perf_counter()
    n_pairs = b.extract_and_match_features()
    t1 = time.perf_counter()
    models = b.build_reconstruction()
    t2 = time.perf_counter()
    rec = dict(package=package, part=kind, seed=seed, views=len(names),
               pairs_verified=n_pairs, models=len(models),
               extract_and_match_s=t1 - t0, reconstruct_s=t2 - t1)
    rec.update(cs.model_report(models[0], cams) if models else
               dict(views_estimated=0, reproj_mean_px=None))
    return rec


def port_inputs(seed, cams, names, arrays, priors, cache=None):
    """The Reconstruction and ViewGraph the port's builder hands its
    global estimator, from the port's CPU matching at `seed` (kept in
    `cache`/global_24_db_<seed>.pkl when given)."""
    path = Path(cache) / f"global_24_db_{seed}.pkl" if cache else None
    if path is not None and path.exists():
        return pickle.loads(path.read_bytes())
    b = trb.ReconstructionBuilder(builder_options(
        trb, FeatureMatcherOptions, "GLOBAL", seed, len(names)),
        features_db_from_arrays(arrays, priors), device="cpu")
    for n in names:
        b.add_image(n)
    b.extract_and_match_features()
    got = {}
    real = trb.global_reconstruction

    def grab(recon, graph, *a, **k):
        got["inputs"] = copy.deepcopy((recon, graph))
        return {"success": False}
    trb.global_reconstruction = grab
    try:
        b.build_reconstruction()
    finally:
        trb.global_reconstruction = real
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pickle.dumps(got["inputs"]))
    return got["inputs"]


# The global pipeline's stages whose outputs global_24_db compares, in
# pipeline order: (module attribute, reading of (args, output)).
STAGES = (
    ("filter_view_graph_cycles_by_rotation",
     lambda a, o: sorted(a[0].edges())),
    ("robust_rotation_averaging", lambda a, o: np.asarray(o)),
    ("filter_view_pairs_from_orientation", lambda a, o: np.asarray(o)),
    ("_refine_relative_translations", lambda a, o: np.asarray(o)),
    ("filter_view_pairs_from_relative_translation",
     lambda a, o: np.asarray(o)),
    ("estimate_positions_lud", lambda a, o: np.asarray(o)),
    ("estimate_all_tracks", lambda a, o: len(a[0].estimated_tracks())),
    ("set_outlier_tracks_to_unestimated",
     lambda a, o: len(a[0].estimated_tracks())),
)


def run_on_inputs(package, inputs, cams, dtype=None):
    """global_reconstruction with GlobalOptions() on a copy of `inputs`:
    the model's reading and each stage's output (STAGES)."""
    recon, graph = copy.deepcopy(inputs)
    mod = jgp if package == "jax" else tgp
    stages, undo = [], []
    for name, read in STAGES:
        owner = jcf if (package == "jax" and "cycles" in name) else mod
        real = getattr(owner, name)

        def spy(*a, _real=real, _name=name, _read=read, **k):
            out = _real(*a, **k)
            stages.append((_name, _read(a, out)))
            return out
        setattr(owner, name, spy)
        undo.append((owner, name, real))
    try:
        if package == "jax":
            recon, graph = to_jax(recon, graph)
            summary = jgp.global_reconstruction(recon, graph,
                                                jgp.GlobalOptions())
        else:
            summary = tgp.global_reconstruction(
                recon, graph, tgp.GlobalOptions(), dtype=dtype,
                device="cpu")
    finally:
        for owner, name, real in undo:
            setattr(owner, name, real)
    rec = dict(package=package, dtype=str(dtype or jax.numpy.zeros(
        0).dtype), success=summary["success"])
    rec.update(cs.model_report(recon, cams) if summary["success"] else
               dict(views_estimated=0, reproj_mean_px=None))
    return rec, stages


def stage_diffs(ref, other):
    """Per stage, the largest difference of `other`'s output from
    `ref`'s: edges or a keep mask that differ (count), arrays (largest
    absolute difference), track counts (both)."""
    out = []
    for (name, a), (_, b) in zip(ref, other):
        if isinstance(a, list):
            d = len(set(a) ^ set(b))
        elif isinstance(a, np.ndarray) and a.shape != b.shape:
            d = f"shapes {a.shape} {b.shape}"
        elif isinstance(a, np.ndarray) and a.dtype == bool:
            d = int(np.sum(a != b))
        elif isinstance(a, np.ndarray):
            d = float(np.max(np.abs(a - b), initial=0.0))
        else:
            d = [a, b]
        out.append([name, d])
    return out


def run_same_db(seed, cams, names, arrays, priors, x64, cache):
    inputs = port_inputs(seed, cams, names, arrays, priors, cache)
    if x64:
        plan = [("jax", None), ("port", torch.float64)]
    else:
        plan = [("jax", None), ("port", torch.float32),
                ("port", torch.float64)]
    results = [run_on_inputs(p, inputs, cams, dt) for p, dt in plan]
    runs = []
    for rec, stages in results:
        rec.update(part="global_24_db", seed=seed, views=len(names),
                   stages_vs_first=stage_diffs(results[0][1], stages))
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    return runs


def summarize(part, runs, packages):
    summary = {"part": part}
    for package in packages:
        rs = [r for r in runs if r["package"] == package]
        s = dict(seeds=[r["seed"] for r in rs],
                 views_estimated=[r["views_estimated"] for r in rs],
                 reproj_mean_px=[r["reproj_mean_px"] for r in rs],
                 least_views=min(r["views_estimated"] for r in rs),
                 worst_reproj_mean_px=max((r["reproj_mean_px"] or np.inf)
                                          for r in rs))
        if part == "city":
            poses = [r["poses"] or {} for r in rs]
            s.update(
                poses_median_position_err=[
                    p.get("median_position_err") for p in poses],
                poses_median_rotation_err_deg=[
                    p.get("median_rotation_err_deg") for p in poses],
                worst_poses_median_position_err=max(
                    p.get("median_position_err", np.inf) for p in poses),
                worst_poses_median_rotation_err_deg=max(
                    p.get("median_rotation_err_deg", np.inf)
                    for p in poses))
            s.update(
                median_position_err=[r.get("median_position_err")
                                     for r in rs],
                median_rotation_err_deg=[r.get("median_rotation_err_deg")
                                         for r in rs],
                worst_median_position_err=max(
                    r.get("median_position_err", np.inf) for r in rs),
                worst_median_rotation_err_deg=max(
                    r.get("median_rotation_err_deg", np.inf) for r in rs),
                all_meet_large_scale_rule=all(r["meets_large_scale_rule"]
                                              for r in rs))
        summary[package] = s
    return summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("city", "global_24", "hybrid",
                                       "global_24_db"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+")
    ap.add_argument("--views", type=int)
    ap.add_argument("--points", type=int, default=14_000)
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--only", choices=("jax", "port"))
    ap.add_argument("--out")
    ap.add_argument("--db-cache")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", args.x64)
    packages = [args.only] if args.only else ["jax", "port"]
    seeds = args.seeds or list(range(10))
    runs = []
    if args.part == "global_24_db":
        seeds = args.seeds or list(range(5))
        cams, names, arrays, priors = ir.features(24)
        for seed in seeds:
            runs += run_same_db(seed, cams, names, arrays, priors, args.x64,
                                args.db_cache)
        summary = {"part": args.part, "x64": args.x64}
        for key, pick in (("jax", lambda r: r["package"] == "jax"),
                          ("port_f32", lambda r: r["dtype"] ==
                           "torch.float32"),
                          ("port_f64", lambda r: r["dtype"] ==
                           "torch.float64")):
            rs = [r for r in runs if pick(r)]
            if rs:
                summary[key] = {k: [r.get(k) for r in rs] for k in (
                    "seed", "views_estimated", "tracks_estimated",
                    "reproj_mean_px", "median_rotation_err_deg")}
        print(json.dumps(summary))
        if args.out:
            Path(args.out).write_text(json.dumps(dict(runs=runs,
                                                      summary=summary)))
        return
    if args.part == "city":
        n_views = args.views or 553
        for seed in seeds:
            for package in packages:
                runs.append(run_city(package, seed, n_views, args.points))
                print(json.dumps(runs[-1]), flush=True)
    else:
        n_views = args.views or (24 if args.part == "global_24" else 8)
        kind = "GLOBAL" if args.part == "global_24" else "HYBRID"
        cams, names, arrays, priors = ir.features(n_views)
        for seed in seeds:
            for package in packages:
                runs.append(run_builder(package, kind, seed, cams, names,
                                        arrays, priors))
                print(json.dumps(runs[-1]), flush=True)
    summary = summarize(args.part, runs, packages)
    summary.update(views=n_views, x64=args.x64)
    print(json.dumps(summary))
    if args.out:
        Path(args.out).write_text(json.dumps(dict(runs=runs,
                                                  summary=summary)))


if __name__ == "__main__":
    main()
