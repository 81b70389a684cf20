"""The JAX package's ReconstructionBuilder(INCREMENTAL) and the port's on
the views of chip_smoke.py's `incremental` phase, on the CPU.

    JAX_PLATFORMS=cpu python tests/incremental_reference.py \
        [--seeds 0 1 2 3 4] [--views 8] [--x64] [--only jax|port] \
        [--out result.json]

The views are the phase's (640x480 renderings of chip_smoke._texture(0)
at focal 600, priors focal 600 and principal point (320, 240)); their
SIFT features (SiftOptions()) come from the port's SIFT on the CPU,
which agrees with the card's on over 99% of the keypoints. Each package
gets them in its builder's database, as the phase hands the card's
features over, and then runs extract_and_match_features (matching and
geometric verification with FeatureMatcherOptions(seed=seed)) and
build_reconstruction with IncrementalOptions(seed=seed); with --views
24 the pairs are chosen by Fisher vectors (8 neighbours), as in the
phase `incremental_24`. JAX runs in float32, as on a TPU, unless --x64;
the port runs in float32 on the CPU.

Each run prints one JSON line: views and tracks estimated, the mean and
median reprojection error, the seed pair (the pair the pipeline
initialized from) with its pose error against the ground truth, the
rotation and position errors after a similarity alignment to the true
cameras (chip_smoke.model_report), and the stage seconds. The last line
is the summary chip_smoke.py's gate is set from (PERF.md, the
incremental cell): JAX's worst reading over the seeds, the fewest views
it estimates and its largest mean reprojection error. Each run also
says whether it meets scripts/bench_e2e.py's looser rule (>= 80% of the
views, mean reprojection error < 2 px).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from theiasfm_tpu.matching import FeatureMatcherOptions as JFMOptions  # noqa
from theiasfm_tpu.matching import database as jdb  # noqa: E402
from theiasfm_tpu.sfm import reconstruction as jreco  # noqa: E402
from theiasfm_tpu.sfm import reconstruction_builder as jrb  # noqa: E402
from theiasfm_tpu.sfm.pipeline import incremental as jinc  # noqa: E402
from theiasfm_tpu_torch.convert import features_db_from_arrays  # noqa
from theiasfm_tpu_torch.image import (SiftOptions, extract_sift,  # noqa
                                      render_synthetic_views)
from theiasfm_tpu_torch.matching import FeatureMatcherOptions  # noqa: E402
from theiasfm_tpu_torch.sfm import reconstruction_builder as trb  # noqa
from theiasfm_tpu_torch.sfm.pipeline import incremental as tinc  # noqa


def features(n_views):
    """The phase's views, ground truth, names, priors and the port's CPU
    SIFT features of each view."""
    views, cams = render_synthetic_views(cs._texture(0), n_views,
                                         (640, 480), focal=600.0)
    names = [f"view{i:03d}" for i in range(n_views)]
    arrays = {}
    for n, im in zip(names, views):
        k, d, v = extract_sift(im, SiftOptions(), device="cpu")
        arrays[n] = (k[v], d[v])
    priors = {n: dict(image_width=640, image_height=480,
                      focal_length=600.0, principal_point=(320.0, 240.0))
              for n in names}
    return cams, names, arrays, priors


def builder_options(mod, fm_options, seed, n_views):
    inc = (jinc if mod is jrb else tinc).IncrementalOptions(seed=seed)
    kw = {}
    if n_views >= 24:
        kw = dict(select_image_pairs_with_global_descriptors=True,
                  num_nearest_neighbors_for_global_descriptor_matching=8)
    return mod.ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL",
        matching=fm_options(seed=seed), incremental_options=inc, **kw)


def run(package, seed, cams, names, arrays, priors):
    if package == "jax":
        db = jdb.InMemoryFeaturesAndMatchesDatabase()
        for n, (k, d) in arrays.items():
            db.put_features(n, jdb.KeypointsAndDescriptors(n, k, d))
            db.put_intrinsics_prior(n, jreco.CameraIntrinsicsPrior(
                **priors[n]))
        b = jrb.ReconstructionBuilder(
            builder_options(jrb, JFMOptions, seed, len(names)), db)
        module = jinc
    else:
        db = features_db_from_arrays(arrays, priors)
        b = trb.ReconstructionBuilder(
            builder_options(trb, FeatureMatcherOptions, seed, len(names)),
            db, device="cpu")
        module = tinc
    for n in names:
        b.add_image(n)
    t0 = time.perf_counter()
    n_pairs = b.extract_and_match_features()
    t1 = time.perf_counter()
    with cs.SeedSpy(module) as spy:
        models = b.build_reconstruction()
    t2 = time.perf_counter()
    rec = dict(package=package, seed=seed, views=len(names),
               pairs_verified=n_pairs, models=len(models),
               extract_and_match_s=t1 - t0, reconstruct_s=t2 - t1,
               seed_pair=spy.seed(cams))
    rec.update(cs.model_report(models[0], cams) if models else
               dict(views_estimated=0, reproj_mean_px=None))
    rec["meets_bench_e2e_rule"] = bool(models) and (
        rec["views_estimated"] >= 0.8 * len(names) and
        rec["reproj_mean_px"] < 2.0)
    rec["meets_gate"] = bool(models) and cs.incremental_gate(rec, len(names))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--only", choices=("jax", "port"))
    ap.add_argument("--out")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", args.x64)
    cams, names, arrays, priors = features(args.views)
    packages = [args.only] if args.only else ["jax", "port"]
    runs = []
    for seed in args.seeds:
        for package in packages:
            rec = run(package, seed, cams, names, arrays, priors)
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    summary = {"views": args.views, "x64": args.x64}
    for package in packages:
        rs = [r for r in runs if r["package"] == package]
        summary[package] = dict(
            seeds=[r["seed"] for r in rs],
            views_estimated=[r["views_estimated"] for r in rs],
            reproj_mean_px=[r["reproj_mean_px"] for r in rs],
            seed_pairs=[(r["seed_pair"] or {}).get("pair") for r in rs],
            all_meet_bench_e2e_rule=all(r["meets_bench_e2e_rule"]
                                        for r in rs),
            all_meet_gate=all(r["meets_gate"] for r in rs),
            least_views=min(r["views_estimated"] for r in rs),
            worst_reproj_mean_px=max((r["reproj_mean_px"] or np.inf)
                                     for r in rs))
    if "jax" in summary:
        j = summary["jax"]
        summary["gate"] = dict(
            views_min_share=j["least_views"] / args.views,
            reproj_max_px=j["worst_reproj_mean_px"],
            rule="JAX's worst reading",
            chip_smoke=dict(views_min_share=cs.INCR_VIEWS_MIN_SHARE,
                            reproj_max_px=cs.INCR_REPROJ_MAX_PX))
    print(json.dumps(summary))
    if args.out:
        Path(args.out).write_text(json.dumps(dict(runs=runs,
                                                  summary=summary)))


if __name__ == "__main__":
    main()
