"""The 24-view INCREMENTAL builds of chip_smoke.py's `cascade_24` and
`incremental_24`, on one device at several seeds, without JAX.

    python tests/d2_card_probe.py [--device cuda] [--seeds 0 1 2 3 4]

The 24 views of `incremental_24` (640x480 renderings of
chip_smoke._texture(0) at focal 600), their SIFT features on `device`,
Fisher-vector pairs (8 neighbours), then ReconstructionBuilder(
INCREMENTAL) with matcher="cascade_hashing" and with the brute force,
FeatureMatcherOptions and IncrementalOptions seeded with each seed.
Each build prints one JSON line (views, tracks, mean and median
reprojection error: chip_smoke.model_report); for seed 0 the port's
back end also rebuilds on the CPU from the device's database. It reads
where the device's front end lands against tests/d2_reference.py's
JAX readings (PERF.md; ROADMAP queue 3).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

KEYS = ("views_estimated", "tracks_estimated", "reproj_mean_px",
        "reproj_median_px", "observations")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    if args.device == "cuda":
        cs.phase_env()
    n = 24
    views, cams = cs.render_synthetic_views(cs._texture(0), n, (640, 480),
                                            focal=600.0)
    names = [f"view{i:03d}" for i in range(n)]
    feats = cs.extract_sift_batch(views, cs.SiftOptions(),
                                  device=args.device)
    scene = dict(names=names, cams=cams, arrays={
        nm: (k[v], d[v]) for nm, (k, d, v) in zip(names, feats)},
        priors={nm: dict(image_width=640, image_height=480,
                         focal_length=600.0, principal_point=(320.0, 240.0))
                for nm in names})
    for matcher in ("cascade_hashing", "brute_force"):
        for seed in args.seeds:
            opts = cs.ReconstructionBuilderOptions(
                reconstruction_estimator_type="INCREMENTAL",
                select_image_pairs_with_global_descriptors=True,
                num_nearest_neighbors_for_global_descriptor_matching=8,
                matching=cs.FeatureMatcherOptions(matcher=matcher, seed=seed),
                incremental_options=cs.tinc.IncrementalOptions(seed=seed))
            b = cs._builder(scene, opts, device=args.device)
            t0 = time.perf_counter()
            b.extract_and_match_features()
            models = b.build_reconstruction()
            rep = cs.model_report(models[0], cams)
            print(json.dumps(dict(matcher=matcher, seed=seed,
                                  device=args.device,
                                  s=time.perf_counter() - t0,
                                  **{k: rep[k] for k in KEYS})), flush=True)
            if seed == args.seeds[0] and args.device != "cpu":
                models = cs._builder(scene, opts, device="cpu",
                                     db=b.db).build_reconstruction()
                rep = cs.model_report(models[0], cams)
                print(json.dumps(dict(matcher=matcher, seed=seed,
                                      device="cpu, the device's database",
                                      **{k: rep[k] for k in KEYS})),
                      flush=True)
    if args.device == "cuda":
        print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
