"""Build a 3D reconstruction from images — flagship CLI (port of
apps/build_reconstruction.py).

ref: applications/build_reconstruction.cc (the gflags surface,
:46-260, is mirrored here with argparse; same defaults where
meaningful). The flags, their defaults and the output names are those of
the JAX CLI; `--platform` became `--device` (default cuda: a run without
a card fails at once; pass --device cpu to run on the CPU).

Usage:
  python -m theiasfm_tpu_torch.apps.build_reconstruction \\
      --images 'photos/*.jpg' --output_reconstruction out/model \\
      --reconstruction_estimator GLOBAL
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

from ..image import SiftOptions
from ..io import read_calibration, write_reconstruction
from ..matching import (DiskFeaturesAndMatchesDatabase,
                        FeatureMatcherOptions,
                        InMemoryFeaturesAndMatchesDatabase)
from ..sfm.global_pose import PositionEstimatorOptions
from ..sfm.pipeline import GlobalOptions, IncrementalOptions
from ..sfm.pipeline.estimate_tracks import EstimateTracksOptions
from ..sfm.pipeline.localize import LocalizeOptions
from ..sfm.pipeline.twoview import TwoViewInfoOptions
from ..sfm.reconstruction_builder import (ReconstructionBuilder,
                                          ReconstructionBuilderOptions)
from ..utils.device import resolve_device


# --feature_density: SIFT's keypoint budget per octave
FEATURE_DENSITY = {"SPARSE": 512, "NORMAL": 1024, "DENSE": 2048}


def _loss_name(s: str) -> str:
    return {"TRIVIAL": "trivial", "HUBER": "huber",
            "SOFTLONE": "softl1", "CAUCHY": "cauchy",
            "ARCTAN": "arctan", "TUKEY": "tukey"}[s]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    # --- input/output (ref build_reconstruction.cc flags) ---
    p.add_argument("--images", required=True,
                   help="glob of input images")
    p.add_argument("--output_reconstruction", required=True)
    p.add_argument("--matching_working_directory", "--matches_dir",
                   dest="matches_dir", default="",
                   help="features/matches database directory "
                        "(enables out-of-core storage + resume)")
    p.add_argument("--calibration_file", default="")
    p.add_argument("--max_num_images", type=int, default=0,
                   help="0 = no limit")
    p.add_argument("--image_masks", default="",
                   help="glob of binary feature-extraction masks "
                        "(white = use pixel)")
    p.add_argument("--num_threads", type=int, default=0,
                   help="accepted for ref-compatibility; parallelism "
                        "here is batched device execution, not threads")
    # --- calibration ---
    p.add_argument("--shared_calibration", action="store_true",
                   help="all images share one intrinsics group")
    p.add_argument("--only_calibrated_views", action="store_true",
                   help="only use images with a calibration prior")
    # --- matching ---
    p.add_argument("--matching_strategy", default="brute_force",
                   choices=["brute_force", "cascade_hashing"])
    p.add_argument("--lowes_ratio", type=float, default=0.8)
    p.add_argument("--keep_only_symmetric_matches", type=int, default=1)
    p.add_argument("--min_num_inliers_for_valid_match", type=int,
                   default=30)
    p.add_argument("--max_sampson_error_for_verified_match", type=float,
                   default=4.0)
    p.add_argument("--bundle_adjust_two_view_geometry", type=int,
                   default=1)
    p.add_argument("--select_image_pairs_with_global_image_descriptor_"
                   "matching", dest="global_pair_selection",
                   action="store_true")
    p.add_argument("--num_nearest_neighbors_for_global_descriptor_"
                   "matching", dest="global_knn", type=int, default=100)
    p.add_argument("--num_gmm_clusters_for_fisher_vector", type=int,
                   default=16)
    p.add_argument("--max_num_features_for_fisher_vector_training",
                   type=int, default=1_000_000)
    # --- features ---
    p.add_argument("--feature_density", default="NORMAL",
                   choices=["SPARSE", "NORMAL", "DENSE"])
    # --- estimator selection ---
    p.add_argument("--reconstruction_estimator", default="GLOBAL",
                   choices=["GLOBAL", "INCREMENTAL", "HYBRID"])
    p.add_argument("--reconstruct_largest_connected_component",
                   action="store_true")
    p.add_argument("--intrinsics_to_optimize", default="FOCAL_LENGTH",
                   choices=["NONE", "FOCAL_LENGTH", "ALL"])
    p.add_argument("--min_track_length", type=int, default=2)
    p.add_argument("--max_track_length", type=int, default=50)
    # --- global pipeline ---
    p.add_argument("--global_rotation_estimator", default="ROBUST_L1L2",
                   choices=["ROBUST_L1L2", "NONLINEAR", "LINEAR"])
    p.add_argument("--global_position_estimator", "--position_estimator",
                   dest="position_estimator", default="NONLINEAR",
                   choices=["NONLINEAR", "LEAST_UNSQUARED_DEVIATION",
                            "LINEAR_TRIPLET",
                            "nonlinear", "lud", "linear_triplet"])
    p.add_argument("--refine_relative_translations_after_rotation_"
                   "estimation", dest="refine_rel_trans", type=int,
                   default=1)
    p.add_argument("--extract_maximal_rigid_subgraph",
                   action="store_true")
    p.add_argument("--filter_relative_translations_with_1dsfm",
                   dest="filter_1dsfm", type=int, default=1)
    p.add_argument("--post_rotation_filtering_degrees", type=float,
                   default=5.0)
    p.add_argument("--position_estimation_robust_loss_width",
                   type=float, default=0.1)
    p.add_argument("--num_retriangulation_iterations", type=int,
                   default=1)
    p.add_argument("--refine_camera_positions_and_points_after_position_"
                   "estimation", dest="refine_after_position", type=int,
                   default=1)
    # --- incremental pipeline ---
    p.add_argument("--absolute_pose_reprojection_error_threshold",
                   type=float, default=4.0)
    p.add_argument("--min_num_absolute_pose_inliers", type=int,
                   default=30)
    p.add_argument("--full_bundle_adjustment_growth_percent",
                   type=float, default=5.0)
    p.add_argument("--partial_bundle_adjustment_num_views", type=int,
                   default=20)
    # --- triangulation ---
    p.add_argument("--max_reprojection_error_pixels", type=float,
                   default=5.0)
    p.add_argument("--min_triangulation_angle_degrees", type=float,
                   default=3.0)
    p.add_argument("--bundle_adjust_tracks", type=int, default=1)
    # --- bundle adjustment ---
    p.add_argument("--bundle_adjustment_robust_loss_function",
                   default="SOFTLONE",
                   choices=["TRIVIAL", "HUBER", "SOFTLONE", "CAUCHY",
                            "ARCTAN", "TUKEY"])
    p.add_argument("--bundle_adjustment_robust_loss_width", type=float,
                   default=2.0)
    # --- track subset selection ---
    p.add_argument("--subsample_tracks_for_bundle_adjustment",
                   action="store_true")
    p.add_argument("--track_selection_image_grid_cell_size_pixels",
                   type=int, default=100)
    p.add_argument("--track_subset_selection_long_track_length_"
                   "threshold", dest="long_track_threshold", type=int,
                   default=10)
    p.add_argument("--min_num_optimized_tracks_per_view", type=int,
                   default=100)
    # --- misc ---
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda by default; cpu "
                        "runs the plain versions of the kernels)")
    return p


def options_from_args(args) -> ReconstructionBuilderOptions:
    """The ReconstructionBuilderOptions the flags ask for (the JAX CLI's
    mapping)."""
    sift = SiftOptions(
        max_features_per_octave=FEATURE_DENSITY[args.feature_density])
    intrin = {"NONE": (False,) * 10,
              "FOCAL_LENGTH": (True,) + (False,) * 9,
              "ALL": (True,) * 10}[args.intrinsics_to_optimize]
    pos_est = {"NONLINEAR": "nonlinear",
               "LEAST_UNSQUARED_DEVIATION": "lud",
               "LINEAR_TRIPLET": "linear_triplet"}.get(
        args.position_estimator, args.position_estimator)
    loss = _loss_name(args.bundle_adjustment_robust_loss_function)
    tracks = EstimateTracksOptions(
        max_acceptable_reprojection_error_pixels=args
        .max_reprojection_error_pixels,
        min_triangulation_angle_degrees=args
        .min_triangulation_angle_degrees,
        bundle_adjust_tracks=bool(args.bundle_adjust_tracks))
    localize = LocalizeOptions(
        reprojection_error_threshold_pixels=args
        .absolute_pose_reprojection_error_threshold,
        min_num_inliers=args.min_num_absolute_pose_inliers)

    return ReconstructionBuilderOptions(
        reconstruction_estimator_type=args.reconstruction_estimator,
        select_image_pairs_with_global_descriptors=args
        .global_pair_selection,
        num_nearest_neighbors_for_global_descriptor_matching=args
        .global_knn,
        num_gmm_clusters_for_fisher_vector=args
        .num_gmm_clusters_for_fisher_vector,
        max_num_features_for_fisher_vector_training=args
        .max_num_features_for_fisher_vector_training,
        min_track_length=args.min_track_length,
        max_track_length=args.max_track_length,
        min_num_inlier_matches=args.min_num_inliers_for_valid_match,
        sift=sift,
        matching=FeatureMatcherOptions(
            lowes_ratio=args.lowes_ratio,
            matcher=args.matching_strategy,
            keep_only_symmetric_matches=bool(
                args.keep_only_symmetric_matches),
            min_num_feature_matches=args.min_num_inliers_for_valid_match,
            geometric_verification=TwoViewInfoOptions(
                max_sampson_error_pixels=args
                .max_sampson_error_for_verified_match,
                min_inliers=args.min_num_inliers_for_valid_match)),
        global_options=GlobalOptions(
            rotation_estimator=args.global_rotation_estimator.lower(),
            position_estimator=pos_est,
            refine_relative_translations=bool(args.refine_rel_trans),
            extract_maximal_rigid_subgraph=args
            .extract_maximal_rigid_subgraph,
            filter_relative_translations=bool(args.filter_1dsfm),
            rotation_filtering_max_difference_degrees=args
            .post_rotation_filtering_degrees,
            num_retriangulation_iterations=args
            .num_retriangulation_iterations,
            max_reprojection_error_pixels=args
            .max_reprojection_error_pixels,
            min_triangulation_angle_degrees=args
            .min_triangulation_angle_degrees,
            position=PositionEstimatorOptions(
                robust_loss_width=args
                .position_estimation_robust_loss_width),
            tracks=tracks,
            intrinsics_optimized=intrin,
            subsample_tracks_for_ba=args
            .subsample_tracks_for_bundle_adjustment,
            track_subset_grid_cell_size=args
            .track_selection_image_grid_cell_size_pixels,
            track_subset_long_track_length_threshold=args
            .long_track_threshold,
            min_num_optimized_tracks_per_view=args
            .min_num_optimized_tracks_per_view,
            ba_loss=loss,
            ba_loss_scale_pixels=args
            .bundle_adjustment_robust_loss_width),
        incremental_options=IncrementalOptions(
            max_reprojection_error_pixels=args
            .max_reprojection_error_pixels,
            min_triangulation_angle_degrees=args
            .min_triangulation_angle_degrees,
            full_bundle_adjustment_growth_percent=args
            .full_bundle_adjustment_growth_percent,
            partial_ba_num_views=args
            .partial_bundle_adjustment_num_views,
            min_num_two_view_inliers=args
            .min_num_inliers_for_valid_match,
            localize=localize,
            tracks=tracks,
            intrinsics_optimized=intrin,
            ba_loss=loss,
            ba_loss_scale_pixels=args
            .bundle_adjustment_robust_loss_width),
    )


def main(argv=None):
    args = build_parser().parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)
    if args.num_threads:
        logging.info("--num_threads accepted for compatibility; "
                     "parallelism is batched device execution")
    if args.image_masks:
        logging.warning("--image_masks is not supported yet; ignoring")
    if not args.refine_after_position:
        logging.info("--refine_camera_positions_and_points_after_"
                     "position_estimation=0 accepted; the pipeline "
                     "refines during BA regardless")

    options = options_from_args(args)
    db = (DiskFeaturesAndMatchesDatabase(args.matches_dir)
          if args.matches_dir else InMemoryFeaturesAndMatchesDatabase())
    builder = ReconstructionBuilder(options, db, device=device)

    priors = (read_calibration(args.calibration_file)
              if args.calibration_file else {})
    paths = sorted(glob.glob(args.images))
    if args.max_num_images:
        paths = paths[:args.max_num_images]
    if not paths:
        print(f"no images match {args.images}", file=sys.stderr)
        return 1
    n_added = 0
    for path in paths:
        name = os.path.basename(path)
        prior = priors.get(name)
        if args.only_calibrated_views and prior is None:
            continue
        builder.add_image(path, prior,
                          group=0 if args.shared_calibration else None)
        n_added += 1
    if not n_added:
        print("no usable images (only_calibrated_views filtered all?)",
              file=sys.stderr)
        return 1

    n = builder.extract_and_match_features()
    print(f"matched {n} new verified pairs "
          f"({db.num_matches()} total in db)")

    models = builder.build_reconstruction()
    if args.reconstruct_largest_connected_component and len(models) > 1:
        models = [max(models, key=lambda m: len(m.estimated_views()))]
    print(f"built {len(models)} model(s)")
    os.makedirs(os.path.dirname(args.output_reconstruction) or ".",
                exist_ok=True)
    for i, m in enumerate(models):
        out = f"{args.output_reconstruction}-{i}.npz"
        write_reconstruction(m, out)
        print(f"  model {i}: {len(m.estimated_views())} views, "
              f"{len(m.estimated_tracks())} tracks -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
