"""Calibrate shared camera intrinsics from images taken by ONE camera
(port of apps/calibrate_camera_intrinsics.py).

ref: applications/calibrate_camera_intrinsics.cc — all images are
placed in a single shared-intrinsics group, a reconstruction is built
optimizing the shared intrinsics, and the process is iterated (the
estimated intrinsics seed the next round) until stable. Prints the
calibrated parameters. Each round's ReconstructionBuilder runs on
`--device` (the card by default; --device cpu runs on the CPU).

Usage:
  python -m theiasfm_tpu_torch.apps.calibrate_camera_intrinsics \\
      --images 'photos/*.jpg' --output_calibration_file calibration.json
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

from ..io import write_calibration
from ..sfm.pipeline import GlobalOptions, IncrementalOptions
from ..sfm.reconstruction import CameraIntrinsicsPrior
from ..sfm.reconstruction_builder import (ReconstructionBuilder,
                                          ReconstructionBuilderOptions)
from ..utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True,
                   help="glob of images from a single physical camera")
    p.add_argument("--num_calibration_iterations", type=int, default=2)
    p.add_argument("--output_calibration_file", default="")
    p.add_argument("--reconstruction_estimator", default="INCREMENTAL",
                   choices=["GLOBAL", "INCREMENTAL", "HYBRID"])
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda by default; cpu "
                        "runs on the CPU)")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)
    device = resolve_device(args.device)

    paths = sorted(glob.glob(args.images))
    if len(paths) < 3:
        print(f"need >= 3 images, got {len(paths)}", file=sys.stderr)
        return 1

    # optimize all intrinsics slots of the single shared group
    intrin = (True,) * 10
    prior = None
    intr_out = None
    for it in range(args.num_calibration_iterations):
        options = ReconstructionBuilderOptions(
            reconstruction_estimator_type=args.reconstruction_estimator,
            global_options=GlobalOptions(intrinsics_optimized=intrin),
            incremental_options=IncrementalOptions(
                intrinsics_optimized=intrin),
        )
        builder = ReconstructionBuilder(options, device=device)
        for path in paths:
            builder.add_image(path, prior, group=0)
        builder.extract_and_match_features()
        models = builder.build_reconstruction()
        if not models:
            print("reconstruction failed", file=sys.stderr)
            return 1
        best = max(models, key=lambda m: len(m.estimated_views()))
        # shared group: every estimated view carries the group params
        views = best.estimated_views()
        cam = best.views[views[0]].camera
        intr_out = cam.intrinsics.copy()
        print(f"iteration {it}: {len(views)} views calibrated; "
              f"focal={intr_out[0]:.2f} aspect={intr_out[1]:.4f} "
              f"pp=({intr_out[3]:.1f},{intr_out[4]:.1f})")
        prior = CameraIntrinsicsPrior()
        prior.focal_length = float(intr_out[0])

    if args.output_calibration_file and intr_out is not None:
        priors = {}
        for path in paths:
            q = CameraIntrinsicsPrior()
            q.focal_length = float(intr_out[0])
            priors[os.path.basename(path)] = q
        write_calibration(priors, args.output_calibration_file)
        print(f"wrote {args.output_calibration_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
