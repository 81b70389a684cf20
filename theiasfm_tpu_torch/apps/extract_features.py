"""Extract SIFT features from images into a features database (port of
apps/extract_features.py).

ref: applications/extract_features.cc. Images are decoded by
image.load_gray (PIL) and SIFT runs on `--device` (the card by default;
--device cpu runs on the CPU).

Usage:
  python -m theiasfm_tpu_torch.apps.extract_features \\
      --input_images 'photos/*.jpg' --features_output_directory db/
"""
from __future__ import annotations

import argparse
import glob
import sys

from ..image import SiftOptions
from ..matching import DiskFeaturesAndMatchesDatabase
from ..sfm.feature_extractor import FeatureExtractor, FeatureExtractorOptions
from ..utils.device import resolve_device
from .build_reconstruction import FEATURE_DENSITY


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_images", required=True)
    p.add_argument("--features_output_directory", required=True)
    p.add_argument("--feature_density", default="NORMAL",
                   choices=["SPARSE", "NORMAL", "DENSE"])
    p.add_argument("--device", default="cuda",
                   help="torch device of SIFT (cuda by default; cpu runs "
                        "on the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    fe = FeatureExtractor(FeatureExtractorOptions(
        sift=SiftOptions(
            max_features_per_octave=FEATURE_DENSITY[args.feature_density])),
        device=device)
    db = DiskFeaturesAndMatchesDatabase(args.features_output_directory)
    paths = sorted(glob.glob(args.input_images))
    n = fe.extract_to_db(paths, db)
    print(f"extracted features for {n} new images "
          f"({len(db.image_names_of_features())} total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
