"""Create a calibration JSON from EXIF metadata of images (port of
apps/create_calibration_file_from_exif.py; host only).

ref: applications/create_calibration_file_from_exif.cc. EXIF is read by
sfm.exif_reader.ExifReader (PIL) with the port's own sensor database,
extended by `--sensor_database`.

Usage:
  python -m theiasfm_tpu_torch.apps.create_calibration_file_from_exif \\
      --images 'photos/*.jpg' --output_calibration_file calibration.json
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

from ..io import write_calibration
from ..sfm.exif_reader import ExifReader


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True)
    p.add_argument("--output_calibration_file", required=True)
    p.add_argument("--sensor_database", default="",
                   help="optional 'make model width_mm' database file")
    args = p.parse_args(argv)

    reader = ExifReader(args.sensor_database or None)
    priors = {}
    for path in sorted(glob.glob(args.images)):
        name = os.path.basename(path)
        try:
            prior = reader.extract_exif_metadata(path)
        except Exception as e:
            print(f"skipping {name}: {e}", file=sys.stderr)
            continue
        priors[name] = prior
        f = prior.focal_length
        print(f"{name}: focal={f:.1f}px" if f else f"{name}: no focal")
    write_calibration(priors, args.output_calibration_file)
    print(f"wrote {len(priors)} priors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
