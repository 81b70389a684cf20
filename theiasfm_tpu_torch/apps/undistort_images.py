"""Undistort images using a reconstruction's camera models (port of
apps/undistort_images.py).

ref: applications/undistort_images.cc. Each image is decoded by
image.FloatImage.from_file, resampled on `--device` (the card by
default; --device cpu runs on the CPU) and written with PIL as 8 bits.

Usage:
  python -m theiasfm_tpu_torch.apps.undistort_images \\
      --reconstruction model.npz --input_images_directory photos/ \\
      --output_images_directory undistorted/
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..image import FloatImage
from ..sfm.undistort import undistort_image
from ..utils.device import resolve_device
from .compare_reconstructions import load_any


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reconstruction", required=True)
    p.add_argument("--input_images_directory", required=True)
    p.add_argument("--output_images_directory", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of the resampling (cuda by default; "
                        "cpu runs on the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from PIL import Image

    recon = load_any(args.reconstruction)
    os.makedirs(args.output_images_directory, exist_ok=True)
    n = 0
    for view in recon.views.values():
        src = os.path.join(args.input_images_directory, view.name)
        if not os.path.exists(src):
            continue
        img = FloatImage.from_file(src).pixels
        out = undistort_image(view.camera, img, device=device)
        out8 = np.clip(out * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(out8).save(
            os.path.join(args.output_images_directory, view.name))
        n += 1
    print(f"undistorted {n} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
