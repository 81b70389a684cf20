"""Colorize a reconstruction's 3D points from the source images (port of
apps/colorize_reconstruction.py; host only).

ref: applications/colorize_reconstruction.cc — project each track into
the views observing it and average the sampled pixel colors. Images are
decoded by image.FloatImage.from_file as RGB (PIL, imported there).

Usage:
  python -m theiasfm_tpu_torch.apps.colorize_reconstruction \\
      --input_reconstruction model.npz --image_directory photos/ \\
      --output_reconstruction colored.npz
"""
from __future__ import annotations

import argparse
import os
import sys

from ..image import FloatImage
from ..io import write_reconstruction
from ..sfm.undistort import colorize_reconstruction
from .compare_reconstructions import load_any


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_reconstruction", required=True)
    p.add_argument("--image_directory", required=True)
    p.add_argument("--output_reconstruction", required=True)
    args = p.parse_args(argv)

    recon = load_any(args.input_reconstruction)

    def loader(name):
        path = os.path.join(args.image_directory, name)
        if not os.path.exists(path):
            return None
        return FloatImage.from_file(path, mode="RGB").pixels

    colorize_reconstruction(recon, loader)
    write_reconstruction(recon, args.output_reconstruction)
    print(f"colorized {sum(t.is_estimated for t in recon.tracks.values())} "
          f"tracks -> {args.output_reconstruction}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
