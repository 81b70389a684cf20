"""Export a reconstruction to the PMVS/CMVS input layout (port of
apps/export_reconstruction_to_pmvs.py; host only).

ref: applications/export_reconstruction_to_pmvs.cc — writes
visualize/ (the images), txt/ (P matrices), models/ and
pmvs_options.txt.

Usage:
  python -m theiasfm_tpu_torch.apps.export_reconstruction_to_pmvs \\
      --reconstruction model.npz --images_directory photos/ \\
      --pmvs_working_directory pmvs/
"""
from __future__ import annotations

import argparse
import sys

from ..io import export_pmvs
from .compare_reconstructions import load_any


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reconstruction", required=True)
    p.add_argument("--images_directory", required=True)
    p.add_argument("--pmvs_working_directory", required=True)
    args = p.parse_args(argv)

    recon = load_any(args.reconstruction)
    n = export_pmvs(recon, args.pmvs_working_directory,
                    images_dir=args.images_directory)
    print(f"exported {n} views to {args.pmvs_working_directory}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
