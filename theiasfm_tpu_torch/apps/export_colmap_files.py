"""Export a reconstruction to COLMAP cameras/images/points3D text files
(port of apps/export_colmap_files.py; host I/O only).

ref: applications/export_colmap_files.cc. Thin front-end over the shared
converter logic (see also convert_reconstruction.py).

Usage:
  python -m theiasfm_tpu_torch.apps.export_colmap_files \\
      --input_reconstruction_file model.npz --output_folder colmap/
"""
from __future__ import annotations

import argparse
import os
import sys

from ..io import write_colmap
from .convert_reconstruction import load_reconstruction


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_reconstruction_file", required=True)
    p.add_argument("--output_folder", required=True)
    a = p.parse_args(argv)
    recon = load_reconstruction(a.input_reconstruction_file)
    os.makedirs(a.output_folder, exist_ok=True)
    write_colmap(recon, a.output_folder)
    print(f"wrote COLMAP files to {a.output_folder}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
