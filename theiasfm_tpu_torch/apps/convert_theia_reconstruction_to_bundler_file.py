"""Convert a reconstruction to Bundler bundle.out + lists format (port of
apps/convert_theia_reconstruction_to_bundler_file.py; host I/O only).

ref: applications/convert_theia_reconstruction_to_bundler_file.cc. Thin
front-end over the shared converter logic (see also
convert_reconstruction.py).

Usage:
  python -m theiasfm_tpu_torch.apps.\\
convert_theia_reconstruction_to_bundler_file \\
      --input_reconstruction_file model.npz \\
      --output_bundler_file bundle.out --output_list_file list.txt
"""
from __future__ import annotations

import argparse
import sys

from ..io import write_bundler
from .convert_reconstruction import load_reconstruction


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_reconstruction_file", required=True)
    p.add_argument("--output_bundler_file", required=True)
    p.add_argument("--output_list_file", required=True)
    a = p.parse_args(argv)
    recon = load_reconstruction(a.input_reconstruction_file)
    write_bundler(recon, a.output_list_file, a.output_bundler_file)
    print(f"wrote {a.output_bundler_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
