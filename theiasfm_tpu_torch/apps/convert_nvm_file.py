"""Convert an NVM file to a native reconstruction (port of
apps/convert_nvm_file.py; host I/O only).

ref: applications/convert_nvm_file.cc. Thin front-end over the shared
converter logic (see also convert_reconstruction.py).

Usage:
  python -m theiasfm_tpu_torch.apps.convert_nvm_file \\
      --input_nvm_file model.nvm --output_reconstruction_file out.npz
"""
from __future__ import annotations

import argparse
import sys

from ..io import read_nvm, write_reconstruction


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_nvm_file", required=True)
    p.add_argument("--output_reconstruction_file", required=True)
    a = p.parse_args(argv)
    recon = read_nvm(a.input_nvm_file)
    write_reconstruction(recon, a.output_reconstruction_file)
    print(f"{recon.num_views()} views, {recon.num_tracks()} tracks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
