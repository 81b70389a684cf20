"""Export a reconstruction to a VisualSfM NVM file (port of
apps/export_to_nvm_file.py; host I/O only).

ref: applications/export_to_nvm_file.cc. Thin front-end over the shared
converter logic (see also convert_reconstruction.py).

Usage:
  python -m theiasfm_tpu_torch.apps.export_to_nvm_file \\
      --input_reconstruction_file model.npz --output_nvm_file model.nvm
"""
from __future__ import annotations

import argparse
import sys

from ..io import write_nvm
from .convert_reconstruction import load_reconstruction


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_reconstruction_file", required=True)
    p.add_argument("--output_nvm_file", required=True)
    a = p.parse_args(argv)
    recon = load_reconstruction(a.input_reconstruction_file)
    write_nvm(recon, a.output_nvm_file)
    print(f"wrote {a.output_nvm_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
