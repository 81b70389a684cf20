"""Write a reconstruction's point cloud (+ cameras) as a PLY file (port
of apps/write_reconstruction_ply_file.py; host I/O only).

ref: applications/write_reconstruction_ply_file.cc. Thin front-end over
the shared converter logic (see also convert_reconstruction.py).

Usage:
  python -m theiasfm_tpu_torch.apps.write_reconstruction_ply_file \\
      --reconstruction model.npz --ply_file model.ply
"""
from __future__ import annotations

import argparse
import sys

from ..io import write_ply
from .convert_reconstruction import load_reconstruction


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reconstruction", required=True)
    p.add_argument("--ply_file", required=True)
    a = p.parse_args(argv)
    recon = load_reconstruction(a.reconstruction)
    write_ply(recon, a.ply_file)
    print(f"wrote {a.ply_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
