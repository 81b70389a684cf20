"""Create a reconstruction from a Strecha MVS dataset's ground-truth
camera files (port of apps/create_reconstruction_from_strecha_dataset.py;
host I/O only).

ref: applications/create_reconstruction_from_strecha_dataset.cc — reads
the *.camera files (K, R, c, image size) of a Strecha dataset and
writes a Theia-style reconstruction with known poses/intrinsics.

Usage:
  python -m theiasfm_tpu_torch.apps.\\
create_reconstruction_from_strecha_dataset \\
      --strecha_dataset_directory fountain/ --output_reconstruction gt.npz
"""
from __future__ import annotations

import argparse
import sys

from ..io import read_strecha_dataset, write_reconstruction


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--strecha_dataset_directory", required=True,
                   help="directory containing the *.camera files")
    p.add_argument("--output_reconstruction", required=True)
    args = p.parse_args(argv)

    recon = read_strecha_dataset(args.strecha_dataset_directory)
    n_est = sum(v.is_estimated for v in recon.views.values())
    write_reconstruction(recon, args.output_reconstruction)
    print(f"wrote {len(recon.views)} views ({n_est} with ground-truth "
          f"poses) to {args.output_reconstruction}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
