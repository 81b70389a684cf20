"""Convert reconstructions between formats (port of
apps/convert_reconstruction.py; host I/O only, no device work).

Covers the roles of ref applications: convert_bundle_file.cc,
convert_nvm_file.cc, convert_theia_reconstruction_to_bundler_file.cc,
export_to_nvm_file.cc, export_colmap_files.cc,
write_reconstruction_ply_file.cc.

Input formats: .npz (native), .bin (Theia cereal), .nvm, bundler
(pass --input_lists). Output: native/nvm/colmap/ply/bundler/theia.

Usage:
  python -m theiasfm_tpu_torch.apps.convert_reconstruction \\
      --input out/model-0.npz --output out/model.bin --output_format theia
"""
from __future__ import annotations

import argparse
import sys

from ..io import (read_bundler, read_nvm, read_reconstruction,
                  read_theia_reconstruction, write_bundler, write_colmap,
                  write_nvm, write_ply, write_reconstruction,
                  write_theia_reconstruction)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--input_lists", default="",
                   help="lists.txt (bundler input only)")
    p.add_argument("--output", required=True)
    p.add_argument("--output_format", required=True,
                   choices=["native", "nvm", "colmap", "ply", "bundler",
                            "theia"])
    args = p.parse_args(argv)

    if args.input.endswith(".npz"):
        recon = read_reconstruction(args.input)
    elif args.input.endswith(".nvm"):
        recon = read_nvm(args.input)
    elif args.input_lists:
        recon = read_bundler(args.input_lists, args.input)
    else:
        recon = read_theia_reconstruction(args.input)

    print(f"loaded: {recon.num_views()} views, "
          f"{recon.num_tracks()} tracks")

    if args.output_format == "native":
        write_reconstruction(recon, args.output)
    elif args.output_format == "nvm":
        write_nvm(recon, args.output)
    elif args.output_format == "colmap":
        write_colmap(recon, args.output)
    elif args.output_format == "ply":
        write_ply(recon, args.output)
    elif args.output_format == "bundler":
        write_bundler(recon, args.output + ".list.txt", args.output)
    elif args.output_format == "theia":
        write_theia_reconstruction(args.output, recon)
    print(f"wrote {args.output_format}: {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
