"""Build a reconstruction from a 1DSfM dataset (Wilson & Snavely) (port
of apps/build_1dsfm_reconstruction.py).

ref: applications/build_1dsfm_reconstruction.cc — load EGs/tracks/
coords, run the global pipeline on `--device` (the card by default;
--device cpu runs on the CPU), write the reconstruction. Exits 1 unless
the pipeline succeeds.

Usage:
  python -m theiasfm_tpu_torch.apps.build_1dsfm_reconstruction \\
      --1dsfm_dataset_directory Notre_Dame/ --output_reconstruction nd.npz
"""
from __future__ import annotations

import argparse
import logging
import sys

from ..io import read_1dsfm, write_reconstruction
from ..sfm.pipeline import GlobalOptions, global_reconstruction
from ..utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--1dsfm_dataset_directory", dest="dataset",
                   required=True)
    p.add_argument("--output_reconstruction", required=True)
    p.add_argument("--position_estimator", default="lud",
                   choices=["nonlinear", "lud"])
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda by default; cpu "
                        "runs on the CPU)")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)
    device = resolve_device(args.device)

    recon, graph = read_1dsfm(args.dataset)
    print(f"loaded: {recon.num_views()} views, {recon.num_tracks()} "
          f"tracks, {graph.num_edges()} epipolar edges")

    opts = GlobalOptions(position_estimator=args.position_estimator,
                         subsample_tracks_for_ba=recon.num_tracks()
                         > 200_000)
    summary = global_reconstruction(recon, graph, opts, device=device)
    print(summary)
    write_reconstruction(recon, args.output_reconstruction)
    print(f"wrote {args.output_reconstruction}")
    return 0 if summary.get("success") else 1


if __name__ == "__main__":
    sys.exit(main())
