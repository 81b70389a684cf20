"""Reconstruction statistics: track lengths, reprojection errors,
view/track counts (port of apps/compute_reconstruction_statistics.py).

ref: applications/compute_reconstruction_statistics.cc. The reprojection
errors are one batched call on `--device` (the card by default; --device
cpu runs on the CPU), float32 as in the JAX package. `_reprojection_
errors` pairs each error with another observation where the point-sorted
and view-listed orders differ (ROADMAP.md, queue 3); that changes which
observation an error is charged to, not the set of errors, so the
median, mean and max printed here are unaffected.

Usage:
  python -m theiasfm_tpu_torch.apps.compute_reconstruction_statistics \\
      --reconstruction model.npz
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..sfm.pipeline.filters import _reprojection_errors
from ..utils.device import resolve_device
from .compare_reconstructions import load_any


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reconstruction", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of the reprojection errors (cuda "
                        "by default; cpu runs on the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    recon = load_any(args.reconstruction)
    est_views = recon.estimated_views()
    est_tracks = recon.estimated_tracks()
    print(f"views: {recon.num_views()} ({len(est_views)} estimated)")
    print(f"tracks: {recon.num_tracks()} ({len(est_tracks)} estimated)")

    lengths = [len(recon.tracks[t].views) for t in est_tracks]
    if lengths:
        print(f"track length: mean {np.mean(lengths):.2f}  "
              f"median {np.median(lengths):.0f}  max {np.max(lengths)}")

    obs, errors = _reprojection_errors(recon, device=device)
    if len(errors):
        finite = errors[np.isfinite(errors)]
        print(f"observations: {len(errors)}")
        print(f"reprojection error (px): median {np.median(finite):.3f} "
              f"mean {finite.mean():.3f}  max {finite.max():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
