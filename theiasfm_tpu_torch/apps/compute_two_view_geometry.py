"""Estimate two-view geometry between two images (port of
apps/compute_two_view_geometry.py).

ref: applications/compute_two_view_geometry.cc — extract features,
match, run 5-pt RANSAC, print the relative pose. SIFT, the brute-force
matcher and the RANSAC run on `--device` (the card by default; --device
cpu runs on the CPU). The RANSAC samples come from a torch.Generator
seeded 0 on the CPU whatever the device, so the card and the CPU draw
the same ones (the JAX CLI draws from jax.random.PRNGKey(0)).

Usage:
  python -m theiasfm_tpu_torch.apps.compute_two_view_geometry \\
      --image1 a.jpg --image2 b.jpg --focal1 600 --focal2 600
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..image import SiftOptions, extract_sift, load_gray
from ..matching import match_descriptors
from ..sfm.pipeline import TwoViewInfoOptions, estimate_twoview_info
from ..solvers.ransac import random_samples
from ..utils import next_bucket
from ..utils.device import resolve_device


def ransac_samples(num_matches: int, num_hypotheses: int, device):
    """(H, 5) sample indices into the matches padded to the RANSAC's
    bucket (a power of two of at least 64), drawn on a CPU generator
    seeded 0 and moved to `device`."""
    n = next_bucket(num_matches, 64)
    valid = torch.arange(n) < num_matches
    idx = random_samples(torch.Generator().manual_seed(0), n, 5,
                         num_hypotheses, valid)
    return idx.to(device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image1", required=True)
    p.add_argument("--image2", required=True)
    p.add_argument("--focal1", type=float, default=0.0,
                   help="focal length px (default 1.2*max_dim)")
    p.add_argument("--focal2", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda by default; cpu "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    g1 = load_gray(args.image1)
    g2 = load_gray(args.image2)
    opts = SiftOptions()
    kp1, d1, v1 = extract_sift(g1, opts, device=device)
    kp2, d2, v2 = extract_sift(g2, opts, device=device)
    print(f"features: {int(v1.sum())} / {int(v2.sum())}")

    def t(x):
        return torch.as_tensor(x, device=device)
    idx2, valid, _ = match_descriptors(t(d1), t(d2), mask1=t(v1),
                                       mask2=t(v2))
    idx2 = idx2.cpu().numpy()
    sel = np.nonzero(valid.cpu().numpy())[0]
    print(f"putative matches: {len(sel)}")
    if len(sel) < 10:
        print("too few matches")
        return 1

    f1 = args.focal1 or 1.2 * max(g1.shape)
    f2 = args.focal2 or 1.2 * max(g2.shape)
    pp1 = (g1.shape[1] / 2, g1.shape[0] / 2)
    pp2 = (g2.shape[1] / 2, g2.shape[0] / 2)
    two_view = TwoViewInfoOptions()
    info, inl = estimate_twoview_info(
        ransac_samples(len(sel), two_view.num_hypotheses, device),
        kp1[sel][:, :2], kp2[idx2[sel]][:, :2], f1, f2, two_view,
        pp1=pp1, pp2=pp2, device=device)
    print(f"verified matches: {info.num_verified_matches}")
    print(f"relative rotation (angle-axis): {info.rotation_2}")
    print(f"relative position (unit): {info.position_2}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
