"""Render a reconstruction to an image, a matplotlib 3D scatter (port of
apps/view_reconstruction.py; host only).

ref: applications/view_reconstruction.cc (OpenGL/GLUT interactive
viewer); here a headless renderer writing a PNG snapshot. matplotlib is
imported inside `main` (the Agg backend).

Usage:
  python -m theiasfm_tpu_torch.apps.view_reconstruction \\
      --reconstruction model.npz --output reconstruction.png
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .compare_reconstructions import load_any


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reconstruction", required=True)
    p.add_argument("--output", default="reconstruction.png")
    p.add_argument("--max_points", type=int, default=50000)
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    recon = load_any(args.reconstruction)
    pts, cols = [], []
    for t in recon.tracks.values():
        if t.is_estimated:
            pts.append(t.xyz())
            cols.append(t.color / 255.0)
    pts = np.stack(pts) if pts else np.zeros((0, 3))
    cols = np.stack(cols) if cols else np.zeros((0, 3))
    if len(pts) > args.max_points:
        sel = np.random.default_rng(0).choice(len(pts), args.max_points,
                                              replace=False)
        pts, cols = pts[sel], cols[sel]
    cams = np.stack([v.camera.position for v in recon.views.values()
                     if v.is_estimated]) if recon.estimated_views() \
        else np.zeros((0, 3))

    # robust axis limits
    if len(pts):
        med = np.median(pts, axis=0)
        mad = np.median(np.abs(pts - med), axis=0).max() * 6 + 1e-6
    else:
        med, mad = np.zeros(3), 1.0

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=cols, s=0.5)
    if len(cams):
        ax.scatter(cams[:, 0], cams[:, 1], cams[:, 2], c="red", s=30,
                   marker="^")
    for dim, setter in enumerate([ax.set_xlim, ax.set_ylim, ax.set_zlim]):
        setter(med[dim] - mad, med[dim] + mad)
    ax.set_title(f"{len(pts)} points, {len(cams)} cameras")
    fig.savefig(args.output, dpi=120)
    plt.close(fig)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
