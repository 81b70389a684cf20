"""PLY point-cloud export (port of theiasfm_tpu/io/ply.py).

ref: src/theia/io/write_ply_file.{h,cc}."""
from __future__ import annotations

import numpy as np

from ..sfm.reconstruction import Reconstruction


def write_ply(recon: Reconstruction, path: str,
              include_cameras: bool = True):
    pts, colors = [], []
    for t in recon.tracks.values():
        if t.is_estimated:
            pts.append(t.xyz())
            colors.append(t.color)
    cam_pts = []
    if include_cameras:
        for v in recon.views.values():
            if v.is_estimated:
                cam_pts.append(v.camera.position)
    n = len(pts) + len(cam_pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
        for p in cam_pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 0 255 0\n")
