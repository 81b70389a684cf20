"""PMVS/CMVS export: txt projection matrices + options file (port of
theiasfm_tpu/io/pmvs.py; the matrices in float64 on the host).

ref: applications/export_reconstruction_to_pmvs.cc — writes
txt/%08d.txt P-matrices, visualize/ image links, and a pmvs options
file so dense reconstruction tools can consume the sparse model.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..sfm import triangulation as tri
from ..sfm.reconstruction import Reconstruction


def export_pmvs(recon: Reconstruction, output_dir: str,
                images_dir: str = ""):
    os.makedirs(os.path.join(output_dir, "txt"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "models"), exist_ok=True)
    vids = [v for v in sorted(recon.views.keys())
            if recon.views[v].is_estimated]
    for i, v in enumerate(vids):
        cam = recon.views[v].camera
        K = np.zeros((3, 3))
        K[0, 0] = cam.intrinsics[0]
        K[1, 1] = cam.intrinsics[0] * cam.intrinsics[1]
        K[0, 1] = cam.intrinsics[2]
        K[0, 2] = cam.intrinsics[3]
        K[1, 2] = cam.intrinsics[4]
        K[2, 2] = 1.0
        P = tri.projection_matrix(
            torch.as_tensor(np.asarray(cam.extrinsics, np.float64)),
            torch.as_tensor(K)).numpy()
        with open(os.path.join(output_dir, "txt",
                               f"{i:08d}.txt"), "w") as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(f"{row[0]} {row[1]} {row[2]} {row[3]}\n")
        if images_dir:
            src = os.path.join(images_dir, recon.views[v].name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(
                    output_dir, "visualize", f"{i:08d}.jpg"))
    with open(os.path.join(output_dir, "pmvs_options.txt"), "w") as f:
        f.write("level 1\ncsize 2\nthreshold 0.7\nwsize 7\n"
                "minImageNum 3\nCPU 8\nsetEdge 0\nuseBound 0\n"
                "useVisData 0\nsequence -1\n"
                f"timages -1 0 {len(vids)}\noimages 0\n")
    return len(vids)
