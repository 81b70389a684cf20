"""Strecha MVS dataset reader, <image>.camera files (port of
theiasfm_tpu/io/strecha.py; rotations in float64 on the host).

ref: src/theia/io/read_strecha_dataset.{h,cc}. Each .camera file:
K (3x3 row-major), 3 zeros (distortion line), R (3x3, camera->world),
camera position (3), image width height. The reference converts to its
world->camera convention by transposing R.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from . import _rotation as rot
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction


def read_strecha_camera(path: str):
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(x) for x in line.split())
    K = np.asarray(vals[0:9]).reshape(3, 3)
    # vals[9:12] = distortion zeros
    R_cw = np.asarray(vals[12:21]).reshape(3, 3)  # camera->world
    position = np.asarray(vals[21:24])
    w, h = int(vals[24]), int(vals[25])
    R_wc = R_cw.T
    return K, R_wc, position, w, h


def read_strecha_dataset(directory: str) -> Reconstruction:
    recon = Reconstruction()
    for path in sorted(glob.glob(os.path.join(directory, "*.camera"))):
        K, R_wc, position, w, h = read_strecha_camera(path)
        name = os.path.basename(path).replace(".camera", "")
        vid = recon.add_view(name)
        view = recon.views[vid]
        view.camera.intrinsics[0] = K[0, 0]
        view.camera.intrinsics[1] = K[1, 1] / K[0, 0]
        view.camera.intrinsics[2] = K[0, 1]
        view.camera.intrinsics[3] = K[0, 2]
        view.camera.intrinsics[4] = K[1, 2]
        view.camera.image_width = w
        view.camera.image_height = h
        view.camera.extrinsics[:3] = position
        view.camera.extrinsics[3:6] = rot.rotation_matrix_to_angle_axis(R_wc)
        view.is_estimated = True
        view.prior = CameraIntrinsicsPrior(
            image_width=w, image_height=h, focal_length=K[0, 0],
            principal_point=(K[0, 2], K[1, 2]),
            aspect_ratio=K[1, 1] / K[0, 0], skew=K[0, 1])
    return recon
