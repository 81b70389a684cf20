"""Populate camera image sizes from the images on disk (port of
theiasfm_tpu/io/populate_image_sizes.py).

ref: src/theia/io/populate_image_sizes.{h,cc} — loads each view's image
from a directory, sets the camera's image size and a principal point at
the image center. Host-side I/O (no device work).
"""
from __future__ import annotations

import os

from ..image.float_image import image_size_from_file
from ..sfm.reconstruction import Reconstruction


def populate_image_sizes(recon: Reconstruction, image_directory: str,
                         ) -> bool:
    """Set image size + centered principal point on every view's camera
    whose image file is found in `image_directory`. Returns False if the
    directory is missing (ref returns false, populate_image_sizes.cc)."""
    if not os.path.isdir(image_directory):
        return False
    ok = True
    for vid in list(recon.views):
        view = recon.view(vid)
        path = os.path.join(image_directory, view.name)
        if not os.path.exists(path):
            ok = False
            continue
        w, h = image_size_from_file(path)
        cam = view.camera
        cam.image_width = w
        cam.image_height = h
        cam.intrinsics[3] = w / 2.0
        cam.intrinsics[4] = h / 2.0
    return ok
