"""Calibration file I/O (JSON priors per image; port of
theiasfm_tpu/io/calibration.py).

ref: src/theia/io/read_calibration.{h,cc}, write_calibration.{h,cc}
(rapidjson schema exercised by data/io/calibration_test.json).
"""
from __future__ import annotations

import json
from typing import Dict

from ..camera.models import CameraModelType
from ..sfm.reconstruction import CameraIntrinsicsPrior


def read_calibration(path: str) -> Dict[str, CameraIntrinsicsPrior]:
    with open(path) as f:
        doc = json.load(f)
    out: Dict[str, CameraIntrinsicsPrior] = {}
    for entry in doc.get("priors", []):
        d = entry.get("CameraIntrinsicsPrior", {})
        name = d.get("image_name")
        if not name:
            continue
        p = CameraIntrinsicsPrior()
        p.image_width = int(d.get("width", 0))
        p.image_height = int(d.get("height", 0))
        if "focal_length" in d:
            p.focal_length = float(d["focal_length"])
        if "principal_point" in d:
            p.principal_point = tuple(float(x)
                                      for x in d["principal_point"])
        if "aspect_ratio" in d:
            p.aspect_ratio = float(d["aspect_ratio"])
        if "skew" in d:
            p.skew = float(d["skew"])
        if "radial_distortion_coeffs" in d:
            p.radial_distortion = tuple(
                float(x) for x in d["radial_distortion_coeffs"])
        if "tangential_distortion_coeffs" in d:
            td = d["tangential_distortion_coeffs"]
            p.tangential_distortion = (float(td[0]), float(td[1]))
        if "position" in d:
            import numpy as np
            p.position = np.asarray(d["position"], float)
        if "orientation" in d:
            import numpy as np
            p.orientation = np.asarray(d["orientation"], float)
        t = d.get("camera_intrinsics_type", "PINHOLE")
        try:
            p.camera_intrinsics_model_type = CameraModelType[t]
        except KeyError:
            p.camera_intrinsics_model_type = CameraModelType.PINHOLE
        out[name] = p
    return out


def write_calibration(priors: Dict[str, CameraIntrinsicsPrior],
                      path: str):
    entries = []
    for name, p in priors.items():
        d = {"image_name": name}
        if p.image_width:
            d["width"] = p.image_width
            d["height"] = p.image_height
        if p.focal_length is not None:
            d["focal_length"] = p.focal_length
        if p.principal_point is not None:
            d["principal_point"] = list(p.principal_point)
        if p.aspect_ratio is not None:
            d["aspect_ratio"] = p.aspect_ratio
        if p.skew is not None:
            d["skew"] = p.skew
        if p.radial_distortion is not None:
            d["radial_distortion_coeffs"] = list(p.radial_distortion)
        if p.tangential_distortion is not None:
            d["tangential_distortion_coeffs"] = \
                list(p.tangential_distortion)
        if p.position is not None:
            d["position"] = list(map(float, p.position))
        if p.orientation is not None:
            d["orientation"] = list(map(float, p.orientation))
        d["camera_intrinsics_type"] = p.camera_intrinsics_model_type.name
        entries.append({"CameraIntrinsicsPrior": d})
    with open(path, "w") as f:
        json.dump({"priors": entries}, f, indent=1)
