"""Host-side reconstruction data model (port of
theiasfm_tpu/sfm/reconstruction.py, in part).

Ported so far: CameraIntrinsicsPrior, which the features-and-matches
database stores per image. The Reconstruction container, View, Track
and Camera wait for the slice that needs them (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..camera.models import CameraModelType


@dataclasses.dataclass
class CameraIntrinsicsPrior:
    """ref: src/theia/sfm/camera_intrinsics_prior.h — optional per-view
    calibration priors (is_set flag per entry)."""
    image_width: int = 0
    image_height: int = 0
    focal_length: Optional[float] = None
    principal_point: Optional[Tuple[float, float]] = None
    aspect_ratio: Optional[float] = None
    skew: Optional[float] = None
    radial_distortion: Optional[Tuple[float, ...]] = None
    tangential_distortion: Optional[Tuple[float, float]] = None
    position: Optional[np.ndarray] = None
    orientation: Optional[np.ndarray] = None
    camera_intrinsics_model_type: CameraModelType = CameraModelType.PINHOLE
