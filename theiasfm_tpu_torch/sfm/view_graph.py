"""View graph types (port of theiasfm_tpu/sfm/view_graph.py, in part).

Ported so far: TwoViewInfo, the payload the features-and-matches
database stores per image pair. The ViewGraph itself waits for the
slice that needs it (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TwoViewInfo:
    """ref: src/theia/sfm/twoview_info.h. rotation_2/position_2 describe
    camera 2 relative to camera 1 (angle-axis; unit baseline)."""
    focal_length_1: float = 0.0
    focal_length_2: float = 0.0
    position_2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    rotation_2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    num_verified_matches: int = 0
    num_homography_inliers: int = 0
    visibility_score: int = 0
