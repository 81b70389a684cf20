"""Visibility pyramid: COLMAP-style next-best-view scoring (a copy of
theiasfm_tpu/sfm/visibility_pyramid.py, which is numpy only).

ref: src/theia/sfm/visibility_pyramid.{h,cc}:44-70 — a multi-level
occupancy pyramid over the image; a view's score sums, over levels,
(number of occupied cells) * (cells per side), rewarding many
well-spread observations. Used to rank views for localization.
"""
from __future__ import annotations

import numpy as np


class VisibilityPyramid:
    def __init__(self, width: int, height: int, num_levels: int = 6):
        self.width = max(width, 1)
        self.height = max(height, 1)
        self.num_levels = num_levels
        self.grids = [np.zeros((2 ** lv, 2 ** lv), dtype=np.int32)
                      for lv in range(1, num_levels + 1)]

    def add_point(self, x: float, y: float):
        fx = min(max(x / self.width, 0.0), 1.0 - 1e-9)
        fy = min(max(y / self.height, 0.0), 1.0 - 1e-9)
        for g in self.grids:
            n = g.shape[0]
            g[int(fy * n), int(fx * n)] += 1

    def compute_score(self) -> int:
        score = 0
        for g in self.grids:
            score += int((g > 0).sum()) * g.shape[0]
        return score


def visibility_score_of_inliers(pix1, pix2, size1, size2,
                                num_levels: int = 6) -> int:
    """Summed two-view pyramid score of the inlier correspondences.

    ref: estimate_twoview_info.cc:102-129
    (ComputeVisibilityScoreOfInliers) — a 6-level occupancy pyramid per
    image over the inlier features; if either image size is unknown the
    reference falls back to the inlier count. Vectorized (np.unique of
    cell ids per level) instead of the per-point AddPoint loop.
    """
    pix1 = np.asarray(pix1, float)
    pix2 = np.asarray(pix2, float)
    n = len(pix1)
    if (not size1 or not size2 or not size1[0] or not size1[1]
            or not size2[0] or not size2[1]):
        return n
    if n == 0:
        return 0
    score = 0
    for pix, (w, h) in ((pix1, size1), (pix2, size2)):
        fx = np.clip(pix[:, 0] / max(w, 1), 0.0, 1.0 - 1e-9)
        fy = np.clip(pix[:, 1] / max(h, 1), 0.0, 1.0 - 1e-9)
        for lv in range(1, num_levels + 1):
            m = 2 ** lv
            cells = (fy * m).astype(np.int64) * m + (fx * m).astype(
                np.int64)
            score += len(np.unique(cells)) * m
    return int(score)


def view_visibility_score(recon, view_id) -> int:
    """Score a view by its observations of ESTIMATED tracks (ref
    FindViewsToLocalize ranking in the incremental estimator)."""
    view = recon.views[view_id]
    w = view.camera.image_width or int(2 * view.camera.intrinsics[3]) \
        or 1024
    h = view.camera.image_height or int(2 * view.camera.intrinsics[4]) \
        or 768
    pyr = VisibilityPyramid(w, h)
    n = 0
    for t, feat in view.features.items():
        tr = recon.tracks.get(t)
        if tr is not None and tr.is_estimated:
            pyr.add_point(feat[0], feat[1])
            n += 1
    if n == 0:
        return 0
    return pyr.compute_score()
