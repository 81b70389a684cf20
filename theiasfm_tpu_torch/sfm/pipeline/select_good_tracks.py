"""Track subsampling for efficient bundle adjustment (port of
theiasfm_tpu/sfm/pipeline/select_good_tracks.py).

ref: src/theia/sfm/select_good_tracks_for_bundle_adjustment.{h,cc}:
rank tracks per view by (truncated length, mean reprojection error),
bin each view's features into an image grid, keep the best track per
occupied cell — guaranteeing spatial coverage in every view while
shrinking the BA problem. The reprojection errors are one batched
computation on `device` (the card unless the caller passes "cpu") in
`dtype`, paired with the observations as the JAX module pairs them
(filters._reprojection_errors); the ranking stays on the host.
"""
from __future__ import annotations

from typing import Dict, Set

import numpy as np
import torch

from ..reconstruction import Reconstruction
from .filters import _reprojection_errors


def select_good_tracks_for_bundle_adjustment(
        recon: Reconstruction,
        long_track_length_threshold: int = 10,
        image_grid_cell_size_pixels: int = 100,
        min_num_optimized_tracks_per_view: int = 100,
        dtype=torch.float32, device="cuda") -> Set[int]:
    """Returns the set of track ids to optimize."""
    obs, errors = _reprojection_errors(recon, dtype, device)
    mean_err: Dict[int, float] = {}
    count: Dict[int, int] = {}
    for (v, t), e in zip(obs, errors):
        if np.isfinite(e):
            mean_err[t] = mean_err.get(t, 0.0) + e
            count[t] = count.get(t, 0) + 1
    for t in mean_err:
        mean_err[t] /= count[t]

    selected: Set[int] = set()
    for v in recon.estimated_views():
        view = recon.views[v]
        # rank candidate tracks of this view
        cands = []
        for t, feat in view.features.items():
            tr = recon.tracks.get(t)
            if tr is None or not tr.is_estimated or t not in mean_err:
                continue
            trunc_len = min(len(tr.views), long_track_length_threshold)
            cands.append((-trunc_len, mean_err[t], t, feat))
        cands.sort()
        # grid-cell selection
        taken_cells = set()
        n_taken = 0
        for _, _, t, feat in cands:
            cell = (int(feat[0] // image_grid_cell_size_pixels),
                    int(feat[1] // image_grid_cell_size_pixels))
            if cell in taken_cells and \
                    n_taken >= min_num_optimized_tracks_per_view:
                continue
            if cell not in taken_cells or \
                    n_taken < min_num_optimized_tracks_per_view:
                selected.add(t)
                taken_cells.add(cell)
                n_taken += 1
    return selected
