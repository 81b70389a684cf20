"""Reconstruction-level bundle adjustment entry points (port of
theiasfm_tpu/sfm/ba/entry_points.py).

ref: src/theia/sfm/bundle_adjustment/bundle_adjustment.h:135-158 —
BundleAdjustReconstruction / BundleAdjustPartialReconstruction /
BundleAdjustView / BundleAdjustTrack. Each wrapper snapshots the
reconstruction into a BAProblem on `device` (the card unless the caller
asks for the CPU), masks the held-constant blocks (cam_mask/point_mask
replace Ceres SetParameterBlockConstant), runs the bucketed Schur LM
and writes the result back. `dtype` is the snapshot's type
(Reconstruction.to_ba_problem says why float32 is the default).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from .bundle_adjustment import BAOptions, bundle_adjust_bucketed


def _ba_summary_dict(summary):
    return {
        "success": bool(summary.num_iterations >= 0),
        "initial_cost": float(summary.initial_cost),
        "final_cost": float(summary.final_cost),
        "num_iterations": int(summary.num_iterations),
    }


def _options_for(recon, vids, opts: Optional[BAOptions]) -> BAOptions:
    if opts is not None:
        return opts
    model_type = recon.views[vids[0]].camera.model_type
    return BAOptions(model_type=int(model_type), loss="trivial",
                     max_iterations=30, cg_iterations=60)


def bundle_adjust_reconstruction(recon, opts: Optional[BAOptions] = None,
                                 fix_gauge: bool = True, device="cuda",
                                 dtype=torch.float32):
    """Full BA over all estimated views/tracks
    (ref: BundleAdjustReconstruction, bundle_adjustment.h:135)."""
    return bundle_adjust_partial_reconstruction(
        recon, None, None, opts, fix_gauge=fix_gauge, device=device,
        dtype=dtype)


def bundle_adjust_partial_reconstruction(
        recon, variable_views: Optional[Iterable[int]],
        variable_tracks: Optional[Iterable[int]],
        opts: Optional[BAOptions] = None, fix_gauge: bool = True,
        device="cuda", dtype=torch.float32):
    """BA with only the given views/tracks variable; everything else in
    the problem stays constant (ref: BundleAdjustPartialReconstruction,
    bundle_adjuster.cc constant-block path). None = all variable."""
    prob, maps = recon.to_ba_problem(dtype=dtype, device=device)
    if prob.obs_pix.shape[0] == 0:
        return {"success": False, "num_iterations": 0}
    vids, tids = maps[0], maps[1]
    cam_mask = np.ones(len(vids), bool)
    if variable_views is not None:
        var = set(variable_views)
        cam_mask = np.asarray([v in var for v in vids], bool)
    if fix_gauge and cam_mask.all() and len(vids) > 0:
        cam_mask[0] = False
    pt_mask = None
    if variable_tracks is not None:
        var_t = set(variable_tracks)
        pt_mask = np.asarray([t in var_t for t in tids], bool)
    dev = prob.points.device
    prob = prob._replace(
        cam_mask=torch.as_tensor(cam_mask, device=dev),
        point_mask=None if pt_mask is None else torch.as_tensor(
            pt_mask, device=dev))
    out, summary = bundle_adjust_bucketed(prob, _options_for(recon, vids,
                                                             opts))
    recon.update_from_ba(out, maps)
    return _ba_summary_dict(summary)


def bundle_adjust_view(recon, view_id: int,
                       opts: Optional[BAOptions] = None, device="cuda",
                       dtype=torch.float32):
    """Optimize a single view's pose against fixed structure
    (ref: BundleAdjustView, bundle_adjustment.h:146)."""
    base = _options_for(recon, [view_id], opts)
    base = dataclasses.replace(base, optimize_points=False)
    return bundle_adjust_partial_reconstruction(
        recon, [view_id], None, base, fix_gauge=False, device=device,
        dtype=dtype)


def bundle_adjust_track(recon, track_id: int,
                        opts: Optional[BAOptions] = None, device="cuda",
                        dtype=torch.float32):
    """Optimize a single track's point against fixed cameras
    (ref: BundleAdjustTrack, bundle_adjustment.h:153)."""
    base = _options_for(recon, sorted(recon.estimated_views()), opts)
    base = dataclasses.replace(base, optimize_cameras=False,
                               optimize_intrinsics=(False,) * 10)
    return bundle_adjust_partial_reconstruction(
        recon, [], [track_id], base, fix_gauge=False, device=device,
        dtype=dtype)
