"""Outlier and degeneracy filters on a reconstruction (port of
theiasfm_tpu/sfm/pipeline/filters.py).

ref: src/theia/sfm/set_outlier_tracks_to_unestimated.{h,cc} (reprojection
error + triangulation angle gates) and
set_underconstrained_tracks_to_unestimated / ..._views (iterative
pruning of tracks with <2 estimated views and views with <2 estimated
tracks). The error computation is one batched device call via the
BAProblem snapshot, the angles another; each reads back once. They run
on `device` (the card unless the caller passes "cpu") in `dtype`
(float32 by default, as on the TPU).

The JAX module pairs the errors of the point-sorted, padded snapshot
(pad_ba_problem sorts the observations by point) with the observations
listed view by view, so an error is charged to another observation's
track whenever the two orders differ. This port keeps that pairing, so
both packages remove the same tracks (ROADMAP.md, queue 3).
"""
from __future__ import annotations

import numpy as np
import torch

from ...camera import models as cm
from ...utils import next_bucket
from ...utils.device import full_f32, resolve_device
from .. import triangulation as tri
from ..ba.bundle_adjustment import pad_ba_problem
from ..reconstruction import Reconstruction


def _reproj(model: int, prob):
    """Per-observation pixel error of a (padded) BAProblem; inf behind
    the camera."""
    extr = prob.extrinsics[prob.obs_cam.long()]
    intr = prob.intrinsics[prob.obs_group.long()]
    pts = prob.points[prob.obs_pt.long()]
    pix, depth = cm.project(model, extr, intr, pts)
    err = torch.linalg.norm(pix - prob.obs_pix, dim=-1)
    return torch.where(depth > 0, err, torch.full_like(err, torch.inf))


def _reprojection_errors(recon: Reconstruction, dtype=torch.float32,
                         device="cuda"):
    """Per-observation reprojection errors for estimated views+tracks.
    Returns (obs list [(vid, tid)], errors np.ndarray), paired as the
    JAX module pairs them (see the module docstring)."""
    prob, (vids, tids, groups, cam_group) = recon.to_ba_problem(
        dtype=dtype, device=device)
    if prob.obs_pix.shape[0] == 0:
        return [], np.zeros(0)
    model = recon.views[vids[0]].camera.model_type if vids else 0

    M = prob.obs_pix.shape[0]
    errors = _reproj(int(model), pad_ba_problem(prob))[:M]
    errors = errors.cpu().numpy().astype(np.float64)
    # rebuild the same (vid, tid) order used by to_ba_problem
    obs = []
    tid_set = set(tids)
    for v in vids:
        for t in recon.views[v].features:
            if t in tid_set:
                obs.append((v, t))
    return obs, errors


@full_f32()
def set_outlier_tracks_to_unestimated(
        recon: Reconstruction,
        max_reprojection_error_pixels: float = 5.0,
        min_triangulation_angle_degrees: float = 0.0,
        dtype=torch.float32, device="cuda") -> int:
    """Mark tracks with any large reprojection error (or too-small
    triangulation angle) as unestimated. Returns #tracks removed.
    ref: set_outlier_tracks_to_unestimated.cc."""
    dev = resolve_device(device)
    obs, errors = _reprojection_errors(recon, dtype, dev)
    bad_tracks = set()
    for (v, t), e in zip(obs, errors):
        if not np.isfinite(e) or e > max_reprojection_error_pixels:
            bad_tracks.add(t)

    if min_triangulation_angle_degrees > 0:
        # all (track, observing-view-origin) sets in ONE padded device
        # call
        cand = []
        for t in recon.estimated_tracks():
            if t in bad_tracks:
                continue
            tr = recon.tracks[t]
            est_views = [v for v in tr.views
                         if recon.views[v].is_estimated]
            if len(est_views) < 2:
                bad_tracks.add(t)
            else:
                cand.append((t, est_views))
        if cand:
            V = next_bucket(max(len(v) for _, v in cand), 2)
            T = next_bucket(len(cand), 8)
            origins = np.zeros((T, V, 3))
            vmask = np.zeros((T, V), bool)
            pts = np.zeros((T, 4))
            pts[:, 3] = 1.0
            pos_cache = {}
            for i, (t, views) in enumerate(cand):
                pts[i] = recon.tracks[t].point
                for j, v in enumerate(views[:V]):
                    if v not in pos_cache:
                        pos_cache[v] = recon.views[v].camera.position
                    origins[i, j] = pos_cache[v]
                    vmask[i, j] = True
            ang = tri.triangulation_angles(
                torch.as_tensor(origins, device=dev).to(dtype),
                torch.as_tensor(pts, device=dev).to(dtype),
                torch.as_tensor(vmask, device=dev)).cpu().numpy()
            for i, (t, _) in enumerate(cand):
                if ang[i] < min_triangulation_angle_degrees:
                    bad_tracks.add(t)

    for t in bad_tracks:
        recon.tracks[t].is_estimated = False
    return len(bad_tracks)


def set_underconstrained_as_unestimated(recon: Reconstruction) -> int:
    """Iteratively drop tracks with <2 estimated views and views with <2
    estimated tracks. ref: set_underconstrained_* (used at
    incremental_reconstruction_estimator.cc:273). Host only."""
    n_removed = 0
    changed = True
    while changed:
        changed = False
        for t in recon.estimated_tracks():
            tr = recon.tracks[t]
            n_est = sum(1 for v in tr.views
                        if recon.views[v].is_estimated)
            if n_est < 2:
                tr.is_estimated = False
                n_removed += 1
                changed = True
        for v in recon.estimated_views():
            view = recon.views[v]
            n_est = sum(1 for t in view.features
                        if t in recon.tracks and
                        recon.tracks[t].is_estimated)
            if n_est < 2:
                view.is_estimated = False
                n_removed += 1
                changed = True
    return n_removed
