"""Small reconstruction utilities (port of theiasfm_tpu/sfm/utils.py).

ref: src/theia/sfm/find_common_tracks_in_views.{h,cc},
find_common_views_by_name.{h,cc}, pose_error.{h,cc}. Host code over the
port's Reconstruction, in float64.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..math import rotation as rot
from .reconstruction import Reconstruction


def find_common_tracks_in_views(recon: Reconstruction,
                                view_ids: List[int]) -> List[int]:
    """Tracks observed by ALL given views (ref FindCommonTracksInViews)."""
    if not view_ids:
        return []
    common = set(recon.views[view_ids[0]].features.keys())
    for v in view_ids[1:]:
        common &= set(recon.views[v].features.keys())
    return sorted(common)


def find_common_views_by_name(recon1: Reconstruction,
                              recon2: Reconstruction) -> List[str]:
    """Image names present in both reconstructions
    (ref FindCommonViewsByName)."""
    names1 = {v.name for v in recon1.views.values()}
    names2 = {v.name for v in recon2.views.values()}
    return sorted(names1 & names2)


def alignment_and_pose_errors(recon_est: Reconstruction,
                              recon_ref: Reconstruction):
    """Robustly align est->ref on common cameras; return
    (position_errors, rotation_errors_deg) arrays over common views
    (the core of ref compare_reconstructions.cc / PoseError)."""
    from .transformation import align_reconstructions_robust
    common = find_common_views_by_name(recon_est, recon_ref)
    est_pos, ref_pos, est_aa, ref_aa = [], [], [], []
    for name in common:
        ve = recon_est.views[recon_est.view_id_from_name(name)]
        vr = recon_ref.views[recon_ref.view_id_from_name(name)]
        if not (ve.is_estimated and vr.is_estimated):
            continue
        est_pos.append(ve.camera.position)
        ref_pos.append(vr.camera.position)
        est_aa.append(ve.camera.orientation)
        ref_aa.append(vr.camera.orientation)
    if len(est_pos) < 3:
        return np.zeros(0), np.zeros(0)
    est_pos = np.stack(est_pos)
    ref_pos = np.stack(ref_pos)
    s, R, t = align_reconstructions_robust(est_pos, ref_pos)
    pos_err = np.linalg.norm(s * est_pos @ R.T + t - ref_pos, axis=1)
    R_e = rot.angle_axis_to_rotation_matrix(
        torch.as_tensor(np.asarray(est_aa, np.float64))).numpy()
    R_r = rot.angle_axis_to_rotation_matrix(
        torch.as_tensor(np.asarray(ref_aa, np.float64))).numpy()
    rot_err = []
    for Re, Rr in zip(R_e, R_r):
        E = Re @ R.T @ Rr.T
        cos = np.clip((np.trace(E) - 1) / 2, -1, 1)
        rot_err.append(np.degrees(np.arccos(cos)))
    return pos_err, np.asarray(rot_err)
