"""Batched estimation (triangulation) of all unestimated tracks (port of
theiasfm_tpu/sfm/pipeline/estimate_tracks.py).

ref: src/theia/sfm/estimate_track.{h,cc} — the reference fans per-track
triangulation onto a thread pool (estimate_track.cc:172-191); here ALL
candidate tracks triangulate in one padded device call: per-track
observing views (padded to a views bucket), masked N-view DLT, then
gates identical to the reference's: sufficient triangulation angle,
cheirality, reprojection error (estimate_track.h:55-76 options).

The host builds the padded arrays (the projection matrices of all the
views in one batched call on the CPU), makes one upload, and reads the
results back once; the device work runs on `device` (the card unless
the caller passes "cpu") in `dtype` (float32 by default, as on the
TPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...utils import count_dispatch, next_bucket
from ...utils.device import full_f32, resolve_device
from .. import triangulation as tri
from ..reconstruction import Reconstruction


@dataclasses.dataclass(frozen=True)
class EstimateTracksOptions:
    """ref: estimate_track.h EstimateTrackOptions."""
    max_acceptable_reprojection_error_pixels: float = 5.0
    min_triangulation_angle_degrees: float = 3.0
    bundle_adjust_tracks: bool = True


def _triangulate_tracks_device(Ps, origins, pixels, mask):
    """Ps (T, V, 3, 4); origins (T, V, 3); pixels (T, V, 2); mask (T, V).

    Returns X (T, 4) homogeneous, angles (T,), max reprojection err (T,),
    in_front (T,).
    """
    X = tri.triangulate_nview(Ps, pixels, mask)
    angles = tri.triangulation_angles(origins, X, mask)
    proj = (Ps @ X[:, None, :, None])[..., 0]
    depth = proj[..., 2]
    safe = torch.where(depth.abs() < 1e-12, torch.full_like(depth, 1e-12),
                       depth)
    pix = proj[..., :2] / safe[..., None]
    err = torch.linalg.norm(pix - pixels, dim=-1)
    err = torch.where(mask, err, torch.zeros_like(err))
    max_err = err.amax(dim=-1)
    in_front = torch.all((depth * torch.sign(X[:, None, 3]) > 0) | ~mask,
                         dim=-1)
    return X, angles, max_err, in_front


def _projection_matrices(cameras):
    """(V, 3, 4) float64 projection matrices of `cameras` (host
    Camera objects) in one batched call on the CPU: K from each padded
    intrinsics vector (focal, aspect, skew, principal point)."""
    extr = torch.as_tensor(np.stack([c.extrinsics for c in cameras]),
                           dtype=torch.float64)
    intr = np.stack([c.intrinsics for c in cameras]).astype(np.float64)
    K = np.zeros((len(cameras), 3, 3))
    K[:, 0, 0] = intr[:, 0]
    K[:, 1, 1] = intr[:, 0] * intr[:, 1]
    K[:, 0, 1] = intr[:, 2]
    K[:, 0, 2] = intr[:, 3]
    K[:, 1, 2] = intr[:, 4]
    K[:, 2, 2] = 1.0
    return tri.projection_matrix(extr, torch.from_numpy(K)).numpy()


@full_f32()
def estimate_all_tracks(recon: Reconstruction,
                        opts: EstimateTracksOptions,
                        track_ids=None, dtype=torch.float32,
                        device="cuda") -> int:
    """Triangulate all (or given) unestimated tracks with >= 2 estimated
    observing views. Mutates `recon`; returns #tracks estimated.
    """
    dev = resolve_device(device)
    if track_ids is None:
        track_ids = [t for t, tr in recon.tracks.items()
                     if not tr.is_estimated]
    cand = []
    for t in track_ids:
        tr = recon.tracks[t]
        est_views = [v for v in tr.views if recon.views[v].is_estimated]
        if len(est_views) >= 2:
            cand.append((t, est_views))
    if not cand:
        return 0

    max_views = next_bucket(max(len(v) for _, v in cand), minimum=2)
    T = next_bucket(len(cand), minimum=8)

    # one row per (track, observing view), then scattered into the
    # padded (T, max_views) layout
    vids = sorted({v for _, views in cand for v in views})
    vrow = {v: i for i, v in enumerate(vids)}
    rows, slots, vidx, pix = [], [], [], []
    for i, (t, views) in enumerate(cand):
        for j, v in enumerate(views[:max_views]):
            rows.append(i)
            slots.append(j)
            vidx.append(vrow[v])
            pix.append(recon.views[v].features[t])
    rows, slots, vidx = map(np.asarray, (rows, slots, vidx))
    P_views = _projection_matrices([recon.views[v].camera for v in vids])
    pos_views = np.stack([recon.views[v].camera.extrinsics[:3]
                          for v in vids])
    Ps = np.zeros((T, max_views, 3, 4))
    origins = np.zeros((T, max_views, 3))
    pixels = np.zeros((T, max_views, 2))
    mask = np.zeros((T, max_views), dtype=bool)
    Ps[rows, slots] = P_views[vidx]
    origins[rows, slots] = pos_views[vidx]
    pixels[rows, slots] = np.stack(pix)
    mask[rows, slots] = True

    def t_(x):
        return torch.as_tensor(x, device=dev).to(dtype)

    count_dispatch("triangulate_tracks")
    X, angles, max_err, in_front = _triangulate_tracks_device(
        t_(Ps), t_(origins), t_(pixels), torch.as_tensor(mask, device=dev))
    host = torch.cat([X, angles[:, None], max_err[:, None],
                      in_front[:, None].to(dtype)], dim=1)
    host = host.cpu().numpy().astype(np.float64)
    X, angles, max_err, in_front = (host[:, :4], host[:, 4], host[:, 5],
                                    host[:, 6] > 0.5)

    n_est = 0
    for i, (t, views) in enumerate(cand):
        ok = (angles[i] >= opts.min_triangulation_angle_degrees and
              max_err[i] <= opts.max_acceptable_reprojection_error_pixels
              and in_front[i] and abs(X[i, 3]) > 1e-12)
        if ok:
            tr = recon.tracks[t]
            tr.point = X[i] / X[i, 3]
            tr.is_estimated = True
            n_est += 1
    return n_est
