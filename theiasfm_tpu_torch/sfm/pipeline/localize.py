"""Localize a view against the current reconstruction (2D-3D RANSAC;
port of theiasfm_tpu/sfm/pipeline/localize.py).

ref: src/theia/sfm/localize_view_to_reconstruction.{h,cc} — collect
2D-3D matches from estimated tracks observed by the view, run P3P
RANSAC (calibrated path) with reprojection threshold, then single-view
refinement (the reference's BundleAdjustView; here the batched GN from
estimators/absolute_pose.py, applied inside the RANSAC refine step).

Where the JAX module takes a PRNG key these take `samples`: a
torch.Generator or precomputed sample indices, on `device`, where they
run (the card unless the caller passes "cpu"), in `dtype` (float32 by
default, as on the TPU) under full float32 matrix products.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ...solvers import RansacOptions, ransac_batch
from ...utils import count_dispatch, next_bucket
from ...utils.device import full_f32
from ..estimators.absolute_pose import (absolute_pose_spec,
                                        estimate_calibrated_absolute_pose)
from ..reconstruction import Reconstruction
from .twoview import samples_on, scaled_residuals


@dataclasses.dataclass(frozen=True)
class LocalizeOptions:
    """ref: localize_view_to_reconstruction.h:49-88."""
    reprojection_error_threshold_pixels: float = 4.0
    min_num_inliers: int = 30
    num_hypotheses: int = 256
    bundle_adjust_view: bool = True


def _matches_2d3d(recon: Reconstruction, view_id: int,
                  opts: LocalizeOptions):
    """The view's observations of estimated tracks as (world (N, 3),
    normalized image coords (N, 2), squared normalized threshold), or
    None with fewer than max(min_num_inliers, 4) of them."""
    view = recon.views[view_id]
    cam = view.camera
    world, image = [], []
    for t, feat in view.features.items():
        tr = recon.tracks.get(t)
        if tr is not None and tr.is_estimated:
            world.append(tr.xyz())
            image.append(feat)
    if len(world) < max(opts.min_num_inliers, 4):
        return None
    focal = cam.intrinsics[0]
    pp = cam.intrinsics[3:5]
    norm = (np.stack(image) - pp) / focal  # pinhole, no distortion
    thresh = (opts.reprojection_error_threshold_pixels / focal) ** 2
    return np.stack(world), norm, thresh


@full_f32()
def localize_view(samples, recon: Reconstruction, view_id: int,
                  opts: LocalizeOptions, dtype=torch.float32,
                  device="cuda") -> bool:
    """Attempt to localize `view_id`; `samples` is a torch.Generator or
    (H, 3) indices into the view's 2D-3D matches padded to a bucket of
    64. On success sets camera pose and is_estimated; returns
    success."""
    dev = samples_on(samples, device)
    m = _matches_2d3d(recon, view_id, opts)
    if m is None:
        return False
    world, norm, thresh = m
    ropts = RansacOptions(error_thresh=float(thresh),
                          num_hypotheses=opts.num_hypotheses)
    count_dispatch("localize")
    out = estimate_calibrated_absolute_pose(
        samples, torch.as_tensor(world, dtype=dtype, device=dev),
        torch.as_tensor(norm, dtype=dtype, device=dev), ropts)
    host = torch.cat([out["extrinsics"],
                      out["num_inliers"][None].to(dtype)]).cpu().numpy()
    if int(host[6]) < opts.min_num_inliers:
        return False
    view = recon.views[view_id]
    view.camera.extrinsics = host[:6].astype(float)
    view.is_estimated = True
    return True


class LocalizeBatch(NamedTuple):
    """The padded (V, N) 2D-3D matches of the views a round localizes:
    the views with enough matches, in the order asked."""
    view_ids: List[int]
    world: np.ndarray    # (V, N, 3), unit-depth points in the padding
    image: np.ndarray    # (V, N, 2) normalized coords
    mask: np.ndarray     # (V, N) bool
    thresh: np.ndarray   # (V,) squared normalized thresholds


def prepare_localize_batch(recon: Reconstruction, view_ids: List[int],
                           opts: LocalizeOptions
                           ) -> Optional[LocalizeBatch]:
    """The host side of localize_views_batch: None when no view has
    enough matches. N is a bucket of 64."""
    prepared = []
    for vid in view_ids:
        m = _matches_2d3d(recon, vid, opts)
        if m is not None:
            prepared.append((vid,) + m)
    if not prepared:
        return None
    V = len(prepared)
    N = next_bucket(max(len(w) for _, w, _, _ in prepared), 64)
    world = np.zeros((V, N, 3))
    world[..., 2] = 1.0  # benign pad geometry (unit-depth points)
    image = np.zeros((V, N, 2))
    mask = np.zeros((V, N), bool)
    thresh = np.zeros(V)
    for i, (_, w, im, th) in enumerate(prepared):
        n = len(w)
        world[i, :n] = w
        image[i, :n] = im
        mask[i, :n] = True
        thresh[i] = th
    return LocalizeBatch([p[0] for p in prepared], world, image, mask,
                         thresh)


@full_f32()
def localize_views_batch(samples, recon: Reconstruction,
                         view_ids: List[int], opts: LocalizeOptions,
                         dtype=torch.float32,
                         device="cuda") -> Dict[int, bool]:
    """Localize MANY candidate views in ONE batched RANSAC.

    The reference runs LocalizeViewToReconstruction once per candidate
    in the incremental loop (incremental_reconstruction_estimator.cc:222);
    here all candidates' 2D-3D match sets pad into a (V, N) rectangle
    (prepare_localize_batch), go to the device in one upload, and one
    ransac_batch localizes the whole round; per-view thresholds ride as
    a residual pre-scale so one engine threshold of 1 serves every view.
    `samples`: a torch.Generator or (V, H, 3) indices, V the views with
    enough matches. On success sets camera pose + is_estimated; returns
    {view_id: success}."""
    dev = samples_on(samples, device)
    batch = prepare_localize_batch(recon, view_ids, opts)
    if batch is None:
        return {}

    def t(x):
        return torch.as_tensor(x, device=dev)

    spec = scaled_residuals(absolute_pose_spec(),
                            t(batch.thresh).to(dtype))
    ropts = RansacOptions(error_thresh=1.0,
                          num_hypotheses=opts.num_hypotheses)
    count_dispatch("localize_batch")
    extr, summary = ransac_batch(
        samples, spec, {"world": t(batch.world).to(dtype),
                        "image": t(batch.image).to(dtype)}, ropts,
        data_mask=t(batch.mask))
    host = torch.cat([extr, summary.num_inliers[:, None].to(dtype)],
                     dim=1).cpu().numpy()

    results: Dict[int, bool] = {}
    for i, vid in enumerate(batch.view_ids):
        ok = int(host[i, 6]) >= opts.min_num_inliers
        results[vid] = ok
        if ok:
            recon.views[vid].camera.extrinsics = host[i, :6].astype(float)
            recon.views[vid].is_estimated = True
    return results
