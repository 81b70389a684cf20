"""Hybrid reconstruction: global rotation averaging + incremental
position/structure estimation (port of
theiasfm_tpu/sfm/pipeline/hybrid.py).

ref: src/theia/sfm/hybrid_reconstruction_estimator.{h,cc}:55,100-175
(Sweeney's hybrid method): camera orientations come from robust global
rotation averaging (drift-free), positions and structure grow
incrementally using known-orientation localization — the
2-point position solver (ref sfm/pose/position_from_two_rays.h and
relative_pose_from_two_points_with_known_rotation.h family).

Every batched step runs on `device` (the card unless the caller passes
"cpu") in `dtype` (float32 by default) under full float32 matrix
products. Where the JAX module splits a PRNG key per localization
round, this draws every round's hypotheses from one torch.Generator on
the device, seeded with `HybridOptions.seed`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ...solvers import MinimalSolverSpec, RansacOptions, ransac_batch
from ...utils import count_dispatch, linalg, next_bucket
from ...utils.device import full_f32, resolve_device
from ..global_pose import (RobustRotationOptions, orientations_from_mst,
                           robust_rotation_averaging)
from ..global_pose.rotation_averaging import _host_rotations
from ..reconstruction import Reconstruction
from ..view_graph import ViewGraph
from .estimate_tracks import estimate_all_tracks
from .filters import (set_outlier_tracks_to_unestimated,
                      set_underconstrained_as_unestimated)
from .incremental import IncrementalOptions, _order_initial_pairs, _run_ba
from .localize import LocalizeOptions
from .twoview import samples_on, scaled_residuals


@dataclasses.dataclass(frozen=True)
class HybridOptions:
    rotation: RobustRotationOptions = RobustRotationOptions()
    rotation_filtering_max_difference_degrees: float = 10.0
    incremental: IncrementalOptions = IncrementalOptions()
    seed: int = 0


def _position_residual_vec(c, world, image, R, w):
    """Weighted normalized reprojection residuals (2N,) of one position
    c (3,) with the rotation R (3, 3) fixed."""
    p_cam = (world - c) @ R.T
    z = torch.clamp(p_cam[:, 2], min=1e-6)
    proj = p_cam[:, :2] / z[:, None]
    return ((proj - image) * w[:, None]).reshape(-1)


def position_from_rays_data_spec() -> MinimalSolverSpec:
    """Known-rotation 2-point position RANSAC estimator.

    Data: {"world": (B, N, 3), "image": (B, N, 2) normalized, "R":
    (B, N, 3, 3) the FIXED camera rotation replicated per row, so the
    spec stays row-sampleable and one batch serves views with different
    orientations}. Only the position c (3,) is estimated: world ray
    direction d_i = R^T [x_i, 1]; c is the point minimizing the distance
    to the two lines {X_i - s d_i}.
    ref: position_from_two_rays.h semantics.
    """
    def solve(d):
        R = d["R"][..., 0, :, :]             # (..., 3, 3)
        X = d["world"]                       # (..., 2, 3)
        xh = torch.cat([d["image"], torch.ones_like(d["image"][..., :1])],
                       dim=-1)
        dirs = xh @ R                        # R^T applied to rays
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        # least-squares point closest to both back-projected lines
        eye = torch.eye(3, dtype=X.dtype, device=X.device)
        A_v = eye - dirs[..., :, None] * dirs[..., None, :]
        b_v = (A_v @ X[..., None])[..., 0]
        A = torch.sum(A_v, dim=-3) + 1e-9 * eye
        b = torch.sum(b_v, dim=-2)
        c = linalg.solve(A, b[..., None])[..., 0]
        return c[..., None, :], torch.ones(c.shape[:-1] + (1,),
                                           dtype=torch.bool,
                                           device=c.device)

    def residuals(M, d):
        # M (B, C, 3) against data (B, N, k) -> (B, C, N)
        R = d["R"][:, 0]                                     # (B, 3, 3)
        p_cam = (d["world"][:, None] - M[:, :, None, :]) @ \
            R.transpose(-1, -2)[:, None]
        z = p_cam[..., 2]
        bad = z < 1e-6
        proj = p_cam[..., :2] / torch.where(bad, torch.ones_like(z),
                                            z)[..., None]
        err = torch.sum((proj - d["image"][:, None]) ** 2, dim=-1)
        return torch.where(bad, torch.full_like(err, 1e12), err)

    def refine(c, d, w):
        # weighted GN on position only (3 params), batched over B
        R = d["R"][:, 0]
        args = (d["world"], d["image"], R, w)
        res_b = torch.func.vmap(_position_residual_vec)
        jac_b = torch.func.vmap(torch.func.jacfwd(_position_residual_vec))
        eye = 1e-10 * torch.eye(3, dtype=c.dtype, device=c.device)
        for _ in range(6):
            r = res_b(c, *args)                              # (B, 2N)
            J = jac_b(c, *args)                              # (B, 2N, 3)
            Jt = J.transpose(1, 2)
            delta = linalg.solve(Jt @ J + eye, Jt @ r[..., None])[..., 0]
            c_new = c - delta
            better = (torch.sum(res_b(c_new, *args) ** 2, dim=-1) <
                      torch.sum(r ** 2, dim=-1))
            c = torch.where(better[:, None], c_new, c)
        return c

    return MinimalSolverSpec("position_from_rays", 2, 1, solve,
                             residuals, refine)


class KnownOrientationBatch(NamedTuple):
    """The padded (V, N) 2D-3D matches of the views a round localizes:
    the views with enough matches, in the order asked."""
    view_ids: List[int]
    world: np.ndarray    # (V, N, 3), unit-depth points in the padding
    image: np.ndarray    # (V, N, 2) normalized coords
    R: np.ndarray        # (V, 3, 3) the views' fixed rotations
    mask: np.ndarray     # (V, N) bool
    thresh: np.ndarray   # (V,) squared normalized thresholds


def prepare_known_orientation_batch(recon: Reconstruction, view_ids,
                                    opts: LocalizeOptions
                                    ) -> Optional[KnownOrientationBatch]:
    """The host side of localize_views_known_orientation_batch: None
    when no view has enough matches. N is a bucket of 64."""
    prepared = []
    for vid in view_ids:
        view = recon.views[vid]
        cam = view.camera
        world, image = [], []
        for t, feat in view.features.items():
            tr = recon.tracks.get(t)
            if tr is not None and tr.is_estimated:
                world.append(tr.xyz())
                image.append(feat)
        if len(world) < max(opts.min_num_inliers, 3):
            continue
        focal = cam.intrinsics[0]
        pp = cam.intrinsics[3:5]
        norm = (np.stack(image) - pp) / focal
        thresh = (opts.reprojection_error_threshold_pixels / focal) ** 2
        R = _host_rotations(cam.extrinsics[3:6])
        prepared.append((vid, np.stack(world), norm, R, thresh))
    if not prepared:
        return None

    V = len(prepared)
    N = next_bucket(max(len(w) for _, w, _, _, _ in prepared), 64)
    world = np.zeros((V, N, 3))
    world[..., 2] = 1.0
    image = np.zeros((V, N, 2))
    Rs = np.zeros((V, 3, 3))
    mask = np.zeros((V, N), bool)
    thresh = np.zeros(V)
    for i, (vid, w, im, R, th) in enumerate(prepared):
        n = len(w)
        world[i, :n] = w
        image[i, :n] = im
        Rs[i] = R
        mask[i, :n] = True
        thresh[i] = th
    return KnownOrientationBatch([p[0] for p in prepared], world, image,
                                 Rs, mask, thresh)


@full_f32()
def localize_views_known_orientation_batch(
        samples, recon: Reconstruction, view_ids, opts: LocalizeOptions,
        dtype=torch.float32, device="cuda"):
    """Known-orientation localization of MANY views in ONE batched
    RANSAC (ref localize_view_to_reconstruction.h option
    assume_known_orientation; per-round batching replaces the
    reference's per-view calls); per-view thresholds ride as a residual
    pre-scale. `samples`: a torch.Generator or (V, H, 2) indices, V the
    views with enough matches. Returns {view_id: success}."""
    dev = samples_on(samples, device)
    batch = prepare_known_orientation_batch(recon, view_ids, opts)
    if batch is None:
        return {}

    def t(x):
        return torch.as_tensor(x, device=dev).to(dtype)

    V, N = batch.mask.shape
    spec = scaled_residuals(position_from_rays_data_spec(), t(batch.thresh))
    ropts = RansacOptions(error_thresh=1.0,
                          num_hypotheses=opts.num_hypotheses)
    count_dispatch("localize_known_orientation_batch")
    c, summary = ransac_batch(
        samples, spec,
        {"world": t(batch.world), "image": t(batch.image),
         "R": t(batch.R)[:, None].expand(V, N, 3, 3)}, ropts,
        data_mask=torch.as_tensor(batch.mask, device=dev))
    host = torch.cat([c, summary.num_inliers[:, None].to(dtype)],
                     dim=1).cpu().numpy()

    results = {}
    for i, vid in enumerate(batch.view_ids):
        ok = int(host[i, 3]) >= opts.min_num_inliers
        results[vid] = ok
        if ok:
            recon.views[vid].camera.extrinsics[:3] = host[i, :3]
            recon.views[vid].is_estimated = True
    return results


@full_f32()
def hybrid_reconstruction(recon: Reconstruction, graph: ViewGraph,
                          opts: HybridOptions = HybridOptions(),
                          dtype=torch.float32, device="cuda") -> Dict:
    """Run the hybrid pipeline. Mutates recon."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    generator = torch.Generator(dev).manual_seed(opts.seed)
    # 1. global rotations
    vids = graph.view_ids()
    if len(vids) < 3:
        return {"success": False, "reason": "graph too small"}
    vid_idx = {v: i for i, v in enumerate(vids)}
    edges, rel_rot, weights = [], [], []
    for (v1, v2), info in graph.edges().items():
        edges.append((vid_idx[v1], vid_idx[v2]))
        rel_rot.append(np.asarray(info.rotation_2, float))
        weights.append(float(info.num_verified_matches))
    edges = np.asarray(edges)
    rel_rot = np.asarray(rel_rot)
    weights = np.asarray(weights)
    init = orientations_from_mst(len(vids), edges, rel_rot, weights)
    orientations = robust_rotation_averaging(init, edges, rel_rot,
                                             opts.rotation, **kw)
    for v in vids:
        recon.views[v].camera.extrinsics[3:6] = orientations[vid_idx[v]]

    # 2. incremental positions with known orientations
    iopts = opts.incremental
    pairs = _order_initial_pairs(recon, graph, iopts)
    if not pairs:
        return {"success": False, "reason": "no initial pair"}
    v1, v2 = pairs[0]
    info = graph.edge(v1, v2)
    # place pair using the averaged rotations + pairwise translation
    R1 = _host_rotations(recon.views[v1].camera.extrinsics[3:6])
    recon.views[v1].camera.extrinsics[:3] = 0.0
    t_world = R1.T @ np.asarray(info.position_2, float)
    recon.views[v2].camera.extrinsics[:3] = t_world
    recon.views[v1].is_estimated = True
    recon.views[v2].is_estimated = True
    estimate_all_tracks(recon, iopts.tracks, **kw)
    _run_ba(recon, iopts, **kw)

    while True:
        candidates = []
        for v, view in recon.views.items():
            if view.is_estimated or not graph.has_view(v):
                continue
            n_vis = sum(1 for t in view.features
                        if t in recon.tracks and
                        recon.tracks[t].is_estimated)
            if n_vis >= 3:
                candidates.append((n_vis, v))
        if not candidates:
            break
        candidates.sort(reverse=True)
        round_views = [v for _, v in
                       candidates[:iopts.localize_round_size]]
        results = localize_views_known_orientation_batch(
            generator, recon, round_views, iopts.localize, **kw)
        if not any(results.values()):
            break
        estimate_all_tracks(recon, iopts.tracks, **kw)
        _run_ba(recon, iopts, **kw)
        set_outlier_tracks_to_unestimated(
            recon, iopts.max_reprojection_error_pixels,
            iopts.min_triangulation_angle_degrees, **kw)
        set_underconstrained_as_unestimated(recon)

    estimate_all_tracks(recon, iopts.tracks, **kw)
    _run_ba(recon, iopts, polish=True, **kw)
    set_outlier_tracks_to_unestimated(
        recon, iopts.max_reprojection_error_pixels,
        iopts.min_triangulation_angle_degrees, **kw)
    set_underconstrained_as_unestimated(recon)
    return {"success": True,
            "num_estimated_views": len(recon.estimated_views()),
            "num_estimated_tracks": len(recon.estimated_tracks())}
