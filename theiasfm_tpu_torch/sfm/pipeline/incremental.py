"""Incremental reconstruction pipeline (port of
theiasfm_tpu/sfm/pipeline/incremental.py).

ref: src/theia/sfm/incremental_reconstruction_estimator.{h,cc}
(SURVEY.md §3.3): choose a wide-baseline initial pair, then loop
  rank unlocalized views by visible estimated tracks ->
  localize (P3P RANSAC) -> triangulate new tracks -> bundle adjust
  (partial window for small growth, full otherwise) -> filter outliers
  and underconstrained views/tracks.

The host orchestrates (graph bookkeeping); every heavy step is one
batched device call (RANSAC, N-view triangulation, Schur-PCG BA) on
`device` (the card unless the caller passes "cpu"), in `dtype`
(float32 by default, as on the TPU). The localization rounds draw their
hypotheses from one torch.Generator on the device, seeded with
`IncrementalOptions.seed` (the JAX module's PRNGKey(seed)).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Tuple

import numpy as np
import torch

from ...utils import Timer, count_dispatch, dispatch_counts
from ...utils.device import full_f32, resolve_device
from ..ba.bundle_adjustment import (BAOptions, bundle_adjust_bucketed,
                                    bundle_adjust_host_f64, pad_ba_problem)
from ..reconstruction import Reconstruction
from ..view_graph import ViewGraph
from ..visibility_pyramid import view_visibility_score
from .estimate_tracks import EstimateTracksOptions, estimate_all_tracks
from .filters import (set_outlier_tracks_to_unestimated,
                      set_underconstrained_as_unestimated)
from .localize import LocalizeOptions, localize_views_batch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class IncrementalOptions:
    """ref: ReconstructionEstimatorOptions incremental subset
    (sfm/reconstruction_estimator_options.h)."""
    max_reprojection_error_pixels: float = 5.0
    min_triangulation_angle_degrees: float = 3.0
    # full BA when the model grew by this fraction since the last one
    full_bundle_adjustment_growth_percent: float = 5.0
    partial_ba_num_views: int = 20
    min_num_two_view_inliers: int = 30
    # seed acceptance: triangulated tracks required of an initial pair
    # (ref kMinNumInitialTracks = 100,
    # incremental_reconstruction_estimator.cc:324); scenes with fewer
    # total tracks fall back to the best-scoring pair
    min_num_initial_tracks: int = 100
    # max candidate views localized per batched RANSAC round
    localize_round_size: int = 16
    localize: LocalizeOptions = LocalizeOptions()
    tracks: EstimateTracksOptions = EstimateTracksOptions()
    intrinsics_optimized: Tuple[bool, ...] = (False,) * 10
    ba_loss: str = "softl1"
    ba_loss_scale_pixels: float = 2.0
    seed: int = 0
    # re-run the FINAL full BA in float64 on the device when the
    # device is not the CPU (the reference's Ceres runs all-double;
    # see bundle_adjust_host_f64)
    final_polish_x64: bool = False


def _order_initial_pairs(recon: Reconstruction, graph: ViewGraph,
                         opts: IncrementalOptions):
    """Seed-pair ranking, reference-exact ordering: sort candidate
    edges by (num_homography_inliers asc, num_verified_matches desc,
    (v1, v2)) — the pair LEAST well modelled by a homography (widest
    baseline / least rotation-only) with the most essential-matrix
    inliers wins (ref OrderViewPairsByInitializationCriterion,
    incremental_reconstruction_estimator.cc:380-411)."""
    cands = []
    for (v1, v2), info in graph.edges().items():
        if info.num_verified_matches < opts.min_num_two_view_inliers:
            continue
        if not (recon.views[v1].is_estimated or
                recon.views[v2].is_estimated):
            cands.append((info.num_homography_inliers,
                          -info.num_verified_matches, (v1, v2)))
    cands.sort()
    return [p for _, _, p in cands]


def _initialize_from_pair(recon: Reconstruction, graph: ViewGraph,
                          pair, opts: IncrementalOptions,
                          dtype=torch.float32, device="cuda") -> int:
    """Place the seed pair and triangulate; returns #tracks estimated
    (ref InitializeCamerasFromTwoViewInfo + EstimateStructure,
    incremental_reconstruction_estimator.cc:303-352)."""
    v1, v2 = pair
    info = graph.edge(v1, v2)
    cam1 = recon.views[v1].camera
    cam2 = recon.views[v2].camera
    cam1.extrinsics = np.zeros(6)
    cam2.extrinsics = np.concatenate([
        np.asarray(info.position_2, float),
        np.asarray(info.rotation_2, float)])
    recon.views[v1].is_estimated = True
    recon.views[v2].is_estimated = True
    n = estimate_all_tracks(recon, opts.tracks, dtype=dtype, device=device)
    logger.info("initial pair (%s, %s): %d tracks", v1, v2, n)
    return n


def _run_ba(recon: Reconstruction, opts: IncrementalOptions,
            view_subset=None, polish=False, dtype=torch.float32,
            device="cuda"):
    """One BA of the estimated views and tracks through
    bundle_adjust_bucketed with the JAX module's options (the BA
    kernels stay off, as there)."""
    dev = resolve_device(device)
    prob, maps = recon.to_ba_problem(dtype=dtype, device=dev)
    if prob.obs_pix.shape[0] == 0:
        return
    vids = maps[0]
    # gauge: hold the first camera constant; scale gauge handled by LM
    # damping (the reference relies on Ceres damping the same way)
    cam_mask = np.ones(len(vids), bool)
    if len(vids) > 0:
        cam_mask[0] = False
    if view_subset is not None:
        sub = set(view_subset)
        for i, v in enumerate(vids):
            if v not in sub:
                cam_mask[i] = False
    count_dispatch("bundle_adjust")
    prob = prob._replace(cam_mask=torch.as_tensor(cam_mask, device=dev))
    model_type = recon.views[vids[0]].camera.model_type
    ba_opts = BAOptions(
        model_type=int(model_type),
        loss=opts.ba_loss,
        loss_scale=opts.ba_loss_scale_pixels,
        max_iterations=30, cg_iterations=60,
        optimize_intrinsics=tuple(opts.intrinsics_optimized))
    out, summary = bundle_adjust_bucketed(prob, ba_opts)
    recon.update_from_ba(out, maps)
    if polish and opts.final_polish_x64 and dev.type != "cpu":
        # float64 polish: the last LM iterations in double recover the
        # reference's (all-double Ceres) accuracy
        prob2, maps2 = recon.to_ba_problem(dtype=dtype, device=dev)
        if prob2.obs_pix.shape[0]:
            prob2 = prob2._replace(cam_mask=prob.cam_mask[
                :prob2.extrinsics.shape[0]])
            padded = pad_ba_problem(prob2)
            popts = dataclasses.replace(ba_opts, max_iterations=15,
                                        point_indices_sorted=True)
            out2, _ = bundle_adjust_host_f64(padded, popts)
            out2 = prob2._replace(
                extrinsics=out2.extrinsics[:prob2.extrinsics.shape[0]],
                intrinsics=out2.intrinsics[:prob2.intrinsics.shape[0]],
                points=out2.points[:prob2.points.shape[0]])
            recon.update_from_ba(out2, maps2)


@full_f32()
def incremental_reconstruction(recon: Reconstruction, graph: ViewGraph,
                               opts: IncrementalOptions = IncrementalOptions(),
                               dtype=torch.float32, device="cuda") -> Dict:
    """Run the incremental pipeline. Mutates `recon`. Returns summary
    dict (ref ReconstructionEstimatorSummary)."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    total_timer = Timer()
    dispatches_at_start = dispatch_counts()
    generator = torch.Generator(dev).manual_seed(opts.seed)

    def filter_outliers():
        set_outlier_tracks_to_unestimated(
            recon, opts.max_reprojection_error_pixels,
            opts.min_triangulation_angle_degrees, **kw)

    # resume support: if the reconstruction already has estimated views
    # (e.g. loaded from a snapshot), continue from them instead of
    # re-initializing (ref incremental_reconstruction_estimator.cc:153-156)
    if len(recon.estimated_views()) >= 2:
        estimate_all_tracks(recon, opts.tracks, **kw)
    else:
        # try ordered seed pairs until one triangulates enough tracks
        # (ref ChooseInitialViewPair, kMinNumInitialTracks = 100,
        # incremental_reconstruction_estimator.cc:323-360). Unlike the
        # reference the best-scoring attempt is kept as a fallback so
        # small scenes (< 100 tracks total) still initialize.
        pairs = _order_initial_pairs(recon, graph, opts)
        if not pairs:
            return {"success": False, "reason": "no initial pair"}

        def _reset(pair):
            for v in pair:
                recon.views[v].is_estimated = False
            for t in recon.tracks.values():
                t.is_estimated = False

        initialized = False
        best_pair, best_n = None, 0
        for pair in pairs[:20]:
            n = _initialize_from_pair(recon, graph, pair, opts, **kw)
            if n >= opts.min_num_initial_tracks:
                initialized = True
                break
            if n > best_n:
                best_pair, best_n = pair, n
            _reset(pair)
        if not initialized and best_pair is not None and best_n >= 4:
            _initialize_from_pair(recon, graph, best_pair, opts, **kw)
            initialized = True
        if not initialized:
            return {"success": False, "reason": "initialization failed"}
    _run_ba(recon, opts, **kw)
    filter_outliers()

    views_at_last_full_ba = max(len(recon.estimated_views()), 2)
    while True:
        # rank unlocalized views by visibility-pyramid score over their
        # estimated-track observations (ref FindViewsToLocalize +
        # VisibilityPyramid, visibility_pyramid.h:44-70)
        candidates = []
        for v, view in recon.views.items():
            if view.is_estimated or not graph.has_view(v):
                continue
            n_vis = sum(1 for t in view.features
                        if t in recon.tracks and
                        recon.tracks[t].is_estimated)
            if n_vis >= 4:
                candidates.append((view_visibility_score(recon, v), v))
        if not candidates:
            break
        candidates.sort(reverse=True)

        # ONE batched P3P-RANSAC localizes the whole round (the
        # reference loops LocalizeViewToReconstruction per view). The
        # round size grows with the reconstruction: early rounds (thin
        # structure) accept few poses before the next triangulate+BA,
        # mirroring the reference's per-view localize-then-refine
        # loop; once structure is dense, full rounds amortize the
        # launches. Floor of 4: small scenes localize in one round.
        n_est_now = len(recon.estimated_views())
        round_cap = max(4, min(opts.localize_round_size, n_est_now))
        round_views = [v for _, v in candidates[:round_cap]]
        results = localize_views_batch(generator, recon, round_views,
                                       opts.localize, **kw)
        newly = [v for v, ok in results.items() if ok]
        if not newly:
            break

        # ONE batched triangulation over every track touched by the
        # newly localized views (vs per-view estimate_all_tracks)
        affected = sorted({t for v in newly
                           for t in recon.views[v].features})
        estimate_all_tracks(recon, opts.tracks, track_ids=affected, **kw)

        n_est = len(recon.estimated_views())
        growth = (n_est - views_at_last_full_ba) / max(
            views_at_last_full_ba, 1) * 100.0
        if growth >= opts.full_bundle_adjustment_growth_percent:
            estimate_all_tracks(recon, opts.tracks, **kw)
            _run_ba(recon, opts, **kw)
            views_at_last_full_ba = n_est
        else:
            # the partial window must cover the whole round plus
            # context so every just-accepted pose gets refined
            recent = recon.estimated_views()[
                -max(opts.partial_ba_num_views, len(newly) + 8):]
            _run_ba(recon, opts, view_subset=recent, **kw)
        filter_outliers()
        set_underconstrained_as_unestimated(recon)

    # final pass
    estimate_all_tracks(recon, opts.tracks, **kw)
    _run_ba(recon, opts, polish=True, **kw)
    filter_outliers()
    set_underconstrained_as_unestimated(recon)
    end = dispatch_counts()
    dispatches = {k2: end.get(k2, 0) - dispatches_at_start.get(k2, 0)
                  for k2 in end
                  if end.get(k2, 0) > dispatches_at_start.get(k2, 0)}
    return {"success": True,
            "num_estimated_views": len(recon.estimated_views()),
            "num_estimated_tracks": len(recon.estimated_tracks()),
            "device_dispatches": dispatches,
            "timings": {"total_time": total_timer.elapsed_seconds()}}
