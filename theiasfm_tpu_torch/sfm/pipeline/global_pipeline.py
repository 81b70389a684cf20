"""Global reconstruction pipeline (port of
theiasfm_tpu/sfm/pipeline/global_pipeline.py).

ref: src/theia/sfm/global_reconstruction_estimator.cc:121-295 — the
10-step global SfM pipeline:
  1. filter initial view graph  2. calibrate from priors
  3. global rotation averaging (MST init + robust L1-IRLS)
  4. orientation-based edge filter  5. pairwise translation refinement
  6. 1DSfM relative-translation filter  7. position estimation
  8. structure (batched triangulation)  9. Schur-PCG BA
  10. retriangulation iterations with outlier rejection.

The host orchestrates (graph bookkeeping, the MFAS orderings, the LUD's
sparse Cholesky); every batched step runs on `device` (the card unless
the caller passes "cpu") in `dtype` (float32 by default, as on the TPU)
under full float32 matrix products, but for step 5, which solves in
float64 (`_refine_relative_translations`). The steps run under the
profiler ranges global.rotations (3), global.filters (2b, 4, 6 and the
rigid subgraph), global.positions (5, 7), global.triangulate, global.ba
and global.filter_tracks, which chip_smoke.py reads for its time
breakdown; the summary's stage timings are the JAX module's.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from ...utils import Timer
from ...utils.device import full_f32, resolve_device
from ..ba.bundle_adjustment import (BAOptions, bundle_adjust_bucketed,
                                    bundle_adjust_host_f64, pad_ba_problem)
from ..ba.two_view import optimize_relative_position_with_known_rotation
from ..global_pose import (PositionEstimatorOptions, RobustRotationOptions,
                           estimate_positions_lud,
                           estimate_positions_nonlinear,
                           filter_view_pairs_from_orientation,
                           filter_view_pairs_from_relative_translation,
                           linear_rotation_averaging,
                           nonlinear_rotation_averaging,
                           orientations_from_mst,
                           robust_rotation_averaging)
from ..global_pose.cycle_filter import filter_view_graph_cycles_by_rotation
from ..global_pose.linear_position import estimate_positions_linear_triplet
from ..global_pose.rigid_subgraph import (
    extract_maximally_parallel_rigid_subgraph)
from ..global_pose.rotation_averaging import _host_rotations
from ..reconstruction import Reconstruction
from ..view_graph import ViewGraph
from .estimate_tracks import EstimateTracksOptions, estimate_all_tracks
from .filters import (set_outlier_tracks_to_unestimated,
                      set_underconstrained_as_unestimated)
from .select_good_tracks import select_good_tracks_for_bundle_adjustment

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class GlobalOptions:
    """ref: ReconstructionEstimatorOptions global subset."""
    min_num_two_view_inliers: int = 30
    # ref: FilterViewGraphCyclesByRotation before rotation averaging
    filter_cycles_by_rotation: bool = True
    cycle_max_loop_error_degrees: float = 5.0
    rotation_filtering_max_difference_degrees: float = 5.0
    # 'nonlinear' | 'lud' | 'linear_triplet'
    # (ref: GlobalPositionEstimatorType; the reference DEFAULT is
    # LEAST_UNSQUARED_DEVIATION, reconstruction_estimator_options.h:90
    # — the convex LUD has no spurious minima, unlike the chordal
    # nonlinear objective which can fold chain scenes; measured on
    # fountain-11: LUD position error 0.1-0.5% of baseline vs 3-13%
    # for the chordal GN)
    position_estimator: str = "lud"
    # 'robust_l1l2' | 'nonlinear' | 'linear'
    # (ref: GlobalRotationEstimatorType{ROBUST_L1L2, NONLINEAR, LINEAR})
    rotation_estimator: str = "robust_l1l2"
    refine_relative_translations: bool = True
    extract_maximal_rigid_subgraph: bool = False
    filter_relative_translations: bool = True
    num_retriangulation_iterations: int = 1
    max_reprojection_error_pixels: float = 5.0
    min_triangulation_angle_degrees: float = 3.0
    rotation: RobustRotationOptions = RobustRotationOptions()
    position: PositionEstimatorOptions = PositionEstimatorOptions()
    tracks: EstimateTracksOptions = EstimateTracksOptions()
    intrinsics_optimized: tuple = (False,) * 10
    # ref: subsample_tracks_for_bundle_adjustment option
    subsample_tracks_for_ba: bool = False
    track_subset_grid_cell_size: int = 100
    # ref: track_subset_selection_long_track_length_threshold,
    #      min_num_optimized_tracks_per_view
    track_subset_long_track_length_threshold: int = 10
    min_num_optimized_tracks_per_view: int = 100
    ba_loss: str = "softl1"
    ba_loss_scale_pixels: float = 2.0
    # optional f64 host polish after the final BA (off: measured no
    # effect on fountain-11; expensive at 1DSfM scale on CPU)
    final_polish_x64: bool = False


def _graph_arrays(graph: ViewGraph):
    """(edges (E,2) by view id, rel_rot (E,3), rel_pos (E,3), weights)."""
    edges, rel_rot, rel_pos, w = [], [], [], []
    for (v1, v2), info in graph.edges().items():
        edges.append((v1, v2))
        rel_rot.append(np.asarray(info.rotation_2, float))
        p = np.asarray(info.position_2, float)
        n = np.linalg.norm(p)
        rel_pos.append(p / n if n > 1e-12 else p)
        w.append(float(info.num_verified_matches))
    return (np.asarray(edges), np.asarray(rel_rot), np.asarray(rel_pos),
            np.asarray(w))


def _run_ba(recon: Reconstruction, opts: GlobalOptions, polish=False,
            dtype=torch.float32, device="cuda"):
    """One BA of the estimated views and tracks through
    bundle_adjust_bucketed with the JAX module's options: 100 LM
    iterations of 80 CG, no camera held fixed, and the BA kernels off
    (BAOptions' default, as in JAX)."""
    dev = resolve_device(device)
    track_subset = None
    if opts.subsample_tracks_for_ba:
        track_subset = select_good_tracks_for_bundle_adjustment(
            recon,
            long_track_length_threshold=opts
            .track_subset_long_track_length_threshold,
            image_grid_cell_size_pixels=opts
            .track_subset_grid_cell_size,
            min_num_optimized_tracks_per_view=opts
            .min_num_optimized_tracks_per_view, dtype=dtype, device=dev)
    prob, maps = recon.to_ba_problem(track_subset=track_subset,
                                     dtype=dtype, device=dev)
    if prob.obs_pix.shape[0] == 0:
        return
    vids = maps[0]
    model_type = recon.views[vids[0]].camera.model_type
    ba_opts = BAOptions(
        model_type=int(model_type), loss=opts.ba_loss,
        loss_scale=opts.ba_loss_scale_pixels,
        max_iterations=100, cg_iterations=80,
        optimize_intrinsics=tuple(opts.intrinsics_optimized))
    out, summary = bundle_adjust_bucketed(prob, ba_opts)
    recon.update_from_ba(out, maps)
    logger.info("BA: cost %.4g -> %.4g (%d iters)",
                float(summary.initial_cost), float(summary.final_cost),
                int(summary.num_iterations))
    if polish and opts.final_polish_x64 and dev.type != "cpu":
        # float64 polish (see bundle_adjust_host_f64): recovers the
        # reference's all-double Ceres accuracy
        prob2, maps2 = recon.to_ba_problem(track_subset=track_subset,
                                           dtype=dtype, device=dev)
        if prob2.obs_pix.shape[0]:
            padded = pad_ba_problem(prob2)
            popts = dataclasses.replace(ba_opts, max_iterations=15,
                                        point_indices_sorted=True)
            out2, _ = bundle_adjust_host_f64(padded, popts)
            out2 = prob2._replace(
                extrinsics=out2.extrinsics[:prob2.extrinsics.shape[0]],
                intrinsics=out2.intrinsics[:prob2.intrinsics.shape[0]],
                points=out2.points[:prob2.points.shape[0]])
            recon.update_from_ba(out2, maps2)


def _refine_relative_translations(recon, vid_idx, orientations, edges,
                                  rel_pos, max_corrs: int = 64,
                                  device="cuda"):
    """Batched step-5 refinement: common-track correspondences per edge
    (a host loop), padded to (E, K), then one batched GN on the
    epipolar translation constraint on `device` (JAX's vmap).

    The GN runs in float64 whatever the pipeline's dtype: its normal
    matrix is singular along t up to a 1e-10 damping, which float32
    cannot resolve, so a float32 solve moves t by rounding noise and the
    model that follows is not a function of its input (ROADMAP queue
    3). The batch is (E, K) 3-vectors, so float64 costs nothing here."""
    dev = resolve_device(device)
    E = len(edges)
    K = max_corrs
    x1 = np.zeros((E, K, 2))
    x2 = np.zeros((E, K, 2))
    w = np.zeros((E, K))
    R = _host_rotations(orientations)
    R1 = np.zeros((E, 3, 3))
    R2 = np.zeros((E, 3, 3))
    any_corr = np.zeros(E, bool)
    for e, (v1, v2) in enumerate(edges):
        v1, v2 = int(v1), int(v2)
        view1, view2 = recon.views[v1], recon.views[v2]
        cam1, cam2 = view1.camera, view2.camera
        common = [t for t in view1.features if t in view2.features]
        if len(common) < 8:
            R1[e] = np.eye(3)
            R2[e] = np.eye(3)
            continue
        if len(common) > K:
            common = common[:K]
        f1 = np.stack([view1.features[t] for t in common])
        f2 = np.stack([view2.features[t] for t in common])
        x1[e, :len(common)] = (f1 - cam1.intrinsics[3:5]) / \
            cam1.intrinsics[0]
        x2[e, :len(common)] = (f2 - cam2.intrinsics[3:5]) / \
            cam2.intrinsics[0]
        w[e, :len(common)] = 1.0
        R1[e] = R[vid_idx[v1]]
        R2[e] = R[vid_idx[v2]]
        any_corr[e] = True

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    refined = optimize_relative_position_with_known_rotation(
        t(rel_pos), t(R1), t(R2), t(x1), t(x2), t(w))
    refined = refined.cpu().numpy().astype(np.float64)
    return np.where(any_corr[:, None], refined, rel_pos)


@full_f32()
def global_reconstruction(recon: Reconstruction, graph: ViewGraph,
                          opts: GlobalOptions = GlobalOptions(),
                          dtype=torch.float32, device="cuda") -> Dict:
    """Run the global pipeline. Mutates recon. Returns summary dict with
    per-stage timings (ref ReconstructionEstimatorSummary,
    global_reconstruction_estimator.cc:75-83)."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    timings: Dict[str, float] = {}
    total_timer = Timer()
    stage_timer = Timer()
    # 1. initial filter: min inliers + largest CC
    for (v1, v2), info in list(graph.edges().items()):
        if info.num_verified_matches < opts.min_num_two_view_inliers:
            graph.remove_edge(v1, v2)
    graph.remove_disconnected_views()
    if graph.num_views() < 3:
        return {"success": False, "reason": "view graph too small"}

    # 2b. triplet rotation-cycle consistency filter
    if opts.filter_cycles_by_rotation:
        with record_function("global.filters"):
            n_cyc = filter_view_graph_cycles_by_rotation(
                graph, opts.cycle_max_loop_error_degrees, **kw)
            graph.remove_disconnected_views()
        logger.info("cycle filter removed %d edges", n_cyc)
        if graph.num_views() < 3:
            return {"success": False,
                    "reason": "cycle filter emptied graph"}

    # 3. rotations
    vids = graph.view_ids()
    vid_idx = {v: i for i, v in enumerate(vids)}
    edges, rel_rot, rel_pos, weights = _graph_arrays(graph)
    e_idx = np.asarray([[vid_idx[a], vid_idx[b]] for a, b in edges])
    stage_timer.reset()
    with record_function("global.rotations"):
        if opts.rotation_estimator == "linear":
            orientations = linear_rotation_averaging(
                len(vids), e_idx, rel_rot, weights, **kw)
        else:
            init = orientations_from_mst(len(vids), e_idx, rel_rot,
                                         weights)
            if opts.rotation_estimator == "nonlinear":
                orientations = nonlinear_rotation_averaging(
                    init, e_idx, rel_rot, **kw)
            else:  # robust_l1l2 (default)
                orientations = robust_rotation_averaging(
                    init, e_idx, rel_rot, opts.rotation, **kw)
    timings["rotation_estimation_time"] = stage_timer.elapsed_seconds()

    # 4. rotation filter + re-extract largest CC
    with record_function("global.filters"):
        keep = filter_view_pairs_from_orientation(
            orientations, e_idx, rel_rot,
            opts.rotation_filtering_max_difference_degrees, **kw)
        for (v1, v2), k in zip(edges, keep):
            if not k:
                graph.remove_edge(int(v1), int(v2))
        removed = graph.remove_disconnected_views()
    logger.info("rotation filter: dropped %d edges, %d views",
                int((~keep).sum()), len(removed))

    vids = graph.view_ids()
    if len(vids) < 3:
        return {"success": False, "reason": "rotation filter emptied graph"}
    orientations = orientations[[vid_idx[v] for v in vids]]
    vid_idx = {v: i for i, v in enumerate(vids)}
    edges, rel_rot, rel_pos, weights = _graph_arrays(graph)
    e_idx = np.asarray([[vid_idx[a], vid_idx[b]] for a, b in edges])

    # 5. pairwise translation refinement with known rotations
    # (ref OptimizePairwiseTranslations,
    #  global_reconstruction_estimator.cc:372-379)
    if opts.refine_relative_translations and len(edges) > 0:
        with record_function("global.positions"):
            rel_pos = _refine_relative_translations(
                recon, vid_idx, orientations, edges, rel_pos, device=dev)
            for (v1, v2), p in zip(edges, rel_pos):
                graph.edge(int(v1), int(v2)).position_2 = p

    # 6a. optional parallel-rigid subgraph extraction
    # (ref ExtractMaximallyParallelRigidSubgraph,
    #  global_reconstruction_estimator.cc:381-402)
    if opts.extract_maximal_rigid_subgraph and len(edges) > 3:
        orient_map = {v: orientations[vid_idx[v]] for v in vids}
        with record_function("global.filters"):
            n_rm = extract_maximally_parallel_rigid_subgraph(orient_map,
                                                             graph)
        if n_rm:
            logger.info("rigid subgraph removed %d views", n_rm)
            graph.remove_disconnected_views()
            vids2 = graph.view_ids()
            if len(vids2) < 3:
                return {"success": False,
                        "reason": "rigid subgraph emptied graph"}
            orientations = orientations[[vid_idx[v] for v in vids2]]
            vids = vids2
            vid_idx = {v: i for i, v in enumerate(vids)}
            edges, rel_rot, rel_pos, weights = _graph_arrays(graph)
            e_idx = np.asarray([[vid_idx[a], vid_idx[b]]
                                for a, b in edges])

    # 6. 1DSfM translation filter
    if opts.filter_relative_translations and len(edges) > 3:
        with record_function("global.filters"):
            keep = filter_view_pairs_from_relative_translation(
                orientations, e_idx, rel_pos, **kw)
        if keep.sum() >= 3:
            for (v1, v2), k in zip(edges, keep):
                if not k:
                    graph.remove_edge(int(v1), int(v2))
            graph.remove_disconnected_views()
            vids2 = graph.view_ids()
            orientations = orientations[[vid_idx[v] for v in vids2]]
            vids = vids2
            vid_idx = {v: i for i, v in enumerate(vids)}
            edges, rel_rot, rel_pos, weights = _graph_arrays(graph)
            e_idx = np.asarray([[vid_idx[a], vid_idx[b]]
                                for a, b in edges])

    # 7. positions
    stage_timer.reset()
    pos_covered = np.ones(len(vids), dtype=bool)
    with record_function("global.positions"):
        if opts.position_estimator == "linear_triplet":
            positions, pos_covered = estimate_positions_linear_triplet(
                recon, vids, orientations, e_idx, rel_pos, **kw)
        else:
            est = (estimate_positions_lud
                   if opts.position_estimator == "lud"
                   else estimate_positions_nonlinear)
            positions = est(orientations, e_idx, rel_pos,
                            edge_weights=weights / weights.max(),
                            opts=opts.position, **kw)
    if opts.position_estimator == "linear_triplet" and \
            not pos_covered.any():
        return {"success": False,
                "reason": "no valid triplets for linear positions"}
    timings["position_estimation_time"] = stage_timer.elapsed_seconds()

    # write poses into the reconstruction (linear_triplet only covers
    # views inside the triplet graph, ref
    # linear_position_estimator.cc:209-218)
    for v in vids:
        i = vid_idx[v]
        if not pos_covered[i]:
            continue
        view = recon.views[v]
        view.camera.extrinsics = np.concatenate(
            [positions[i], orientations[i]])
        view.is_estimated = True

    # 8-10: structure + BA + retriangulation loop
    def filter_tracks():
        with record_function("global.filter_tracks"):
            set_outlier_tracks_to_unestimated(
                recon, opts.max_reprojection_error_pixels,
                opts.min_triangulation_angle_degrees, **kw)

    stage_timer.reset()
    with record_function("global.triangulate"):
        estimate_all_tracks(recon, opts.tracks, **kw)
    timings["triangulation_time"] = stage_timer.elapsed_seconds()
    stage_timer.reset()
    with record_function("global.ba"):
        _run_ba(recon, opts,
                polish=(opts.num_retriangulation_iterations == 0), **kw)
    filter_tracks()
    for i in range(opts.num_retriangulation_iterations):
        with record_function("global.filter_tracks"):
            set_underconstrained_as_unestimated(recon)
        with record_function("global.triangulate"):
            estimate_all_tracks(recon, opts.tracks, **kw)
        with record_function("global.ba"):
            _run_ba(recon, opts,
                    polish=(i == opts.num_retriangulation_iterations - 1),
                    **kw)
        filter_tracks()
    with record_function("global.filter_tracks"):
        set_underconstrained_as_unestimated(recon)
    timings["bundle_adjustment_time"] = stage_timer.elapsed_seconds()
    timings["total_time"] = total_timer.elapsed_seconds()
    return {"success": True,
            "num_estimated_views": len(recon.estimated_views()),
            "num_estimated_tracks": len(recon.estimated_tracks()),
            "timings": timings}
