"""Global reconstruction pipeline (port of
theiasfm_tpu/sfm/pipeline/global_pipeline.py, in part): its options,
which the reconstruction builder's options hold, and an entry point
that raises until slice C (ROADMAP.md, queue 1) ports the pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..global_pose import PositionEstimatorOptions, RobustRotationOptions
from .estimate_tracks import EstimateTracksOptions


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


def global_reconstruction(recon, graph,
                          opts: GlobalOptions = GlobalOptions()) -> Dict:
    """Not ported yet: raises NotImplementedError."""
    raise NotImplementedError(
        "global_reconstruction is not ported yet (ROADMAP.md queue 1, "
        "slice C: the global pipeline); use reconstruction_estimator_type="
        "'INCREMENTAL'")
