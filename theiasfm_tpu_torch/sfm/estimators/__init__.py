"""Robust estimators (port of theiasfm_tpu/sfm/estimators/). Exports
what has landed: the two-view and calibrated absolute-pose estimators.
The uncalibrated and transform estimators wait for their slices."""
from .twoview_estimators import (  # noqa: F401
    estimate_relative_pose, estimate_fundamental, estimate_homography,
    estimate_radial_distortion_homography,
    relative_pose_spec, fundamental_spec, homography_spec,
    radial_distortion_homography_spec,
)
from .absolute_pose import (  # noqa: F401
    estimate_calibrated_absolute_pose, absolute_pose_spec,
    refine_absolute_pose_gn,
)
