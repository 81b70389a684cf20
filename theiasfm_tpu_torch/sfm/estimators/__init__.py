"""Robust estimators (port of theiasfm_tpu/sfm/estimators/): the same
exports as the JAX package."""
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
from .uncalibrated import (  # noqa: F401
    estimate_uncalibrated_absolute_pose,
    estimate_uncalibrated_relative_pose,
)
from .transforms import (  # noqa: F401
    estimate_rigid_transform, estimate_triangulation,
    estimate_similarity_transform_2d_3d,
)
