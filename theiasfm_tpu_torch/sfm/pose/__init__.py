"""Pose solvers (port of theiasfm_tpu/sfm/pose/). Exports the solvers
that have landed: the two-view utilities, the 8-point fundamental, the
4-point homography, the 5-point essential and the P3P absolute pose."""
from .twoview_utils import (  # noqa: F401
    sampson_distance_sq, epipolar_distance_sq, decompose_essential,
    essential_from_rt, fundamental_from_projections,
    relative_pose_from_essential,
)
from .eight_point import (  # noqa: F401
    eight_point_fundamental, npoint_fundamental,
)
from .homography import four_point_homography, npoint_homography  # noqa: F401
from .five_point import five_point_essential  # noqa: F401
from .p3p import p3p_grunert  # noqa: F401
