"""Pose solvers (port of theiasfm_tpu/sfm/pose/): the same exports as
the JAX package."""
from .twoview_utils import (  # noqa: F401
    sampson_distance_sq, epipolar_distance_sq, decompose_essential,
    essential_from_rt, fundamental_from_projections,
    relative_pose_from_essential,
)
from .eight_point import (  # noqa: F401
    eight_point_fundamental, npoint_fundamental,
)
from .seven_point import seven_point_fundamental  # noqa: F401
from .homography import four_point_homography, npoint_homography  # noqa: F401
from .p3p import p3p_grunert  # noqa: F401
from .five_point import five_point_essential  # noqa: F401
from .upnp import upnp, dls_pnp  # noqa: F401
from .gdls import gdls_similarity_transform  # noqa: F401
from .pnp_focal_radial import (  # noqa: F401
    four_point_focal_length_radial_distortion,
    five_point_focal_length_radial_distortion,
)
from .radial_homography import (  # noqa: F401
    six_point_radial_distortion_homography,
    radial_homography_symmetric_error_sq,
)
from .partial_rotation import (  # noqa: F401
    two_point_pose_partial_rotation,
    three_point_relative_pose_partial_rotation,
    four_point_relative_pose_partial_rotation,
    sim_transform_partial_rotation,
)
