"""Global pose estimation (port of theiasfm_tpu/sfm/global_pose/):
rotation averaging, the view-graph filters and position estimation."""
from .rotation_averaging import (  # noqa: F401
    RobustRotationOptions, robust_rotation_averaging,
    orientations_from_mst,
)
from .position_estimation import (  # noqa: F401
    PositionEstimatorOptions, estimate_positions_nonlinear,
    estimate_positions_lud,
)
from .filters import (  # noqa: F401
    filter_view_pairs_from_orientation,
    filter_view_pairs_from_relative_translation,
)
from .linear_estimators import (  # noqa: F401
    linear_rotation_averaging, nonlinear_rotation_averaging,
)
from .linear_position import (  # noqa: F401
    LinearPositionOptions, compute_triplet_baseline_ratios,
    estimate_positions_linear_triplet,
)
