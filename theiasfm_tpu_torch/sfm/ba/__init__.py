from .losses import robust_weight  # noqa: F401
from .bundle_adjustment import (  # noqa: F401
    BAOptions, BAProblem, BASummary, bundle_adjust, ba_cost,
)
from .entry_points import (  # noqa: F401
    bundle_adjust_partial_reconstruction, bundle_adjust_reconstruction,
    bundle_adjust_track, bundle_adjust_view,
)
