from .losses import robust_weight  # noqa: F401
from .bundle_adjustment import (  # noqa: F401
    BAOptions, BAProblem, BASummary, bundle_adjust, ba_cost,
)
