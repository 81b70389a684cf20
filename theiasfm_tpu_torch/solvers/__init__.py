from .ransac import (  # noqa: F401
    RansacOptions, RansacSummary, MinimalSolverSpec, ransac, ransac_batch,
    ransac_adaptive, hypotheses_for_confidence, draw_samples,
    random_samples, prosac_samples, exhaustive_pair_samples,
)
