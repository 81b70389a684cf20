"""Global position estimation (port of
theiasfm_tpu/sfm/global_pose/position_estimation.py, in part): its
options only, which GlobalOptions holds. The estimator waits for slice
C (ROADMAP.md, queue 1)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PositionEstimatorOptions:
    """ref: NonlinearPositionEstimator::Options /
    LeastUnsquaredDeviationPositionEstimator::Options."""
    max_iterations: int = 300
    cg_iterations: int = 40
    robust_loss_width: float = 0.1  # huber width on chordal residual
    seed: int = 0
