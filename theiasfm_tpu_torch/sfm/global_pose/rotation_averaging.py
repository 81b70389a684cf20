"""Robust rotation averaging (port of
theiasfm_tpu/sfm/global_pose/rotation_averaging.py, in part): its
options only, which GlobalOptions and HybridOptions hold. The averaging
itself waits for slice C (ROADMAP.md, queue 1)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RobustRotationOptions:
    """ref: robust_rotation_estimator.h Options."""
    l1_iterations: int = 5
    irls_iterations: int = 10
    cg_iterations: int = 50
    sigma_degrees: float = 5.0  # IRLS kernel width
