"""Hybrid (global rotations, incremental positions) pipeline (port of
theiasfm_tpu/sfm/pipeline/hybrid.py, in part): its options and an entry
point that raises until slice C (ROADMAP.md, queue 1) ports the global
rotation averaging it starts from.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..global_pose import RobustRotationOptions
from .incremental import IncrementalOptions


@dataclasses.dataclass(frozen=True)
class HybridOptions:
    rotation: RobustRotationOptions = RobustRotationOptions()
    rotation_filtering_max_difference_degrees: float = 10.0
    incremental: IncrementalOptions = IncrementalOptions()
    seed: int = 0


def hybrid_reconstruction(recon, graph,
                          opts: HybridOptions = HybridOptions()) -> Dict:
    """Not ported yet: raises NotImplementedError."""
    raise NotImplementedError(
        "hybrid_reconstruction is not ported yet (ROADMAP.md queue 1, "
        "slice C: the global pipeline); use reconstruction_estimator_type="
        "'INCREMENTAL'")
