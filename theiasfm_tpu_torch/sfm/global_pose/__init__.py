"""Global pose estimation (port of theiasfm_tpu/sfm/global_pose/, in
part). Only the option dataclasses have landed, since the
reconstruction builder's options hold them; the estimators wait for
slice C (ROADMAP.md, queue 1)."""
from .rotation_averaging import RobustRotationOptions  # noqa: F401
from .position_estimation import PositionEstimatorOptions  # noqa: F401
