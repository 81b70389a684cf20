"""Reconstruction pipelines (port of theiasfm_tpu/sfm/pipeline/).
Exports what has landed: two-view estimation and geometric
verification. The track, localization, incremental, global and hybrid
modules wait for their slices."""
from .twoview import (  # noqa: F401
    estimate_twoview_info, estimate_twoview_info_batch, TwoViewInfoOptions,
)
from .geometric_verification import (  # noqa: F401
    GeometricVerificationOptions, VerificationSamples,
    count_homography_inliers, draw_verification_samples, verify_matches,
    verify_matches_batch,
)
