"""Reconstruction pipelines (port of theiasfm_tpu/sfm/pipeline/).
Exports what the JAX package's exports: two-view estimation, geometric
verification, track estimation, localization, the filters and the
incremental pipeline run; the global and hybrid pipelines export their
options, and their entry points raise NotImplementedError until slice C
(ROADMAP.md, queue 1)."""
from .twoview import (  # noqa: F401
    estimate_twoview_info, estimate_twoview_info_batch, TwoViewInfoOptions,
)
from .geometric_verification import (  # noqa: F401
    GeometricVerificationOptions, VerificationSamples,
    count_homography_inliers, draw_verification_samples, verify_matches,
    verify_matches_batch,
)
from .estimate_tracks import (  # noqa: F401
    EstimateTracksOptions, estimate_all_tracks,
)
from .localize import LocalizeOptions, localize_view  # noqa: F401
from .filters import (  # noqa: F401
    set_outlier_tracks_to_unestimated, set_underconstrained_as_unestimated,
)
from .incremental import (  # noqa: F401
    IncrementalOptions, incremental_reconstruction,
)
from .global_pipeline import GlobalOptions, global_reconstruction  # noqa: F401
from .hybrid import HybridOptions, hybrid_reconstruction  # noqa: F401
