"""Multi-device solvers on torch.distributed (port of
theiasfm_tpu/parallel/): the observation- and point-sharded bundle
adjusters and the edge-sharded view-graph solvers."""
from .mesh import (  # noqa: F401
    Mesh, gloo_mesh, make_mesh, shard_ba_problem, sharded_bundle_adjust)
from .point_sharded import (  # noqa: F401
    partition_problem_by_point, point_sharded_bundle_adjust)
from .edge_sharded import (  # noqa: F401
    rotation_averaging_sharded, estimate_positions_sharded)
from .ranks import Ranks, run_ranks  # noqa: F401
