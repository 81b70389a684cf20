"""The port's edge-sharded view-graph solvers and its multi-device dry run
(theiasfm_tpu_torch/parallel) against the JAX package's: rotation
averaging and the LUD positions at 8 ranks on tests/test_parallel.py's
loop graphs, float64, at its tolerances; the padding of the edges; and
`dryrun_multichip(8, device="cpu")`, which holds itself to JAX's bounds.
JAX runs on the 8-device CPU mesh of tests/conftest.py, the port on
thread ranks with gloo groups."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.parallel import edge_sharded as jes
from theiasfm_tpu.sfm.global_pose import PositionEstimatorOptions as JPosOpts
from theiasfm_tpu.sfm.global_pose import RobustRotationOptions as JRotOpts
from theiasfm_tpu.sfm.global_pose import orientations_from_mst
from theiasfm_tpu_torch.parallel import (estimate_positions_sharded,
                                         rotation_averaging_sharded)
from theiasfm_tpu_torch.parallel import edge_sharded as tes
from theiasfm_tpu_torch.parallel.dryrun import dryrun_multichip
from theiasfm_tpu_torch.sfm.global_pose import (PositionEstimatorOptions,
                                                RobustRotationOptions)
from torch_parallel_cases import jax_mesh, run_threads
from torch_sfm_cases import one_torch_thread  # noqa: F401


def _graph(n_views, seed):
    from bench_global_stages import build_view_graph
    return build_view_graph(n_views, seed=seed)


def _agree(results):
    for r, got in enumerate(results[1:], 1):
        np.testing.assert_array_equal(got, results[0],
                                      err_msg=f"rank {r} differs")
    return results[0]


# Every CG iteration of the edge-sharded solvers is an all-reduce, and
# over gloo (loopback TCP) an all-reduce of 8 thread ranks took some 6.5
# ms on an idle 8-core CPU host, several times that beside the other test
# workers. TestEdgeSharded's schedules are some 780 all-reduces a rank
# for the rotations (5 L1 + 10 IRLS steps of 50 CG iterations: 50 s of
# this test beside 5 workers) and 13,500 for the positions (300 GN steps
# of 40), so the same graphs run shorter schedules here, in both
# packages.
ROT_OPTS = dict(l1_iterations=2, irls_iterations=3, cg_iterations=20)
POS_STEPS = 10


def test_rotation_averaging_sharded_matches_jax():
    """TestEdgeSharded's rotation case (60 views, seed 2) at 8 ranks,
    ROT_OPTS: within rtol 1e-6, atol 1e-8 of JAX's."""
    edges, rel_rot, _, weights, extrs = _graph(60, 2)
    init = orientations_from_mst(extrs.shape[0], edges, rel_rot, weights)
    want = jes.rotation_averaging_sharded(init, edges, rel_rot,
                                          jax_mesh(8, "edges"),
                                          opts=JRotOpts(**ROT_OPTS))

    def body(ranks):
        return rotation_averaging_sharded(
            init, edges, rel_rot, ranks.mesh("edges"),
            opts=RobustRotationOptions(**ROT_OPTS), dtype=torch.float64)

    got = _agree(run_threads(body, 8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_positions_sharded_matches_jax():
    """TestEdgeSharded's positions case (50 views, seed 4, LUD) at 8
    ranks, POS_STEPS GN steps: within rtol 1e-5, atol 1e-7 of JAX's."""
    edges, _, rel_dir, weights, extrs = _graph(50, 4)
    orient = extrs[:, 3:]
    R_i = np.asarray(jrot.angle_axis_to_rotation_matrix(
        jnp.asarray(orient)))[edges[:, 0]]
    rel_pos = np.einsum("eij,ej->ei", R_i, rel_dir)
    want = jes.estimate_positions_sharded(
        orient, edges, rel_pos, jax_mesh(8, "edges"), edge_weights=weights,
        opts=JPosOpts(max_iterations=POS_STEPS))

    def body(ranks):
        return estimate_positions_sharded(
            orient, edges, rel_pos, ranks.mesh("edges"),
            edge_weights=weights,
            opts=PositionEstimatorOptions(max_iterations=POS_STEPS),
            dtype=torch.float64)

    got = _agree(run_threads(body, 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_dev", [3, 8])
def test_pad_edges_matches_jax(n_dev):
    rng = np.random.default_rng(0)
    arrays = (rng.integers(0, 9, 13), rng.normal(size=(13, 3)),
              np.ones(13))
    vals = (0, np.array([1.0, 0.0, 0.0]), 0.0)
    want, we = jes._pad_edges(n_dev, *arrays, pad_vals=vals)
    got, ge = tes._pad_edges(n_dev, *arrays, pad_vals=vals)
    assert ge == we
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_dryrun_multichip_cpu():
    """The port's dry run at 8 thread ranks: JAX's five checks with its
    bounds (the function raises on a miss), the same readings on every
    rank."""
    got = dryrun_multichip(8, device="cpu", timeout=60.0)
    assert set(got) >= {"obs", "point", "dcn_ici", "kernels",
                        "orientations", "positions"}
    assert np.all(np.isfinite(got["positions"]))
