"""The port's sharded bundle adjusters (theiasfm_tpu_torch/parallel) against
the JAX package's on the same problems: the observation-sharded solver at
8 ranks, the point-sharded one at 8 and on a 2 x 4 ("dcn", "ici") mesh,
and the point-sharded one with the fused-matvec route in float32 at 4
ranks, at tests/test_parallel.py's sizes, options and tolerances. JAX
runs on the 8-device CPU mesh of tests/conftest.py (its Pallas kernels
in interpret mode), the port on thread ranks with gloo groups (its
kernels' plain versions). Every rank must return the same bits."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.parallel import mesh as jmesh
from theiasfm_tpu.parallel import point_sharded as jps
from theiasfm_tpu.sfm.ba import BAOptions as JOptions
from theiasfm_tpu_torch.parallel import (make_mesh, mesh as tmesh,
                                         partition_problem_by_point,
                                         point_sharded_bundle_adjust,
                                         sharded_bundle_adjust)
from theiasfm_tpu_torch.sfm.ba import BAOptions, bundle_adjust
from torch_parallel_cases import (assert_ranks_agree, jax_mesh,
                                  jax_mesh_2d, jax_problem, params,
                                  port_opts, run_threads, to_port)
from torch_sfm_cases import one_torch_thread  # noqa: F401

OBS_OPTS = JOptions(max_iterations=5, cg_iterations=20, loss="huber",
                    loss_scale=2.0, point_indices_sorted=True)
PT_OPTS = dataclasses.replace(OBS_OPTS, function_tolerance=0.0)
PT2_OPTS = dataclasses.replace(PT_OPTS, max_iterations=4)


def _solve(fn, opts, axis_name="obs", shape=None):
    """The thread ranks' body: build the mesh, solve, return host
    readings."""
    def body(ranks, prob):
        mesh = ranks.mesh(axis_name, shape)
        out, s = fn(prob, opts, mesh, axis_name=axis_name)
        return (*params(out), float(s.final_cost), s.num_iterations)
    return body


def _check(results, jax_out, jax_summary, cost_rtol, rtol, atol,
           points=True):
    assert_ranks_agree(results)
    extr, _, pts, cost, _ = results[0]
    assert cost == pytest.approx(float(jax_summary.final_cost),
                                 rel=cost_rtol)
    np.testing.assert_allclose(extr, np.asarray(jax_out.extrinsics),
                               rtol=rtol, atol=atol)
    if points:
        np.testing.assert_allclose(pts, np.asarray(jax_out.points),
                                   rtol=rtol, atol=atol)


def test_sharded_bundle_adjust_matches_jax():
    """test_parallel.py::test_sharded_ba_matches_single_device's case:
    8 ranks, float64, its tolerances (1e-8)."""
    jp = jax_problem(12, 256, 4, jnp.float64)
    jout, js = jmesh.sharded_bundle_adjust(jp, OBS_OPTS, jax_mesh(8))
    got = run_threads(_solve(sharded_bundle_adjust, port_opts(OBS_OPTS)),
                      8, to_port(jp))
    _check(got, jout, js, 1e-8, 0.0, 1e-8)


@pytest.mark.parametrize("layout", ["8", "2x4"])
def test_point_sharded_matches_jax(layout):
    """TestPointShardedBA's cases: 8 ranks (12 cameras, 400 points) and a
    2 x 4 ("dcn", "ici") mesh (10 cameras, 320 points), float64;
    final cost within 1e-6, parameters within rtol 1e-5, atol 1e-7."""
    if layout == "8":
        jp, opts = jax_problem(12, 400, 4, jnp.float64), PT_OPTS
        jout, js = jps.point_sharded_bundle_adjust(jp, opts, jax_mesh(8))
        body = _solve(point_sharded_bundle_adjust, port_opts(opts))
    else:
        jp, opts = jax_problem(10, 320, 4, jnp.float64), PT2_OPTS
        jout, js = jps.point_sharded_bundle_adjust(
            jp, opts, jax_mesh_2d(2, 4), axis_name=("dcn", "ici"))
        body = _solve(point_sharded_bundle_adjust, port_opts(opts),
                      ("dcn", "ici"), (2, 4))
    got = run_threads(body, 8, to_port(jp))
    _check(got, jout, js, 1e-6, 1e-5, 1e-7)


def test_point_sharded_kernel_route_matches_jax():
    """TestPointShardedPallas's case: pallas_matvec in float32 at 4 ranks
    (JAX's kernels in interpret mode, the port's plain versions of its
    CUDA kernels); final cost within 1e-4, cameras within rtol 1e-3,
    atol 1e-4."""
    jp = jax_problem(10, 320, 4, jnp.float32)
    opts = dataclasses.replace(PT2_OPTS, pallas_matvec=True)
    jout, js = jps.point_sharded_bundle_adjust(jp, opts, jax_mesh(4))
    got = run_threads(_solve(point_sharded_bundle_adjust, port_opts(opts)),
                      4, to_port(jp))
    _check(got, jout, js, 1e-4, 1e-3, 1e-4, points=False)


@pytest.mark.parametrize("pallas_block", [0, 1024])
def test_partition_matches_jax(pallas_block):
    """partition_problem_by_point: every array and the point ranges equal
    to JAX's, bit for bit, with and without the per-shard plans."""
    jp = jax_problem(12, 400, 4, jnp.float64)
    want, wmeta = jps.partition_problem_by_point(jp, 8, pallas_block)
    got, gmeta = partition_problem_by_point(to_port(jp), 8, pallas_block)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(gmeta["pt_start"], wmeta["pt_start"])
    assert (gmeta["Np_loc"], gmeta["n_dev"]) == (wmeta["Np_loc"],
                                                 wmeta["n_dev"])


def test_shard_ba_problem_matches_jax():
    """The ranks' observation slices of shard_ba_problem, put end to end,
    are JAX's padded arrays; the parameters are replicated."""
    jp = jax_problem(8, 61, 3, jnp.float64)   # 183 observations: padded
    want = jmesh.shard_ba_problem(jp, jax_mesh(8))

    def body(ranks, prob):
        local = tmesh.shard_ba_problem(prob, ranks.mesh())
        return [getattr(local, k).numpy() for k in
                ("obs_cam", "obs_group", "obs_pt", "obs_pix", "obs_mask",
                 "points")]

    got = run_threads(body, 8, to_port(jp))
    for i, k in enumerate(("obs_cam", "obs_group", "obs_pt", "obs_pix",
                           "obs_mask")):
        np.testing.assert_array_equal(
            np.concatenate([g[i] for g in got]), np.asarray(getattr(want, k)),
            err_msg=k)
    for g in got:
        np.testing.assert_array_equal(g[5], np.asarray(jp.points))


def test_unbound_axis_and_missing_group_raise():
    """An axis_name that no mesh binds raises before any work; a mesh
    needs a process group; a failing rank fails the run."""
    prob = to_port(jax_problem(4, 16, 2, jnp.float64))
    with pytest.raises(LookupError, match="'obs'"):
        bundle_adjust(prob, BAOptions(axis_name="obs"))
    with pytest.raises(LookupError, match="'dcn'"):
        bundle_adjust(prob, BAOptions(axis_name=("dcn", "ici")))
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="not initialized"):
            make_mesh("cpu")

    def body(ranks):
        mesh = ranks.mesh()
        if ranks.rank == 1:
            raise ValueError("rank 1 fails")
        with mesh.bind():
            return bundle_adjust(prob, BAOptions(axis_name="obs"))

    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_threads(body, 2)


def test_mesh_axes_must_match():
    jp = to_port(jax_problem(4, 16, 2, jnp.float64))

    def body(ranks):
        mesh = ranks.mesh(("dcn", "ici"), (1, 2))
        with pytest.raises(ValueError, match="does not name"):
            point_sharded_bundle_adjust(jp, BAOptions(), mesh,
                                        axis_name="obs")
        return mesh.shape, mesh.rank

    assert run_threads(body, 2) == [((1, 2), 0), ((1, 2), 1)]
