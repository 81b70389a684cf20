"""The port's bundle adjuster (theiasfm_tpu_torch/sfm/ba) against the JAX
package's, on the same problems handed over as numpy arrays.

Exact equivalence is checked in f64 with cg_eta=0; the production-like
f32 configurations (bf16 matvec, both kernel layouts) are held to the
final cost at rtol=1e-3, because LM trajectories under bf16 and inexact
CG depend on the order of f32 reductions (ROADMAP.md, North star)."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from __graft_entry__ import _make_problem  # noqa: E402
from theiasfm_tpu.sfm.ba import BAOptions as JOptions  # noqa: E402
from theiasfm_tpu.sfm.ba import bundle_adjust as j_bundle_adjust  # noqa
from theiasfm_tpu.sfm.ba import bundle_adjustment as jba  # noqa: E402
from theiasfm_tpu_torch.bench_problem import make_problem  # noqa: E402
from theiasfm_tpu_torch.convert import (  # noqa: E402
    JAX_LAYOUT_FIELDS, from_jax_arrays, options_from_dict)
from theiasfm_tpu_torch.sfm.ba import bundle_adjust  # noqa: E402
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as tba  # noqa
from theiasfm_tpu_torch.utils import (  # noqa: E402
    dispatch_counts, reset_dispatch_counts)


def _np(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_np(e) for e in v)
    return np.asarray(v)


def _fields(p):
    return {k: _np(v) for k, v in p._asdict().items()}


def _to_port(p):
    return from_jax_arrays(_fields(p), device="cpu")


def _opts(o):
    return options_from_dict(dataclasses.asdict(o))


def _params(p):
    return [np.asarray(x) for x in (p.extrinsics, p.intrinsics, p.points)]


def _launch_counters():
    """The counters set, less the solver's host reads, LM steps and
    preconditioner builds (sync.*, lm.*, precond.*)."""
    return {k for k in dispatch_counts()
            if not k.startswith(("sync.", "lm.", "precond."))}


# ------------------------------------------------------- exact, f64

# CG is run to a tight tolerance: with a truncated CG, f64 rounding
# differences wander along the gauge directions (the parameters then
# differ at 1e-4 while the costs agree), which says nothing of the port
F64_BASE = JOptions(max_iterations=8, cg_iterations=300, cg_tol=1e-14,
                    loss="huber", loss_scale=2.0, function_tolerance=0.0,
                    cg_eta=0.0)


@pytest.mark.parametrize("extra", [
    {},
    {"preconditioner": "block_diag", "reject_growth_aggressive": True,
     "trace_costs": True},
    {"jacobian_reuse": True, "precond_reuse": True, "inner_iterations": 2,
     "loss": "cauchy", "initial_lambda": 1e2},
], ids=["default", "blockdiag_agg_trace", "reuse_inner2_cauchy"])
def test_f64_solve_matches_jax(extra):
    jp = _make_problem(n_cams=12, n_pts=256, obs_per_pt=4,
                       dtype=jnp.float64)
    opts = dataclasses.replace(F64_BASE, **extra)
    out_j, s_j = j_bundle_adjust(jp, opts)
    out_t, s_t = bundle_adjust(_to_port(jp), _opts(opts))
    assert float(s_t.initial_cost) == pytest.approx(float(s_j.initial_cost),
                                                    rel=1e-12)
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-6)
    for a, b in zip(_params(out_t), _params(out_j)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert s_t.num_iterations == int(s_j.num_iterations)
    assert float(s_t.final_cost) < 0.5 * float(s_t.initial_cost)
    if opts.trace_costs:
        # candidate costs; the accept flag (the sign) is a coin toss once
        # the cost has converged to the last digits, so compare |cost|
        np.testing.assert_allclose(np.abs(s_t.cost_trace.numpy()),
                                   np.abs(np.asarray(s_j.cost_trace)),
                                   rtol=1e-6)


def test_f64_two_groups_matches_jax():
    """Ng > 1: the per-group reductions (index_add_ over obs_group) and
    two optimized intrinsics slots."""
    jp = _make_problem(n_cams=12, n_pts=200, obs_per_pt=4,
                       dtype=jnp.float64)
    jp = jp._replace(intrinsics=jnp.concatenate([jp.intrinsics] * 2),
                     obs_group=(jp.obs_cam % 2).astype(jnp.int32))
    opts = dataclasses.replace(
        F64_BASE, max_iterations=5,
        optimize_intrinsics=(True, False, False, True) + (False,) * 6)
    out_j, s_j = j_bundle_adjust(jp, opts)
    out_t, s_t = bundle_adjust(_to_port(jp), _opts(opts))
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-6)
    for a, b in zip(_params(out_t), _params(out_j)):
        np.testing.assert_allclose(a, b, atol=1e-6)


# ------------------------------------------- production-like, f32

F32_BASE = JOptions(max_iterations=8, cg_iterations=20, loss="huber",
                    loss_scale=2.0, function_tolerance=0.0,
                    point_indices_sorted=True)


@pytest.fixture(scope="module")
def f32_problem():
    """The problem of tests/test_pallas_matvec.py's full-LM gate, and
    the JAX XLA-matvec solve on it."""
    jp = _make_problem(n_cams=12, n_pts=256, obs_per_pt=4,
                       dtype=jnp.float32)
    jp = jba.add_pallas_matvec_plan(jba.pad_obs_to_multiple(jp, 512),
                                    block=512)
    _, s_xla = j_bundle_adjust(jp, F32_BASE)
    return jp, float(s_xla.final_cost)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed", [True, False], ids=["pt", "prow"])
def test_f32_configs_match_jax(f32_problem, transposed, bf16):
    jp, c_xla = f32_problem
    opts = dataclasses.replace(F32_BASE, pallas_matvec=True,
                               pallas_transposed=transposed,
                               matvec_bf16=bf16)
    _, s_j = j_bundle_adjust(jp, opts)
    tp = _to_port(jp)
    assert tba.kernel_route(tp, _opts(opts)).matvec == "one_group"
    reset_dispatch_counts()
    _, s_t = bundle_adjust(tp, _opts(opts))
    # on CPU tensors the wrappers run the plain versions: no launches
    assert _launch_counters() == {"schur_matvec"}
    c_t = float(s_t.final_cost)
    np.testing.assert_allclose(c_t, float(s_j.final_cost), rtol=1e-3)
    np.testing.assert_allclose(c_t, c_xla, rtol=1e-3)
    assert c_t < 0.5 * float(s_t.initial_cost)
    # the port's plain matvec (pallas_matvec=False) on the same config
    _, s_plain = bundle_adjust(
        tp, _opts(dataclasses.replace(opts, pallas_matvec=False)))
    np.testing.assert_allclose(float(s_plain.final_cost), c_t, rtol=1e-3)


def test_f32_pcg_fast_matches_jax(f32_problem):
    """The timed configuration: bf16 matvec, cg_eta=0.1, transposed."""
    jp, c_xla = f32_problem
    opts = dataclasses.replace(F32_BASE, pallas_matvec=True,
                               matvec_bf16=True, cg_eta=0.1)
    _, s_j = j_bundle_adjust(jp, opts)
    _, s_t = bundle_adjust(_to_port(jp), _opts(opts))
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-3)


def test_f32_pallas_blocks_matches_jax(f32_problem):
    """pallas_blocks with the matvec kernels: the final cost within rtol
    1e-3 of JAX's (FusedBlocks in interpret mode) and of JAX's XLA
    solve; on the CPU the wrapper runs blocks_plain, so the solve equals
    the port's plain-blocks solve exactly."""
    jp, c_xla = f32_problem
    opts = dataclasses.replace(F32_BASE, pallas_matvec=True,
                               pallas_blocks=True)
    _, s_j = j_bundle_adjust(jp, opts)
    tp = _to_port(jp)
    assert tba.kernel_route(tp, _opts(opts)).blocks == "kernel"
    reset_dispatch_counts()
    out_t, s_t = bundle_adjust(tp, _opts(opts))
    assert _launch_counters() == {"schur_matvec"}
    c_t = float(s_t.final_cost)
    np.testing.assert_allclose(c_t, float(s_j.final_cost), rtol=1e-3)
    np.testing.assert_allclose(c_t, c_xla, rtol=1e-3)
    out_p, s_p = bundle_adjust(
        tp, _opts(dataclasses.replace(opts, pallas_blocks=False)))
    assert float(s_p.final_cost) == c_t
    for a, b in zip(_params(out_t), _params(out_p)):
        np.testing.assert_array_equal(a, b)


def test_bucketed_pallas_blocks_matches_jax():
    """The reconstruction-level path: bundle_adjust_bucketed pads every
    axis (masked padding observations) and, with pallas_blocks, runs
    make_blocks through the blocks wrapper."""
    jp = _make_problem(n_cams=12, n_pts=300, obs_per_pt=4,
                       dtype=jnp.float32)
    base = JOptions(max_iterations=5, cg_iterations=20, loss="huber",
                    loss_scale=2.0, function_tolerance=0.0,
                    pallas_matvec=True, pallas_blocks=True)
    out_j, s_j = jba.bundle_adjust_bucketed(jp, base)
    out_t, s_t = tba.bundle_adjust_bucketed(_to_port(jp), _opts(base))
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-3)
    assert float(s_t.final_cost) < 0.5 * float(s_t.initial_cost)
    for a, b in zip(_params(out_t), _params(out_j)):
        assert a.shape == b.shape


def test_bucketed_matches_jax():
    jp = _make_problem(n_cams=12, n_pts=300, obs_per_pt=4,
                       dtype=jnp.float32)
    base = JOptions(max_iterations=5, cg_iterations=20, loss="huber",
                    loss_scale=2.0, function_tolerance=0.0,
                    pallas_matvec=True)
    out_j, s_j = jba.bundle_adjust_bucketed(jp, base)
    reset_dispatch_counts()
    out_t, s_t = tba.bundle_adjust_bucketed(_to_port(jp), _opts(base))
    assert dispatch_counts()["schur_matvec"] > 0
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-3)
    for a, b in zip(_params(out_t), _params(out_j)):
        assert a.shape == b.shape


# one intrinsics group (the Venice cell's), a group per camera (Final's)
_VENICE = dict(pallas_matvec=True, pallas_blocks=True, matvec_bf16=True)
ROUTES = [
    ("venice", {}, {}, ("one_group", "kernel", "plain", "kernel")),
    ("venice", {}, {"pallas_blocks": False},
     ("one_group", "plain", "plain", "kernel")),
    ("final", {}, {}, ("groups", "plain", "plain", "kernel")),
    ("venice", {"dtype": torch.float64}, {},
     ("plain", "plain", "plain", "plain")),
    ("venice", {}, {"pallas_matvec": False},
     ("plain", "plain", "plain", "plain")),
    ("venice", {}, {"axis_name": "obs"},
     ("one_group", "plain", "plain", "plain")),
    ("final", {}, {"axis_name": "obs"}, ("plain", "plain", "plain", "plain")),
    ("final", {}, {"linear_solver": "dense_schur", "pallas_matvec": False},
     ("plain", "plain", "kernel", "plain")),
    ("final", {"dtype": torch.float64},
     {"linear_solver": "dense_schur", "pallas_matvec": False},
     ("plain", "plain", "plain", "plain")),
    ("final", {}, {"linear_solver": "dense_schur", "pallas_matvec": False,
                   "axis_name": "obs"}, ("plain", "plain", "plain", "plain")),
    ("venice", {}, {"linear_solver": "dense_schur"},
     ("one_group", "kernel", "kernel", "plain")),
    ("venice", {"device": "meta"}, {},
     ("one_group", "kernel", "plain", "kernel")),
    ("final", {}, {"preconditioner": "block_diag"},
     ("groups", "plain", "plain", "plain")),
]


@pytest.mark.parametrize("groups,problem,options,route", ROUTES, ids=[
    "venice", "venice-no-blocks", "final", "f64", "matvec-off",
    "one-group-mesh", "groups-mesh", "dense-f32", "dense-f64", "dense-mesh",
    "dense-pallas-options", "no-device-condition", "block-diag"])
def test_kernel_route(groups, problem, options, route):
    """kernel_route from options and shapes: S·v one_group with
    pallas_matvec, float32 and one group (under a mesh axis too), groups
    with several groups on one device, else plain; ba_blocks on the
    one-group route with pallas_blocks on one device; the dense
    corrections' kernel route for the dense solver in float32 on one
    device; the SCHUR_JACOBI corrections' kernel route for PCG where S·v
    takes a kernel route on one device. The tensors' device does not
    enter."""
    p = make_problem(4, 16, 2, dtype=problem.get("dtype", torch.float32),
                     device="cpu")
    if "device" in problem:
        p = tba.BAProblem(*[None if x is None else x.to(problem["device"])
                            for x in p])
    if groups == "final":
        p = p._replace(intrinsics=p.intrinsics.repeat(4, 1),
                       obs_group=p.obs_cam.clone())
    opts = tba.BAOptions(**{**_VENICE, **options})
    got = tba.kernel_route(p, opts)
    assert isinstance(got, tba.KernelRoute)
    assert tuple(got) == route


def test_bucketed_one_group_pads_to_512(monkeypatch):
    """A one-group float32 problem that bundle_adjust_bucketed pads to 512
    observations takes the one-group route (on the CPU the kernels' plain
    twins), whatever its size, and ends at the plain route's cost."""
    tp = make_problem(8, 100, 4, dtype=torch.float32, device="cpu",
                      perturb_seed=3)
    opts = tba.BAOptions(max_iterations=4, cg_iterations=20, loss="huber",
                         loss_scale=2.0, function_tolerance=0.0,
                         pallas_matvec=True)
    assert tba.pad_ba_problem(tp).obs_cam.shape[0] == 512
    calls = []
    real = tba.fm.pass1

    def spy(*args, **kwargs):
        calls.append(args[0].shape[1])
        return real(*args, **kwargs)
    monkeypatch.setattr(tba.fm, "pass1", spy)
    reset_dispatch_counts()
    _, s = tba.bundle_adjust_bucketed(tp, opts)
    monkeypatch.undo()
    assert calls and set(calls) == {512}
    assert len(calls) == dispatch_counts()["schur_matvec"]
    _, s_plain = tba.bundle_adjust_bucketed(
        tp, dataclasses.replace(opts, pallas_matvec=False))
    assert float(s.final_cost) == pytest.approx(float(s_plain.final_cost),
                                                rel=1e-5)
    assert float(s.final_cost) < 0.5 * float(s.initial_cost)


# -------------------------------------------- dense Schur, f64 polish

@pytest.mark.parametrize("reuse,tables", [(False, False), (True, True)],
                         ids=["dense_schur", "dense_schur_fast"])
def test_f64_dense_schur_matches_jax(reuse, tables):
    """The dense-Schur solve in f64 against JAX's; with the camera-pair
    tables attached JAX takes its scatter-free path, which the port's
    index_add_ assembly must equal; precond_reuse keeps the correction
    blocks across rejected steps (Cauchy from lambda 1e-3 makes some)."""
    jp = _make_problem(n_cams=12, n_pts=256, obs_per_pt=4,
                       dtype=jnp.float64)
    jp = jba.add_point_obs_map(jp)
    if tables:
        jp = jba.add_cam_pair_tables(jp)
    opts = dataclasses.replace(F64_BASE, linear_solver="dense_schur",
                               precond_reuse=reuse, trace_costs=True)
    if reuse:
        opts = dataclasses.replace(opts, loss="cauchy", initial_lambda=1e-3)
    out_j, s_j = j_bundle_adjust(jp, opts)
    out_t, s_t = bundle_adjust(_to_port(jp), _opts(opts))
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-6)
    for a, b in zip(_params(out_t), _params(out_j)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert s_t.num_iterations == int(s_j.num_iterations)
    assert float(s_t.final_cost) < 0.5 * float(s_t.initial_cost)
    if reuse:
        assert (s_t.cost_trace < 0).any()


def test_dense_schur_requires_point_obs_map():
    tp = make_problem(4, 16, 2, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="pt_idx_map"):
        bundle_adjust(tp, tba.BAOptions(linear_solver="dense_schur"))


def test_host_f64_matches_jax(f32_problem):
    """bundle_adjust_host_f64 from an f32 problem: both packages solve in
    float64 (the port on the problem's own device, here the CPU) with the
    plain matvec, whatever the options ask."""
    jp, _ = f32_problem
    opts = dataclasses.replace(F64_BASE, pallas_matvec=True,
                               pallas_blocks=True, max_iterations=6)
    out_j, s_j = jba.bundle_adjust_host_f64(jp, opts)
    tp = _to_port(jp)
    reset_dispatch_counts()
    out_t, s_t = tba.bundle_adjust_host_f64(tp, _opts(opts))
    assert out_t.points.dtype == torch.float64
    assert out_t.obs_cam.dtype == torch.int32
    assert tp.points.dtype == torch.float32
    np.testing.assert_allclose(float(s_t.final_cost), float(s_j.final_cost),
                               rtol=1e-6)
    for a, b in zip(_params(out_t), _params(out_j)):
        np.testing.assert_allclose(a, b, atol=1e-6)


# --------------------------------------------------- problem preparation

def _assert_equal(a, b, name):
    assert (a is None) == (b is None), name
    if a is not None:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def _assert_problems_equal(pt, pj):
    for name, a in pt._asdict().items():
        _assert_equal(a, getattr(pj, name), name)


@pytest.mark.parametrize("flags", [{}])
def test_pad_ba_problem_matches_jax(flags):
    jp = _make_problem(n_cams=10, n_pts=150, obs_per_pt=3,
                       dtype=jnp.float32)
    perm = np.random.default_rng(5).permutation(jp.obs_cam.shape[0])
    jp = jp._replace(**{k: getattr(jp, k)[perm] for k in (
        "obs_cam", "obs_group", "obs_pt", "obs_pix", "obs_mask")})
    tp = _to_port(jp)
    _assert_problems_equal(tba.pad_ba_problem(tp, **flags),
                           jba.pad_ba_problem(jp, **flags))


@pytest.mark.parametrize("multiple", [512, 1024])
def test_matvec_plan_fields_match_jax(multiple):
    """add_pallas_matvec_plan returns the problem unchanged (the port
    carries no tile plan); the padding before it and add_point_obs_map
    after it give JAX's fields."""
    jp = _make_problem(n_cams=12, n_pts=300, obs_per_pt=4,
                       dtype=jnp.float32)
    pj = jba.add_pallas_matvec_plan(jba.pad_obs_to_multiple(jp, multiple),
                                    block=multiple)
    padded = tba.pad_obs_to_multiple(_to_port(jp), multiple)
    pt = tba.add_pallas_matvec_plan(padded, block=multiple)
    assert pt is padded
    _assert_problems_equal(pt, pj)
    _assert_problems_equal(tba.add_point_obs_map(pt),
                           jba.add_point_obs_map(pj))


@pytest.mark.parametrize("camera_maps", ["reduction_maps", "camera_sort"])
def test_from_jax_arrays_drops_tpu_layouts(camera_maps):
    """A JAX problem carrying its TPU layouts (the reduction maps or the
    camera sort, the camera-pair tables, the fused-matvec plan) converts
    to the same port problem as the bare one."""
    jp = _make_problem(n_cams=12, n_pts=300, obs_per_pt=4,
                       dtype=jnp.float32)
    bare = jba.pad_ba_problem(jp, build_point_obs_map=True)
    full = jba.pad_ba_problem(
        jp, build_point_obs_map=True,
        **{"reduction_maps": {"build_reduction_maps": True},
           "camera_sort": {"sort_by_camera": True}}[camera_maps])
    full = jba.add_cam_pair_tables(full)
    full = jba.add_pallas_matvec_plan(full, block=256)
    layouts = {k for k, v in full._asdict().items() if v is not None} - \
        set(tba.BAProblem._fields)
    grp = {"grp_idx_map", "grp_idx_valid"}
    sort = {"cam_sort_perm", "obs_cam_sorted"}
    assert layouts == JAX_LAYOUT_FIELDS - (
        sort if camera_maps == "reduction_maps" else grp)
    want, got = _to_port(bare), _to_port(full)
    assert len(got) == 12
    for name, a in got._asdict().items():
        _assert_equal(a, getattr(want, name), name)


def test_from_jax_arrays_rejects_unknown_fields():
    jp = _make_problem(n_cams=4, n_pts=16, obs_per_pt=2, dtype=jnp.float32)
    fields = _fields(jp)
    fields["pmv_p0"] = None
    from_jax_arrays(fields, device="cpu")
    fields["cam_idx_order"] = None
    with pytest.raises(ValueError, match="cam_idx_order"):
        from_jax_arrays(fields, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_problem_matches_jax(dtype):
    jp = _make_problem(n_cams=16, n_pts=200, obs_per_pt=4,
                       dtype=getattr(jnp, dtype))
    tp = make_problem(16, 200, 4, dtype=getattr(torch, dtype), device="cpu")
    for name in ("obs_cam", "obs_group", "obs_pt", "obs_mask"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    # the projection runs in `dtype` in both packages
    pix_tol = 1e-3 if dtype == "float32" else 1e-9
    np.testing.assert_allclose(tp.obs_pix.numpy(), np.asarray(jp.obs_pix),
                               atol=pix_tol)
    for name in ("extrinsics", "intrinsics", "points"):
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_make_problem_perturbation_matches_bench_probe():
    """perturb_seed reproduces scripts/bench_probe.py's perturbation of
    the f32 bench problem."""
    jp = _make_problem(n_cams=16, n_pts=200, obs_per_pt=4,
                       dtype=jnp.float32)
    prng = np.random.default_rng(7)
    extr = np.array(jp.extrinsics)
    extr[:, :3] += prng.normal(scale=0.05, size=(extr.shape[0], 3))
    extr[:, 3:] += prng.normal(scale=0.005, size=(extr.shape[0], 3))
    pts = (np.asarray(jp.points) + prng.normal(
        scale=0.05, size=jp.points.shape)).astype(np.float32)
    tp = make_problem(16, 200, 4, dtype=torch.float32, device="cpu",
                      perturb_seed=7)
    np.testing.assert_allclose(tp.extrinsics.numpy(), extr, atol=1e-6)
    np.testing.assert_allclose(tp.points.numpy(), pts, atol=1e-6)


@pytest.mark.parametrize("extra", [{"axis_name": "obs"}])
def test_unported_options_raise(extra):
    """axis_name, once refused, now runs the sharded solver: outside a
    mesh that binds it, it raises; a 2-rank point-sharded solve (thread
    ranks, gloo) matches the single-device solve in float64."""
    from theiasfm_tpu_torch.parallel import point_sharded_bundle_adjust
    from torch_parallel_cases import run_threads

    tp = make_problem(4, 16, 2, dtype=torch.float32, device="cpu")
    with pytest.raises(LookupError, match="not bound"):
        bundle_adjust(tp, tba.BAOptions(**extra))
    prob = make_problem(8, 96, 3, dtype=torch.float64, device="cpu")
    # CG to a tight tolerance, as F64_BASE: a truncated CG lets the
    # parameters wander along the gauge while the costs agree
    opts = tba.BAOptions(max_iterations=4, cg_iterations=300, cg_tol=1e-14,
                         loss="huber", loss_scale=2.0,
                         function_tolerance=0.0)
    want, ws = bundle_adjust(prob, opts)

    def body(ranks):
        out, s = point_sharded_bundle_adjust(prob, opts, ranks.mesh(),
                                             axis_name=extra["axis_name"])
        return out.extrinsics.numpy(), out.points.numpy(), float(
            s.final_cost)

    for extr, pts, cost in run_threads(body, 2):
        assert cost == pytest.approx(float(ws.final_cost), rel=1e-10)
        np.testing.assert_allclose(extr, want.extrinsics.numpy(),
                                   atol=1e-9)
        np.testing.assert_allclose(pts, want.points.numpy(), atol=1e-9)


@pytest.mark.parametrize("extra", [{"linear_solver": "dense_schur"},
                                   {"pallas_matvec": True,
                                    "pallas_blocks": True}],
                         ids=["dense_schur", "pallas_blocks"])
def test_ported_options_run(extra):
    """The two options this package once refused now solve (on the tiny
    problem those refusals were tested on)."""
    tp = make_problem(4, 16, 2, dtype=torch.float32, device="cpu")
    tp = tba.add_point_obs_map(tba.pad_obs_to_multiple(tp, 32))
    _, s = bundle_adjust(tp, tba.BAOptions(max_iterations=3, **extra))
    assert s.num_iterations == 3
    assert float(s.final_cost) < float(s.initial_cost)
