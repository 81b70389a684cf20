"""The port's exact solve (BAOptions(linear_solver="dense_schur")) against
the plain float64 reference benchmark/bal/exact_step.py, which forms the
whole Jacobian densely and solves the damped normal equations with no
Schur step; its reach through the normal path (bundle_adjust_bucketed,
bundle_adjust_reconstruction); its profiler ranges and its counters.

Small seeded problems on the CPU, one torch thread."""
from __future__ import annotations

import collections
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark.bal import exact_step  # noqa: E402
from theiasfm_tpu_torch.bench_problem import make_problem  # noqa: E402
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba  # noqa: E402
from theiasfm_tpu_torch.sfm.ba import (  # noqa: E402
    bundle_adjust_reconstruction)
from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction  # noqa
from theiasfm_tpu_torch.utils.dispatch import (  # noqa: E402
    dispatch_counts, reset_dispatch_counts)

ACTIVE = (0, 5, 6)                       # focal, k1, k2: BAL's own
LOSS_SCALE = 2.0
LAM = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(**kw):
    base = dict(optimize_intrinsics=tuple(i in ACTIVE for i in range(10)),
                loss="huber", loss_scale=LOSS_SCALE, initial_lambda=LAM,
                function_tolerance=0.0, inner_iterations=0,
                linear_solver="dense_schur")
    base.update(kw)
    return ba.BAOptions(**base)


def _problem(dtype, groups, masked, n_cams=8, n_pts=200, obs_per_pt=6):
    """make_problem's ring of cameras (seeded), with one intrinsics group
    or one a camera, and camera 2 held constant when `masked`."""
    p = make_problem(n_cams, n_pts, obs_per_pt, dtype=torch.float64,
                     device="cpu", perturb_seed=3)
    if groups == "per_camera":
        p = p._replace(intrinsics=p.intrinsics.repeat(n_cams, 1),
                       obs_group=p.obs_cam.clone())
    if masked:
        cm = torch.ones(n_cams, dtype=torch.bool)
        cm[2] = False
        p = p._replace(cam_mask=cm)
    return ba.BAProblem(*[x.to(dtype) if isinstance(x, torch.Tensor) and
                          x.is_floating_point() else x for x in p])


def _reference_args(p):
    return (p.extrinsics, p.intrinsics, p.points, p.obs_cam, p.obs_group,
            p.obs_pt, p.obs_pix, p.obs_mask)


def _port_step(p):
    """The port's first LM step, read off an accepted one-iteration solve
    without inner iterations: (dc, dg over the active slots, dp)."""
    out, s = ba.bundle_adjust(ba.add_point_obs_map(p),
                              _options(max_iterations=1))
    assert float(s.final_cost) < float(s.initial_cost)
    return ((out.extrinsics - p.extrinsics).double(),
            (out.intrinsics - p.intrinsics).double()[:, list(ACTIVE)],
            (out.points - p.points).double())


@pytest.mark.parametrize("masked", [False, True], ids=["free", "masked"])
@pytest.mark.parametrize("groups", ["shared", "per_camera"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_dense_step_matches_the_exact_step(dtype, groups, masked):
    """The port's damped dense step against exact_step.lm_step from the
    same parameters (upcast). float64: each block within rtol 1e-8 (the
    two routes differ by rounding only: the Schur complement's
    cancellation and the 1e-12 on the point diagonals, some 1e-10 here).
    float32: the whole step in the norm the damped system's diagonal D
    weighs, within 2 kappa u, kappa the condition number of the
    Jacobi-scaled system D^-1/2 A D^-1/2 (some 5e4 here) and u float32's
    unit roundoff: the normwise bound kappa (|dA|/|A| + |db|/|b|) on a
    solve whose matrix and right-hand side are each formed to about u,
    relative, in the scaled norm."""
    p = _problem(dtype, groups, masked)
    dc, dg, dp = _port_step(p)
    args = _reference_args(p)
    cam_mask = p.cam_mask
    rc, rg, rp = exact_step.lm_step(*args, ACTIVE, LAM, LOSS_SCALE,
                                    cam_mask=cam_mask)
    if masked:
        assert torch.equal(dc[2], torch.zeros(6, dtype=torch.float64))
        assert torch.equal(rc[2], torch.zeros(6, dtype=torch.float64))
    if dtype == torch.float64:
        for got, want in ((dc, rc), (dg, rg), (dp, rp)):
            torch.testing.assert_close(got, want, rtol=1e-8,
                                       atol=1e-8 * float(want.abs().max()))
        return
    A, _ = exact_step.damped_system(*args, ACTIVE, LAM, LOSS_SCALE,
                                    cam_mask=cam_mask)
    d = torch.diagonal(A).sqrt()
    kappa = float(torch.linalg.cond(A / d[:, None] / d[None, :]))
    u = torch.finfo(torch.float32).eps / 2
    got = torch.cat([x.reshape(-1) for x in (dc, dg, dp)])
    want = torch.cat([x.reshape(-1) for x in (rc, rg, rp)])
    err = float(((got - want) * d).norm() / (want * d).norm())
    assert 1e3 < kappa < 1e6
    assert err <= 2 * kappa * u, (err, kappa)


def _reference_cost(p, iterations, cam_mask=None):
    return float(exact_step.lm_solve(
        *_reference_args(p), ACTIVE, iterations, LOSS_SCALE, LAM,
        cam_mask=cam_mask)[3])


def test_bucketed_solve_reaches_the_exact_cost():
    """bundle_adjust_bucketed pads the problem and attaches the point
    observation map itself: five LM iterations at float64 reach the cost
    that five LM steps of exact_step.lm_solve reach from the same start,
    within 1e-6 relative."""
    p = _problem(torch.float64, "per_camera", masked=False)
    opts = _options(max_iterations=5)
    reset_dispatch_counts()
    out, s = ba.bundle_adjust_bucketed(p, opts)
    assert dispatch_counts()["dense.factor"] == 5
    assert out.points.shape == p.points.shape
    want = _reference_cost(p, 5)
    assert float(s.final_cost) == pytest.approx(want, rel=1e-6)
    assert float(s.final_cost) < 0.5 * float(s.initial_cost)


def _reconstruction(p):
    rec = Reconstruction()
    n_cams = p.extrinsics.shape[0]
    for i in range(n_cams):
        v = rec.add_view(f"v{i}", group=0)
        rec.views[v].camera.extrinsics = p.extrinsics[i].double().numpy()
        rec.views[v].camera.intrinsics = p.intrinsics[0].double().numpy()
        rec.views[v].is_estimated = True
    for j in range(p.points.shape[0]):
        t = rec.add_track()
        rec.tracks[t].point = np.append(p.points[j].double().numpy(), 1)
        rec.tracks[t].is_estimated = True
    for m in np.flatnonzero(p.obs_mask.numpy()):
        rec.add_observation(int(p.obs_cam[m]), int(p.obs_pt[m]),
                            p.obs_pix[m].double().numpy())
    return rec


def test_reconstruction_solve_reaches_the_exact_cost():
    """bundle_adjust_reconstruction with the dense solver, the first
    camera held for the gauge: at float64 its final cost is what five LM
    steps of exact_step.lm_solve reach from the reconstruction's own
    snapshot with that camera held, within 1e-6 relative; the solved
    parameters are written back."""
    rec = _reconstruction(_problem(torch.float64, "shared", masked=False))
    snap, _ = rec.to_ba_problem(dtype=torch.float64, device="cpu")
    cam_mask = torch.ones(snap.extrinsics.shape[0], dtype=torch.bool)
    cam_mask[0] = False
    want = _reference_cost(snap, 5, cam_mask=cam_mask)
    s = bundle_adjust_reconstruction(rec, _options(max_iterations=5),
                                     device="cpu", dtype=torch.float64)
    assert s["num_iterations"] == 5
    assert s["final_cost"] == pytest.approx(want, rel=1e-6)
    after, _ = rec.to_ba_problem(dtype=torch.float64, device="cpu")
    assert not torch.equal(after.points, snap.points)
    torch.testing.assert_close(after.extrinsics[0], snap.extrinsics[0])


def test_dense_ranges_open_and_do_not_nest():
    """Under the profiler the dense solve opens ba.dense_corr and
    ba.factor once an LM iteration, no ba.precond and no ba.cg, and no two
    ba.* ranges overlap."""
    p = ba.add_point_obs_map(_problem(torch.float32, "per_camera", False))
    opts = _options(max_iterations=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ba.bundle_adjust(p, opts)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("ba."))
    names = collections.Counter(s[2] for s in spans)
    assert names["ba.dense_corr"] == names["ba.factor"] == 2
    assert "ba.precond" not in names and "ba.cg" not in names
    for a, b in zip(spans, spans[1:]):
        assert b[0] >= a[1], (a, b)


def _pairs(p):
    """Ordered pairs of valid observations of one point, k == l included."""
    n = torch.bincount(p.obs_pt[p.obs_mask].long(),
                       minlength=p.points.shape[0])
    return int((n * n).sum())


def test_dense_counters_and_syncs(monkeypatch):
    """Two 3-iteration solves: one correction build and one factorization
    an LM step, the observation pairs once a solve, no failed step; the
    host reads those tests/test_torch_ba_syncs.py holds the dense solver
    to (the LM step and three uploads an iteration, two uploads and the
    pairs' read a solve). A factorization made to fail counts once under
    dense.factor_failed, and LM rejects its step."""
    p = ba.add_point_obs_map(_problem(torch.float32, "per_camera", False))
    opts = _options(max_iterations=3)
    reset_dispatch_counts()
    for _ in range(2):
        ba.bundle_adjust(p, opts)
    c = dispatch_counts()
    iters = 6
    assert c["dense.corr"] == c["dense.factor"] == iters
    assert c["dense.pairs"] == 2 * _pairs(p)
    assert "dense.factor_failed" not in c
    assert c["lm.accepted"] + c.get("lm.rejected", 0) == iters
    syncs = {k[len("sync."):]: v for k, v in c.items()
             if k.startswith("sync.")}
    assert syncs == {"lm_step": iters, "upload": 3 * iters + 2 * 2,
                     "point_pairs": 2}
    assert not any(k.startswith(("schur", "ba_blocks")) for k in c)

    real = torch.linalg.cholesky_ex
    calls = []

    def fail_first(A, **kw):
        L, info = real(A, **kw)
        calls.append(1)
        return L, info + 1 if len(calls) == 1 else info
    monkeypatch.setattr(torch.linalg, "cholesky_ex", fail_first)
    reset_dispatch_counts()
    _, s = ba.bundle_adjust(p, dataclasses.replace(opts, trace_costs=True))
    c = dispatch_counts()
    assert c["dense.factor_failed"] == 1 and c["dense.factor"] == 3
    assert c["lm.rejected"] >= 1
    assert float(s.cost_trace[0]) != float(s.cost_trace[0])   # NaN
    assert float(s.final_cost) < float(s.initial_cost)
