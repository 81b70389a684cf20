"""The dense Schur solver's correction build over the pair layout
(sfm/ba/dense_corr.py) on the CPU: the layout's parts (the pairs sorted
by camera pair, the segment starts and chunks, the camera and group
maps), its plain segment sums against bundle_adjustment._dense_schur_corr
in float64, and the solver's route to it (kernel_route's dense_corr, the
one host read a solve). The CUDA kernels themselves are held to the same
plain build on the card (tests/test_torch_kernels_cuda.py)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

import torch_dense_cases as cases
from theiasfm_tpu_torch.bench_problem import make_problem
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba
from theiasfm_tpu_torch.sfm.ba import dense_corr as dc
from theiasfm_tpu_torch.utils.dispatch import (dispatch_counts,
                                               reset_dispatch_counts)

CASES = [("one", 3, 0, True), ("per_camera", 3, 0, True),
         ("shared", 3, 0, True), ("per_camera", 1, 0, False),
         ("shared", 3, 700, True), ("one", 1, 700, False)]
IDS = ["one", "per_camera", "shared", "per_camera-P1-unmasked",
       "shared-long", "one-long-P1"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("groups,P,long,masked", CASES, ids=IDS)
def test_layout_parts(groups, P, long, masked, monkeypatch):
    """The pairs are the plain build's, sorted by camera pair (stably);
    each segment holds its camera pair's pairs; each segment is cut into
    max(1, ceil(len / CHUNK)) chunks of consecutive pairs, the rest of the
    chunks empty; the valid observations come first in camera order; each
    camera's group is that of its valid observations and grp_order lists
    the cameras by group."""
    monkeypatch.setattr(dc, "CHUNK", 64)
    prob = cases.problem(0, groups, P, long=long, masked=masked)[0]
    reset_dispatch_counts()
    (k, l), lay = dc.pair_layout(prob)
    n, Nc, Ng = k.shape[0], prob.extrinsics.shape[0], \
        prob.intrinsics.shape[0]
    assert dispatch_counts() == {"sync.point_pairs": 1, "dense.pairs": n}
    pk, pl = ba._point_obs_pairs(prob)
    assert torch.equal(k, pk) and torch.equal(l, pl)
    cam, grp = prob.obs_cam.long(), prob.obs_group.long()
    # the pairs: the same multiset, sorted by camera pair, stably
    order = torch.sort(cam[k] * Nc + cam[l], stable=True).indices
    assert torch.equal(lay.k.long(), k[order])
    assert torch.equal(lay.l.long(), l[order])
    assert (lay.seg_start.dtype, lay.k.dtype) == (torch.int32, torch.int32)
    # segments
    S = Nc * Nc
    lens = torch.bincount(cam[lay.k.long()] * Nc + cam[lay.l.long()],
                          minlength=S)
    assert lay.seg_start[0] == 0 and lay.seg_start[-1] == n
    assert torch.equal((lay.seg_start[1:] - lay.seg_start[:-1]).long(),
                       lens)
    # chunks: each segment's cover its pairs in order, at most CHUNK each
    per = torch.clamp((lens + dc.CHUNK - 1) // dc.CHUNK, min=1)
    assert torch.equal((lay.chunk_start[1:] - lay.chunk_start[:-1]).long(),
                       per)
    lo = lay.chunk_lo.long()
    assert lo.shape[0] == S + -(-n // dc.CHUNK) + 1 and int(lo[-1]) == n
    size = lo[1:] - lo[:-1]
    assert bool((size >= 0).all()) and int(size.max()) <= dc.CHUNK
    first = lay.chunk_start.long()
    assert torch.equal(lo[first], lay.seg_start.long())
    used = int(first[-1])
    assert int(size[used:].abs().sum()) == 0
    if long:
        assert int(per.max()) >= 700 // dc.CHUNK
    # cameras and groups
    valid = prob.obs_mask
    nv = int(valid.sum())
    assert int(lay.cam_start[-1]) == nv
    ordered = lay.cam_order.long()
    assert bool(valid[ordered[:nv]].all()) and not valid[ordered[nv:]].any()
    assert torch.equal(cam[ordered[:nv]], torch.sort(cam[valid]).values)
    assert torch.equal(lay.cam_group.long()[cam[valid]], grp[valid])
    gsorted = lay.cam_group.long()[lay.grp_order.long()]
    assert bool((gsorted[1:] >= gsorted[:-1]).all())
    assert torch.equal((lay.grp_start[1:] - lay.grp_start[:-1]).long(),
                       torch.bincount(lay.cam_group.long(), minlength=Ng))
    assert lay.chunk == 64


@pytest.mark.parametrize("groups,P,long,masked", CASES, ids=IDS)
def test_segment_sums_match_the_plain_build(groups, P, long, masked):
    """corr_plain, the segment sums over the layout (the kernels' plain
    version), equals _dense_schur_corr in float64 to rtol 1e-12: the same
    products summed in another order."""
    prob, *xs = cases.problem(1, groups, P, long=long, masked=masked)
    _, lay = dc.pair_layout(prob)
    Ng = prob.intrinsics.shape[0]
    got = dc.corr(lay, *xs, prob.obs_pt, Ng)
    want = cases.plain(prob, *xs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-12,
                                   atol=1e-12 * float(w.abs().max()))


def test_expanded_pairs_are_nonzeros_order():
    """expand_pairs gives torch.nonzero's pairs of the (Np, K, K) mask,
    also where a row's valid slots are not at its front."""
    prob = cases.problem(2, "one", 3)[0]
    g = torch.Generator().manual_seed(0)
    perm = torch.randperm(prob.pt_idx_map.shape[1], generator=g)
    idx, valid = prob.pt_idx_map[:, perm], prob.pt_idx_valid[:, perm]
    assert not bool((valid[:, 1:] <= valid[:, :-1]).all())
    pairs = valid[:, :, None] & valid[:, None, :]
    n, i, j = torch.nonzero(pairs, as_tuple=True)
    c, total = dc.pair_counts(valid)
    k, l = dc.expand_pairs(idx, valid, c, int(total))
    assert torch.equal(k, idx[n, i].long())
    assert torch.equal(l, idx[n, j].long())


def test_cameras_spanning_groups_keep_the_plain_build():
    """A camera whose valid observations name two groups: no layout (its
    group pairs are not constant in its segments), and the pairs are
    still the plain build's."""
    prob = cases.problem(0, "spanning", 3)[0]
    (k, l), lay = dc.pair_layout(prob)
    assert lay is None
    pk, pl = ba._point_obs_pairs(prob)
    assert torch.equal(k, pk) and torch.equal(l, pl)


def test_out_of_range_ids_raise():
    prob = cases.problem(0, "shared", 3)[0]
    bad = prob.obs_group.clone()
    bad[5] = prob.intrinsics.shape[0]
    with pytest.raises(ValueError):
        dc.pair_layout(prob._replace(obs_group=bad))


def _solve_case(groups="per_camera", n_cams=8, iterations=3):
    """A small f32 dense-Schur problem (make_problem's ring, a group per
    camera or one shared), padded, with the point map."""
    p = make_problem(n_cams, 200, 4, device="cpu", perturb_seed=3)
    if groups == "per_camera":
        p = p._replace(intrinsics=p.intrinsics.repeat(n_cams, 1),
                       obs_group=p.obs_cam.clone())
    p = ba.add_point_obs_map(ba.pad_obs_to_multiple(p, 512))
    opts = ba.BAOptions(
        optimize_intrinsics=(True,) + (False,) * 4 + (True, True) +
        (False,) * 3,
        max_iterations=iterations, loss="huber", loss_scale=2.0,
        function_tolerance=0.0, linear_solver="dense_schur")
    return p, opts


def _plain_route(monkeypatch):
    """kernel_route with its dense_corr set to "plain": the solver then
    builds its corrections with _dense_schur_corr, as it does in float64
    or under a mesh axis."""
    rule = ba.kernel_route
    monkeypatch.setattr(ba, "kernel_route", lambda p, o: rule(p, o)._replace(
        dense_corr="plain"))


def _spy(monkeypatch, module, name, calls, refuse=False):
    f = getattr(module, name)

    def wrapped(*args, **kwargs):
        if refuse:
            raise AssertionError(f"{name} called")
        calls.append(name)
        return f(*args, **kwargs)
    monkeypatch.setattr(module, name, wrapped)


def test_dense_kernel_eligible_rule():
    """The kernel route from options and shapes: the dense solver, f32,
    no mesh axis, on the CPU as on the card."""
    prob, opts = _solve_case()
    assert ba.kernel_route(prob, opts).dense_corr == "kernel"
    for p, o in ((prob, dataclasses.replace(opts, linear_solver="pcg")),
                 (prob, dataclasses.replace(opts, axis_name="obs")),
                 (prob._replace(points=prob.points.double()), opts)):
        assert ba.kernel_route(p, o).dense_corr == "plain"


@pytest.mark.parametrize("groups", ["per_camera", "one"])
def test_kernel_route_matches_the_plain_route(groups, monkeypatch):
    """On the CPU every correction build goes through dense_corr.corr and
    never _dense_schur_corr, with the same host reads as the plain route
    (the LM step, the uploads, the pairs' one read a solve), and the
    solve gives what the plain route gives: to float32's rounding
    with a group a camera (the same sums in the same order), and with one
    group (corr_cg and corr_gg then sum the cameras in another order)
    the same cost to rtol 1e-5 and a step within 3e-3 of the plain one
    in norm, kappa u for the kappa ~ 5e4 of such a ring's scaled system
    (tests/test_torch_dense_schur_exact.py)."""
    prob, opts = _solve_case(groups)
    _plain_route(monkeypatch)
    reset_dispatch_counts()
    plain, plain_summary = ba.bundle_adjust(prob, opts)
    plain_counts = dispatch_counts()
    monkeypatch.undo()
    calls = []
    _spy(monkeypatch, ba.dcorr, "corr", calls)
    _spy(monkeypatch, ba, "_dense_schur_corr", calls, refuse=True)
    reset_dispatch_counts()
    out, summary = ba.bundle_adjust(prob, opts)
    assert dispatch_counts() == plain_counts
    assert calls == ["corr"] * plain_counts["dense.corr"]
    if groups == "per_camera":
        for a, b in ((out.extrinsics, plain.extrinsics),
                     (out.intrinsics, plain.intrinsics),
                     (out.points, plain.points),
                     (summary.final_cost, plain_summary.final_cost)):
            torch.testing.assert_close(a, b)
        return
    assert float(summary.final_cost) == pytest.approx(
        float(plain_summary.final_cost), rel=1e-5)
    for a, b, x0 in ((out.extrinsics, plain.extrinsics, prob.extrinsics),
                     (out.points, plain.points, prob.points)):
        assert float((a - b).norm()) <= 3e-3 * float((b - x0).norm())


def test_spanning_groups_take_the_plain_route(monkeypatch):
    """A camera whose observations name two groups takes the plain build
    even where the kernel route is eligible."""
    prob, opts = _solve_case("per_camera", iterations=1)
    grp = prob.obs_group.clone()
    first = int(torch.nonzero(prob.obs_mask & (prob.obs_cam == 2))[0])
    grp[first] = 3
    prob = prob._replace(obs_group=grp)
    assert ba.kernel_route(prob, opts).dense_corr == "kernel"
    calls = []
    _spy(monkeypatch, ba.dcorr, "corr", calls, refuse=True)
    _spy(monkeypatch, ba, "_dense_schur_corr", calls)
    ba.bundle_adjust(prob, opts)
    assert calls == ["_dense_schur_corr"]
