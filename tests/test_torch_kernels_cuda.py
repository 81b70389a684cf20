"""The CUDA kernels against their plain PyTorch versions on the card:
the Schur-matvec passes (csrc/schur_matvec.cu, sfm/ba/fused_matvec.py)
and their grouped twins (csrc/schur_groups.cu),
the normal-equation blocks sweep (csrc/ba_blocks.cu, fused_matvec.blocks),
the dense Schur solver's correction build (csrc/dense_corr.cu,
sfm/ba/dense_corr.py), the SCHUR_JACOBI preconditioner's corrections
(csrc/schur_precond.cu, sfm/ba/schur_precond.py) and the top-2 matcher
(csrc/top2_match.cu, matching/fused_matcher.py).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without JAX; the repo's conftest imports JAX, so skip it there:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_kernels_cuda.py -q

Without a card every test skips."""
import numpy as np
import pytest
import torch

import torch_dense_cases as dense_cases
from theiasfm_tpu_torch.bench_problem import make_problem
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba
from theiasfm_tpu_torch.sfm.ba import dense_corr as dc
from theiasfm_tpu_torch.sfm.ba import fused_matvec as fm
from theiasfm_tpu_torch.sfm.ba import schur_precond as spc
from theiasfm_tpu_torch.utils import dispatch_counts, reset_dispatch_counts


def _inputs(rng, M, Nc, Np, P, sorted_pts, dtype):
    obs_pt = np.sort(rng.integers(0, Np, M))
    if not sorted_pts:
        obs_pt = rng.permutation(obs_pt)
    obs_cam = rng.integers(0, Nc, M)
    dev = "cuda"

    def t(x, dt=torch.float32):
        return torch.tensor(x, device=dev).to(dt)

    jac = [rng.normal(size=(M, F)) for F in (12, 2 * P, 6)]
    return dict(
        ids=(t(obs_cam, torch.int32), t(obs_pt, torch.int32)),
        js_t=[t(x.T.copy(), dtype) for x in jac],
        js_row=[t(x, dtype).T for x in jac],
        vc=t(rng.normal(size=(Nc, 6))), vg=t(rng.normal(size=(P,))),
        zp=t(rng.normal(size=(Np, 3))))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sorted_pts", [True, False],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("Nc", [40, 1300, 12000],
                         ids=["nc40", "nc1300", "nc12000"])
def test_kernels_match_plain_on_card(bf16, sorted_pts, Nc):
    """Both layouts; unsorted point ids take pass 1 through the point
    order (one value per load); pass 2 takes one path at every camera
    count. Tolerance relative to max|ref|: the point and camera segments
    reorder the f32 sums, and under bf16 a rounded intermediate may land
    one bf16 ulp apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Np, P = 3000, 500, 2
    x = _inputs(np.random.default_rng(1), M, Nc, Np, P, sorted_pts,
                torch.bfloat16 if bf16 else torch.float32)
    tol = 1e-2 if bf16 else 1e-4
    cam_index = fm.camera_index(x["ids"][0], Nc)
    pt_index = fm.point_index(x["ids"][1], Np)
    assert (pt_index.order is None) == sorted_pts
    for js in (x["js_t"], x["js_row"]):
        reset_dispatch_counts()
        u, wp = fm.pass1(*js, *x["ids"], x["vc"], x["vg"], Np, pt_index)
        u_ref, wp_ref = fm.pass1_plain(*js, *x["ids"], x["vc"], x["vg"], Np)
        yc, yg = fm.pass2(*js, *x["ids"], u_ref, x["zp"], Nc, cam_index)
        yc_ref, yg_ref = fm.pass2_plain(*js, *x["ids"], u_ref, x["zp"], Nc)
        torch.cuda.synchronize()
        assert dispatch_counts() == {"schur_pass1": 1, "schur_pass2": 1}
        for got, ref in ((u, u_ref), (wp, wp_ref), (yc, yc_ref),
                         (yg, yg_ref)):
            err = (got - ref).abs().max().item()
            assert err <= tol * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pass2_bitwise_repeatable_on_card(bf16):
    """pass 2 takes no atomics: two launches on the same inputs give the
    same bits, through one camera index (its workspace reused) and
    through a second one built anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Nc, Np, P = 200_000, 550, 50_000, 1
    x = _inputs(np.random.default_rng(4), M, Nc, Np, P, True,
                torch.bfloat16 if bf16 else torch.float32)
    u, _ = fm.pass1_plain(*x["js_t"], *x["ids"], x["vc"], x["vg"], Np)
    cam_index = fm.camera_index(x["ids"][0], Nc)
    a = fm.pass2(*x["js_t"], *x["ids"], u, x["zp"], Nc, cam_index)
    b = fm.pass2(*x["js_t"], *x["ids"], u, x["zp"], Nc, cam_index)
    c = fm.pass2(*x["js_t"], *x["ids"], u, x["zp"], Nc,
                 fm.camera_index(x["ids"][0], Nc))
    torch.cuda.synchronize()
    for p, q, r in zip(a, b, c):
        assert torch.equal(p, q) and torch.equal(p, r)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pass1_bitwise_repeatable_on_card(bf16):
    """pass 1 takes no atomics: two launches on the same inputs give the
    same bits, in both layouts, with the point index built once and built
    anew; and with a ragged last tile (M not a multiple of 1024)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Nc, Np, P = 200_004, 550, 50_000, 1
    x = _inputs(np.random.default_rng(7), M, Nc, Np, P, True,
                torch.bfloat16 if bf16 else torch.float32)
    args = (*x["ids"], x["vc"], x["vg"], Np)
    pt_index = fm.point_index(x["ids"][1], Np)
    for js in (x["js_t"], x["js_row"]):
        a = fm.pass1(*js, *args, pt_index)
        b = fm.pass1(*js, *args, pt_index)
        c = fm.pass1(*js, *args, fm.point_index(x["ids"][1], Np))
        torch.cuda.synchronize()
        for p, q, r in zip(a, b, c):
            assert torch.equal(p, q) and torch.equal(p, r)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_card():
    """The CUDA wrappers raise on what the kernels do not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Nc, Np = 64, 4, 8
    x = _inputs(np.random.default_rng(0), M, Nc, Np, 1, True, torch.float32)
    js, (oc, op) = x["js_t"], x["ids"]
    with pytest.raises(ValueError):
        fm.pass1(*js, oc.long(), op, x["vc"], x["vg"], Np)
    with pytest.raises(TypeError):
        fm.pass1(js[0].half(), *js[1:], oc, op, x["vc"], x["vg"], Np)
    with pytest.raises(RuntimeError):
        fm.pass1(*js, oc, op, x["vc"].cpu(), x["vg"], Np)
    # pass 1 on the card needs the point index of the card's obs_pt
    with pytest.raises(ValueError):
        fm.pass1(*js, oc, op, x["vc"], x["vg"], Np)
    with pytest.raises(RuntimeError):
        fm.pass1(*js, oc, op, x["vc"], x["vg"], Np,
                 fm.point_index(op.cpu(), Np))
    with pytest.raises(ValueError):
        fm.pass1(*js, oc, op, x["vc"], x["vg"], Np + 1,
                 fm.point_index(op, Np))
    # pass 2 on the card needs the camera index of the card's obs_cam
    u, zp = x["vc"].new_zeros(2, M), x["zp"]
    with pytest.raises(ValueError):
        fm.pass2(*js, oc, op, u, zp, Nc)
    with pytest.raises(ValueError):
        fm.pass2(*js, oc, op, u, zp, Nc, fm.camera_index(oc.cpu(), Nc))
    with pytest.raises(ValueError):
        fm.pass2(*js, oc, op, u, zp, Nc + 1, fm.camera_index(oc, Nc))


def _group_inputs(rng, M, Nc, Np, P, sorted_pts, dtype, groups):
    """_inputs with intrinsics groups: "cam" one per camera (obs_group =
    obs_cam), 2 (a function of the camera), or "obs" (drawn per
    observation, so a camera's observations fall in several groups)."""
    x = _inputs(rng, M, Nc, Np, P, sorted_pts, dtype)
    oc = x["ids"][0]
    if groups == "obs":
        Ng = 7
        og = torch.tensor(rng.integers(0, Ng, M), dtype=torch.int32,
                          device="cuda")
    else:
        Ng = Nc if groups == "cam" else groups
        og = (oc % Ng).contiguous()
    x["Ng"] = Ng
    x["ids"] = (oc, og, x["ids"][1])
    x["vg"] = torch.tensor(rng.normal(size=(Ng, P)), dtype=torch.float32,
                           device="cuda")
    x["index"] = (fm.point_index(x["ids"][2], Np),
                  fm.camera_index(oc, Nc), fm.group_index(og, Ng, P))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sorted_pts", [True, False],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("groups", ["cam", 2, "obs"])
def test_grouped_kernels_match_plain_on_card(bf16, sorted_pts, P, groups):
    """pass1_groups and pass2_groups against their plain versions, in both
    layouts, with a group per camera, two groups, and groups that are not
    a function of the camera. Tolerance relative to max|ref|: the
    segments reorder the f32 sums, and under bf16 a rounded intermediate
    may land one bf16 ulp apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Nc, Np = 3000, 300, 500
    x = _group_inputs(np.random.default_rng(11), M, Nc, Np, P, sorted_pts,
                      torch.bfloat16 if bf16 else torch.float32, groups)
    tol = 1e-2 if bf16 else 1e-4
    pt_index, cam_index, grp_index = x["index"]
    Ng = x["Ng"]
    for js in (x["js_t"], x["js_row"]):
        reset_dispatch_counts()
        u, wp = fm.pass1_groups(*js, *x["ids"], x["vc"], x["vg"], Np,
                                pt_index)
        u_ref, wp_ref = fm.pass1_groups_plain(*js, *x["ids"], x["vc"],
                                              x["vg"], Np)
        yc, yg = fm.pass2_groups(*js, *x["ids"], u_ref, x["zp"], Nc, Ng,
                                 cam_index, grp_index)
        yc_ref, yg_ref = fm.pass2_groups_plain(*js, *x["ids"], u_ref,
                                               x["zp"], Nc, Ng)
        torch.cuda.synchronize()
        assert dispatch_counts() == {"schur_pass1_groups": 1,
                                     "schur_pass2_groups": 1}
        for got, ref in ((u, u_ref), (wp, wp_ref), (yc, yc_ref),
                         (yg, yg_ref)):
            assert got.shape == ref.shape
            err = (got - ref).abs().max().item()
            assert err <= tol * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_grouped_kernels_bitwise_repeatable_on_card(bf16):
    """The grouped kernels take no atomics: two launches on the same
    inputs give the same bits, in both layouts, with the indices built
    once and built anew; and with a ragged last tile (M not a multiple of
    1024)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Nc, Np, P = 200_004, 550, 50_000, 3
    x = _group_inputs(np.random.default_rng(17), M, Nc, Np, P, True,
                      torch.bfloat16 if bf16 else torch.float32, "cam")
    oc, og, op = x["ids"]
    Ng = x["Ng"]
    u0, _ = fm.pass1_groups_plain(*x["js_t"], *x["ids"], x["vc"], x["vg"],
                                  Np)
    for js in (x["js_t"], x["js_row"]):
        runs = []
        for index in (x["index"], x["index"],
                      (fm.point_index(op, Np), fm.camera_index(oc, Nc),
                       fm.group_index(og, Ng, P))):
            runs.append(fm.pass1_groups(*js, *x["ids"], x["vc"], x["vg"],
                                        Np, index[0]) +
                        fm.pass2_groups(*js, *x["ids"], u0, x["zp"], Nc, Ng,
                                        *index[1:]))
        torch.cuda.synchronize()
        for p, q, r in zip(*runs):
            assert torch.equal(p, q) and torch.equal(p, r)


@pytest.mark.cuda
def test_grouped_wrappers_reject_bad_inputs_on_card():
    """The grouped wrappers raise on what the kernels do not take: no
    point index, no group index or one built off the card, a vg that is
    not (Ng, P), int64 group ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Nc, Np, P = 64, 4, 8, 3
    x = _group_inputs(np.random.default_rng(0), M, Nc, Np, P, True,
                      torch.float32, "cam")
    js, (oc, og, op) = x["js_t"], x["ids"]
    pt_index, cam_index, grp_index = x["index"]
    vc, vg, zp = x["vc"], x["vg"], x["zp"]
    with pytest.raises(ValueError):
        fm.pass1_groups(*js, oc, og, op, vc, vg, Np)
    with pytest.raises(ValueError):
        fm.pass1_groups(*js, oc, og, op, vc, vg[:, :2], Np, pt_index)
    with pytest.raises(ValueError):
        fm.pass1_groups(*js, oc, og.long(), op, vc, vg, Np, pt_index)
    u = vc.new_zeros(2, M)
    with pytest.raises(ValueError):
        fm.pass2_groups(*js, oc, og, op, u, zp, Nc, Nc, cam_index)
    with pytest.raises(ValueError):
        fm.pass2_groups(*js, oc, og, op, u, zp, Nc, Nc, cam_index,
                        fm.group_index(og.cpu(), Nc, P))
    with pytest.raises(ValueError):
        fm.pass2_groups(*js, oc, og, op, u, zp, Nc, Nc + 1, cam_index,
                        grp_index)


def _blocks_inputs(rng, M, Nc, Np, P, sorted_pts):
    x = _inputs(rng, M, Nc, Np, P, sorted_pts, torch.float32)
    r = torch.tensor(rng.normal(size=(M, 2)), dtype=torch.float32,
                     device="cuda")
    x["rows"] = [j.T.contiguous() for j in x["js_t"]] + [r]
    x["views"] = [j.T for j in x["js_t"]] + [r.T.contiguous().T]
    oc, op = x["ids"]
    x["index"] = dict(cam_index=fm.camera_index(oc, Nc),
                      pt_index=fm.point_index(op, Np))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("sorted_pts", [True, False],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("Nc", [40, 1300, 12000],
                         ids=["nc40", "nc1300", "nc12000"])
def test_ba_blocks_matches_plain_on_card(P, sorted_pts, Nc):
    """ba_blocks against blocks_plain: (M, F) tensors (aligned row loads)
    and strided .T views of (F, M) ones (one value per load); unsorted
    point ids take the point sweep through the point order. One path at
    every camera count (12,000 was the global-atomics case of the earlier
    design). Tolerance 1e-4 of max|ref| per output: the segments reorder
    the f32 sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Np = 5000, 700
    x = _blocks_inputs(np.random.default_rng(3), M, Nc, Np, P, sorted_pts)
    for js in (x["rows"], x["views"]):
        reset_dispatch_counts()
        got = fm.blocks(*js, *x["ids"], Nc, Np, **x["index"])
        ref = fm.blocks_plain(*js, *x["ids"], Nc, Np)
        torch.cuda.synchronize()
        assert dispatch_counts() == {"ba_blocks": 1}
        for g, f in zip(got, ref):
            assert g.shape == f.shape
            err = (g - f).abs().max().item()
            assert err <= 1e-4 * f.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("Nc", [40, 1300, 12000],
                         ids=["nc40", "nc1300", "nc12000"])
def test_ba_blocks_bitwise_repeatable_on_card(P, Nc):
    """ba_blocks takes no atomics: two launches on the same inputs give
    the same bits, for rows and views, with the indices built once and
    built anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Np = 60_000, 15_000
    x = _blocks_inputs(np.random.default_rng(8), M, Nc, Np, P, True)
    oc, op = x["ids"]
    for js in (x["rows"], x["views"]):
        a = fm.blocks(*js, oc, op, Nc, Np, **x["index"])
        b = fm.blocks(*js, oc, op, Nc, Np, **x["index"])
        c = fm.blocks(*js, oc, op, Nc, Np,
                      cam_index=fm.camera_index(oc, Nc),
                      pt_index=fm.point_index(op, Np))
        torch.cuda.synchronize()
        for p, q, r in zip(a, b, c):
            assert torch.equal(p, q) and torch.equal(p, r)


@pytest.mark.cuda
def test_ba_blocks_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M = 64
    j = [torch.zeros(M, F, device="cuda") for F in (12, 2, 6, 2)]
    ids = torch.zeros(M, dtype=torch.int32, device="cuda")
    index = dict(cam_index=fm.camera_index(ids, 3),
                 pt_index=fm.point_index(ids, 4))
    fm.blocks(*j, ids, ids, 3, 4, **index)
    # the kernel needs both indices, built for these cameras and points
    with pytest.raises(ValueError):
        fm.blocks(*j, ids, ids, 3, 4)
    with pytest.raises(ValueError):
        fm.blocks(*j, ids, ids, 3, 4, cam_index=index["cam_index"])
    with pytest.raises(ValueError):
        fm.blocks(*j, ids, ids, 3, 5, **index)
    with pytest.raises(TypeError):
        fm.blocks(j[0].double(), *j[1:], ids, ids, 3, 4)
    with pytest.raises(ValueError):
        fm.blocks(*j, ids.long(), ids, 3, 4)
    with pytest.raises(ValueError):
        fm.blocks(j[0][:, :11], *j[1:], ids, ids, 3, 4)
    with pytest.raises(RuntimeError):
        fm.blocks(*j[:3], j[3].cpu(), ids, ids, 3, 4)


@pytest.mark.cuda
def test_bucketed_one_group_launches_the_kernels_on_card():
    """A one-group float32 problem that bundle_adjust_bucketed pads to 512
    observations runs every Schur product through schur_pass1 and
    schur_pass2, one launch each a product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob = make_problem(8, 100, 4, dtype=torch.float32, device="cuda",
                        perturb_seed=3)
    assert ba.pad_ba_problem(prob).obs_cam.shape[0] == 512
    opts = ba.BAOptions(max_iterations=3, cg_iterations=10, loss="huber",
                        loss_scale=2.0, function_tolerance=0.0,
                        pallas_matvec=True)
    reset_dispatch_counts()
    _, s = ba.bundle_adjust_bucketed(prob, opts)
    torch.cuda.synchronize()
    c = dispatch_counts()
    assert c["schur_matvec"] > 0
    assert c.get("schur_pass1", 0) == c.get("schur_pass2", 0) == \
        c["schur_matvec"]
    assert float(s.final_cost) < float(s.initial_cost)


# -------------------------------------------------------- schur_precond

def _precond_inputs(rng, M, Nc, Np, P, sorted_pts, dtype, groups):
    """_group_inputs with groups "one" (Ng = 1) or "cam" (a group per
    camera), and the Hpp⁻¹ of the point blocks the jacobians give:
    (schur_precond.corr's arguments after the jacobians, Ng)."""
    x = _group_inputs(rng, M, Nc, Np, P, sorted_pts, dtype,
                      1 if groups == "one" else "cam")
    oc, og, op = x["ids"]
    Jp3 = x["js_t"][2].float().T.reshape(M, 2, 3)
    Hpp9 = torch.zeros((Np, 9), device="cuda").index_add_(
        0, op, torch.einsum("mka,mkb->mab", Jp3, Jp3).reshape(M, 9))
    hinv = ba._inv3_flat(Hpp9 * 1.01, eps_diag=1e-3)
    Ng = x["Ng"]
    grp_index = x["index"][2] if Ng > 1 else None
    return x, (op, hinv, Nc, Ng, x["index"][1], grp_index)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sorted_pts", [True, False],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("groups", ["one", "cam"])
def test_schur_precond_matches_plain_on_card(bf16, sorted_pts, P, groups):
    """The kernel against corr_plain on the same card tensors, (F, M) rows
    and strided .T views of (M, F) ones, one group (stage A's block
    partials) and a group per camera (the group segments). Tolerance
    relative to max|ref| per table: the segments and the block partials
    reorder the f32 sums (1e-4), and under bf16 a rounded V or T may land
    one bf16 ulp apart where the kernel's FMA and the plain einsum round
    a product differently (1e-2, as for the other kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Nc, Np = 6000, 300, 900
    x, rest = _precond_inputs(np.random.default_rng(5), M, Nc, Np, P,
                              sorted_pts,
                              torch.bfloat16 if bf16 else torch.float32,
                              groups)
    tol = 1e-2 if bf16 else 1e-4
    for js in (x["js_t"], x["js_row"]):
        reset_dispatch_counts()
        got = spc.corr(*js, *rest)
        ref = spc.corr_plain(*js, *rest)
        torch.cuda.synchronize()
        assert dispatch_counts() == {"precond_kernel": 1}
        for g, f in zip(got, ref):
            assert g.shape == f.shape and g.dtype == torch.float32
            assert torch.equal(g, g.transpose(1, 2))
            err = (g - f).abs().max().item()
            assert err <= tol * f.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("groups", ["one", "cam"])
@pytest.mark.parametrize("Nc", [40, 12000], ids=["nc40", "nc12000"])
def test_schur_precond_bitwise_repeatable_on_card(groups, Nc):
    """No atomics: two launches on the same inputs give the same bits,
    with the indices built once and built anew; a camera without
    observations gets exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Np, P = 60_000, 15_000, 3
    x, rest = _precond_inputs(np.random.default_rng(9), M, Nc, Np, P, True,
                              torch.bfloat16, groups)
    oc, og, op = x["ids"]
    _, hinv, _, Ng, _, _ = rest
    fresh = (op, hinv, Nc, Ng, fm.camera_index(oc, Nc),
             fm.group_index(og, Ng, P) if Ng > 1 else None)
    a = spc.corr(*x["js_t"], *rest)
    b = spc.corr(*x["js_t"], *rest)
    c = spc.corr(*x["js_t"], *fresh)
    torch.cuda.synchronize()
    for p, q, r in zip(a, b, c):
        assert torch.equal(p, q) and torch.equal(p, r)
    seen = torch.zeros(Nc, dtype=torch.bool, device="cuda")
    seen[oc.long()] = True
    assert not a[0][~seen].any()


@pytest.mark.cuda
def test_schur_precond_rejects_bad_inputs_on_card():
    """Wrong device, type, shape, P above 10, indices built for other
    cameras or groups, a missing group index: each raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, Nc, Np, P = 256, 8, 40, 2
    x, rest = _precond_inputs(np.random.default_rng(2), M, Nc, Np, P, True,
                              torch.float32, "cam")
    js = x["js_t"]
    op, hinv, _, Ng, cam_index, grp_index = rest
    spc.corr(*js, *rest)
    with pytest.raises(RuntimeError):
        spc.corr(*js, op, hinv.cpu(), Nc, Ng, cam_index, grp_index)
    with pytest.raises(RuntimeError):
        spc.corr(*js, op, hinv, Nc, Ng,
                 fm.camera_index(x["ids"][0].cpu(), Nc), grp_index)
    with pytest.raises(TypeError):
        spc.corr(js[0].double(), *js[1:], *rest)
    with pytest.raises(TypeError):
        spc.corr(js[0], js[1].bfloat16(), js[2], *rest)
    with pytest.raises(ValueError):
        spc.corr(js[0][:11], *js[1:], *rest)
    with pytest.raises(ValueError):
        spc.corr(js[0], torch.zeros(22, M, device="cuda"), js[2], *rest)
    with pytest.raises(ValueError):
        spc.corr(*js, op, hinv.double(), Nc, Ng, cam_index, grp_index)
    with pytest.raises(ValueError):
        spc.corr(*js, op.long(), hinv, Nc, Ng, cam_index, grp_index)
    with pytest.raises(ValueError):
        spc.corr(*js, op, hinv, Nc + 1, Ng, cam_index, grp_index)
    with pytest.raises(ValueError):
        spc.corr(*js, op, hinv, Nc, Ng, None, grp_index)
    with pytest.raises(ValueError):
        spc.corr(*js, op, hinv, Nc, Ng, cam_index, None)
    with pytest.raises(ValueError):
        spc.corr(*js, op, hinv, Nc, Ng + 1, cam_index, grp_index)
    with pytest.raises(ValueError):
        spc.corr(*js, op, hinv, Nc, 0, cam_index, grp_index)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", ["one", "cam"])
def test_pcg_solve_builds_precond_through_the_kernel_on_card(groups):
    """A short PCG solve on the kernel route (pallas_matvec, bf16, one
    group or a group per camera) launches schur_precond once per
    SCHUR_JACOBI build, and lowers the cost."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob = make_problem(8, 300, 4, dtype=torch.float32, device="cuda",
                        perturb_seed=3)
    if groups == "cam":
        prob = prob._replace(intrinsics=prob.intrinsics.repeat(8, 1),
                             obs_group=prob.obs_cam.clone())
    prob = ba.pad_obs_to_multiple(prob, 512)
    opts = ba.BAOptions(max_iterations=3, cg_iterations=10, loss="huber",
                        loss_scale=2.0, function_tolerance=0.0,
                        pallas_matvec=True, matvec_bf16=True)
    assert ba.kernel_route(prob, opts).precond == "kernel"
    reset_dispatch_counts()
    _, s = ba.bundle_adjust(prob, opts)
    torch.cuda.synchronize()
    c = dispatch_counts()
    assert c["precond.build"] == s.num_iterations
    assert c.get("precond_kernel", 0) == c["precond.build"]
    assert float(s.final_cost) < float(s.initial_cost)


# ----------------------------------------------------------- dense_corr

def _dense_case(groups, P, long=600):
    """A dense-solver problem on the card in f32 (tests/torch_dense_cases:
    masked and padded observations, points seen once, cameras 0 and 1
    sharing `long` points), its pair layout and the kernel's inputs."""
    prob, *xs = dense_cases.problem(3, groups, P, dtype=torch.float32,
                                    device="cuda", long=long)
    _, layout = dc.pair_layout(prob)
    return prob, layout, xs


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3, 10])
@pytest.mark.parametrize("groups", ["one", "per_camera", "shared"])
def test_dense_corr_matches_plain_on_card(groups, P):
    """The four tables against _dense_schur_corr in f32 on the card and in
    f64. Cameras 0 and 1 share 600 points, so their segment and their two
    diagonal ones run over three chunks or more. Tolerance: each table
    within 4x the plain f32 build's own distance from f64, or 16 u of its
    largest entry (u = 2^-24) where that is smaller: the kernel sums the
    same products in another fixed order (in registers, a butterfly, the
    chunks in order), which may land a few roundings apart, and no more
    (the plain f32 build reads 2e-6 to 2e-5 of the largest entry from
    f64 on these problems, the camera-group table the most)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob, layout, (Jc, Ji, Jp, H) = _dense_case(groups, P)
    assert layout is not None
    assert int((layout.seg_start[1:] - layout.seg_start[:-1]).max()) > \
        2 * dc.CHUNK
    Ng = prob.intrinsics.shape[0]
    reset_dispatch_counts()
    got = dc.corr(layout, Jc, Ji, Jp, H, prob.obs_pt, Ng)
    torch.cuda.synchronize()
    assert dispatch_counts() == {"dense_corr_kernel": 1}
    ref32 = dense_cases.plain(prob, Jc, Ji, Jp, H)
    prob64 = prob._replace(points=prob.points.double())
    ref64 = dense_cases.plain(prob64, Jc.double(), Ji.double(), Jp.double(),
                              H.double())
    u = 2.0 ** -24
    for name, g, r32, r64 in zip(("cc", "cg", "gg", "Hcg"), got, ref32,
                                 ref64):
        assert g.shape == r32.shape and g.dtype == torch.float32, name
        scale = r64.abs().max().item()
        err = (g.double() - r64).abs().max().item()
        err32 = (r32.double() - r64).abs().max().item()
        assert err <= max(4 * err32, 16 * u * scale), (name, err, err32)


@pytest.mark.cuda
def test_dense_corr_bitwise_repeatable_on_card():
    """No atomics: two builds give the same bits; a build makes no
    synchronizing call (torch's sync debug mode set to raise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob, layout, xs = _dense_case("per_camera", 3)
    args = (layout, *xs, prob.obs_pt, prob.intrinsics.shape[0])
    first = dc.corr(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = dc.corr(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(map(torch.equal, first, again))


@pytest.mark.cuda
def test_dense_corr_rejects_bad_inputs_on_card():
    """The wrapper raises on what the kernels do not take: f64 or
    non-contiguous jacobians, a tensor off the card, int64 ids, a layout
    of other shapes, P outside 1..10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob, layout, (Jc, Ji, Jp, H) = _dense_case("shared", 3, long=0)
    Ng, op = prob.intrinsics.shape[0], prob.obs_pt
    with pytest.raises(ValueError):
        dc.corr(layout, Jc.double(), Ji, Jp, H, op, Ng)
    with pytest.raises(ValueError):
        dc.corr(layout, Jc.T.contiguous().T, Ji, Jp, H, op, Ng)
    with pytest.raises(RuntimeError):
        dc.corr(layout, Jc, Ji, Jp, H.cpu(), op, Ng)
    with pytest.raises(RuntimeError):
        dc.corr(layout._replace(k=layout.k.cpu()), Jc, Ji, Jp, H, op, Ng)
    with pytest.raises(ValueError):
        dc.corr(layout, Jc, Ji, Jp, H, op.long(), Ng)
    with pytest.raises(ValueError):
        dc.corr(layout, Jc, Ji, Jp, H, op, Ng + 1)
    with pytest.raises(ValueError):
        dc.corr(layout._replace(seg_start=layout.seg_start[:-1]), Jc, Ji,
                Jp, H, op, Ng)
    with pytest.raises(ValueError):
        dc.corr(layout, Jc, Ji.new_zeros(Ji.shape[0], 22), Jp, H, op, Ng)


# ----------------------------------------------------------- top2_match

def _top2_agree(got, ref):
    """The kernel against its plain version: idx identical except at
    near-ties (|best − second| ≤ 1e-5·|best| in the plain result), best
    and second to 1e-5 of the largest entry (the two sum the float32
    products in another order)."""
    (gb, gs, gi), (rb, rs, ri) = [[t.cpu().numpy() for t in x]
                                  for x in (got, ref)]
    near_tie = np.abs(rs - rb) <= 1e-5 * np.abs(rb)
    assert (gi == ri)[~near_tie].all()
    for g, r in ((gb, rb), (gs, rs)):
        # with a single key the second distance is inf on both sides
        fin = np.isfinite(r)
        assert (g[~fin] == r[~fin]).all()
        if fin.any():
            assert np.abs(g - r)[fin].max() <= 1e-5 * np.abs(r[fin]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,N,D", [(3, 200, 200, 32), (1, 300, 700, 100),
                                     (2, 64, 1, 7), (1, 130, 129, 256),
                                     (28, 2048, 2048, 64)])
def test_top2_match_matches_plain_on_card(B, M, N, D):
    """Ragged M, N and D (neither a tile multiple), a single key, D =
    256, and the AKAZE matcher's chunk (28 pairs of 2048 rows, D = 64:
    four k-chunks of 16); a fifth of the keys masked to 1e30."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from theiasfm_tpu_torch.matching import fused_matcher as tfm
    rng = np.random.default_rng(2)
    d1 = torch.tensor(rng.normal(size=(B, M, D)), dtype=torch.float32,
                      device="cuda")
    d2 = torch.tensor(rng.normal(size=(B, N, D)), dtype=torch.float32,
                      device="cuda")
    n2 = (d2 * d2).sum(-1)
    n2 = torch.where(torch.rand(B, N, device="cuda") < 0.2, 1e30, n2)
    reset_dispatch_counts()
    got = tfm.top2(d1, d2, n2)
    torch.cuda.synchronize()
    assert dispatch_counts() == {"top2_match": 1}
    _top2_agree(got, tfm.top2_plain(d1, d2, n2))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [100, 7])
def test_top2_match_wide_ctas_on_card(D):
    """Many pairs (several waves of CTAs), ragged M and N over both
    CTAs of a cluster, both copy widths, and equal keys in both halves
    of the key tiles: the lowest index wins across the cluster's merge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from theiasfm_tpu_torch.matching import fused_matcher as tfm
    rng = np.random.default_rng(6)
    B, M, N = 300, 130, 300
    d1 = rng.normal(size=(B, M, D)).astype(np.float32)
    d2 = rng.normal(size=(B, N, D)).astype(np.float32)
    d2[:, 140] = d2[:, 3]
    d2[:, 290] = d2[:, 3]
    d1[:, 0] = d2[:, 3] + np.float32(0.01)
    d1, d2 = (torch.tensor(x, device="cuda") for x in (d1, d2))
    n2 = (d2 * d2).sum(-1)
    got = tfm.top2(d1, d2, n2)
    torch.cuda.synchronize()
    _top2_agree(got, tfm.top2_plain(d1, d2, n2))
    assert (got[2][:, 0] == 3).all()
    assert torch.equal(got[0][:, 0], got[1][:, 0])


@pytest.mark.cuda
def test_top2_match_ties_on_card():
    """Equal keys 5, 40 and 300 (in three key tiles of the kernel): the
    lowest index wins and the duplicate is the second distance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from theiasfm_tpu_torch.matching import fused_matcher as tfm
    rng = np.random.default_rng(5)
    d2 = rng.normal(size=(600, 16)).astype(np.float32)
    d2[40] = d2[300] = d2[5]
    d1 = d2[[5, 7]] + np.float32(0.01)
    d1, d2 = (torch.tensor(x, device="cuda")[None] for x in (d1, d2))
    best, second, idx = tfm.top2(d1, d2, (d2 * d2).sum(-1))
    assert idx[0, 0].item() == 5 and idx[0, 1].item() == 7
    assert second[0, 0].item() == best[0, 0].item()


@pytest.mark.cuda
def test_top2_wrapper_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from theiasfm_tpu_torch.matching import fused_matcher as tfm
    d = torch.zeros((1, 8, 16), device="cuda")
    n = torch.zeros((1, 8), device="cuda")
    with pytest.raises(ValueError):
        tfm.top2(d.double(), d, n)
    with pytest.raises(ValueError):
        tfm.top2(torch.zeros((1, 16, 8), device="cuda").transpose(1, 2),
                 d, n)
    with pytest.raises(ValueError):
        tfm.top2(d, d, torch.zeros((1, 9), device="cuda"))
    with pytest.raises(RuntimeError):
        tfm.top2(d, d.cpu(), n)
