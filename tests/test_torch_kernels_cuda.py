"""The CUDA kernels against their plain PyTorch versions on the card:
the Schur-matvec passes (csrc/schur_matvec.cu, sfm/ba/fused_matvec.py),
the normal-equation blocks sweep (csrc/ba_blocks.cu, fused_matvec.blocks)
and the top-2 matcher (csrc/top2_match.cu, matching/fused_matcher.py).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without JAX; the repo's conftest imports JAX, so skip it there:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_kernels_cuda.py -q

Without a card every test skips."""
import numpy as np
import pytest
import torch

from theiasfm_tpu_torch.sfm.ba import fused_matvec as fm
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
