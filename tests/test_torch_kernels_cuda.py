"""The CUDA kernels against their plain PyTorch versions on the card:
the Schur-matvec passes (csrc/schur_matvec.cu, sfm/ba/fused_matvec.py)
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
@pytest.mark.parametrize("Nc", [40, 12000], ids=["shared", "global"])
def test_kernels_match_plain_on_card(bf16, sorted_pts, Nc):
    """Both layouts; unsorted point ids exercise the warp run detection,
    Nc=12000 the global-atomics camera path of pass 2. Tolerance relative
    to max|ref|: atomics reorder the f32 sums, and under bf16 a rounded
    intermediate may land one bf16 ulp apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if Nc == 12000:
        assert fm.pass2_camera_path(Nc) == "global"
    M, Np, P = 3000, 500, 2
    x = _inputs(np.random.default_rng(1), M, Nc, Np, P, sorted_pts,
                torch.bfloat16 if bf16 else torch.float32)
    tol = 1e-2 if bf16 else 1e-4
    for js in (x["js_t"], x["js_row"]):
        reset_dispatch_counts()
        u, wp = fm.pass1(*js, *x["ids"], x["vc"], x["vg"], Np)
        u_ref, wp_ref = fm.pass1_plain(*js, *x["ids"], x["vc"], x["vg"], Np)
        yc, yg = fm.pass2(*js, *x["ids"], u_ref, x["zp"], Nc)
        yc_ref, yg_ref = fm.pass2_plain(*js, *x["ids"], u_ref, x["zp"], Nc)
        torch.cuda.synchronize()
        assert dispatch_counts() == {"schur_pass1": 1, "schur_pass2": 1}
        for got, ref in ((u, u_ref), (wp, wp_ref), (yc, yc_ref),
                         (yg, yg_ref)):
            err = (got - ref).abs().max().item()
            assert err <= tol * ref.abs().max().item(), err


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
                                     (2, 64, 1, 7), (1, 130, 129, 256)])
def test_top2_match_matches_plain_on_card(B, M, N, D):
    """Ragged M, N and D (neither a tile multiple), a single key, and
    D = 256; a fifth of the keys masked to 1e30."""
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
