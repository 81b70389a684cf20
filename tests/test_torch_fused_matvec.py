"""The port's Schur-matvec sweeps (theiasfm_tpu_torch/sfm/ba/fused_matvec.py)
against the JAX package's Pallas kernels (pallas_matvec.FusedMatvec, run
with interpret=True on the CPU), on the same numpy inputs.

On CPU tensors the port's wrappers run their plain PyTorch versions;
the CUDA kernels are held against those plain versions on the card
(`test_kernels_match_plain_on_card` here, and chip_smoke.py)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theiasfm_tpu.sfm.ba.pallas_matvec import FusedMatvec
from theiasfm_tpu.sfm.ba.pallas_matvec import MatvecPlan as JaxMatvecPlan
from theiasfm_tpu_torch.sfm.ba import fused_matvec as fm

# tolerances of tests/test_pallas_matvec.py: u is a 6+P-term sum per
# observation; wp, yc, yg are sums over many observations
U_TOL = 2e-5
SUM_TOL = 3e-4
# bf16: the TPU kernel multiplies bf16 values in bf16, the port in f32
# after upcasting, so each product may differ by one bf16 ulp (2^-8
# relative); relative to the largest reference entry
BF16_REL = 2e-2


def _rand_problem(rng, M, Nc, Np, P):
    obs_pt = np.sort(rng.integers(0, Np, M)).astype(np.int32)
    obs_cam = rng.integers(0, Nc, M).astype(np.int32)
    Jc = rng.normal(size=(M, 12)).astype(np.float32)
    Ji = rng.normal(size=(M, 2 * P)).astype(np.float32)
    Jp = rng.normal(size=(M, 6)).astype(np.float32)
    vc = rng.normal(size=(Nc, 6)).astype(np.float32)
    vg = rng.normal(size=(P,)).astype(np.float32)
    zp = rng.normal(size=(Np, 3)).astype(np.float32)
    return obs_cam, obs_pt, Jc, Ji, Jp, vc, vg, zp


def _vgmat(vg, P):
    z = np.zeros((P,), np.float32)
    return np.stack([np.concatenate([vg, z]), np.concatenate([z, vg])],
                    axis=1)                                   # (2P, 2)


def _close(got, ref, tol, bf16):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if bf16:
        err = np.max(np.abs(got - ref))
        assert err <= BF16_REL * np.max(np.abs(ref)), err
    else:
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def _run_both(Nc, transposed, bf16, M=1024, Np=100, P=1, B=256):
    rng = np.random.default_rng(0)
    obs_cam, obs_pt, Jc, Ji, Jp, vc, vg, zp = _rand_problem(
        rng, M, Nc, Np, P)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    plan = JaxMatvecPlan(obs_cam, obs_pt, Nc, Np, block=B)
    fmj = FusedMatvec(plan, P, mv_dtype=jdt, interpret=True)
    zp_pad = jnp.zeros((plan.Np_pad, 128), jnp.float32).at[:Np, :3].set(zp)
    if transposed:
        jcj, jij, jpj = (jnp.asarray(x.T, jdt) for x in (Jc, Ji, Jp))
        vc_t = jnp.zeros((6, plan.cam_pad), jnp.float32).at[:, :Nc].set(
            vc.T)
        u8, wp_j = fmj.pass1_t(jcj, jij, jpj, vc_t,
                               jnp.asarray(_vgmat(vg, P).T))
        u_j = np.asarray(u8)[:2]
        yc_j, yg_j = fmj.pass2_t(jcj, jij, jpj, u8, zp_pad)
        # the port: (F, M) tensors
        jct, jit, jpt = (torch.tensor(x.T.copy()).to(tdt)
                         for x in (Jc, Ji, Jp))
    else:
        jcj, jij, jpj = (jnp.asarray(x, jdt) for x in (Jc, Ji, Jp))
        vc_pad = jnp.zeros((plan.cam_pad, 6), jnp.float32).at[:Nc].set(vc)
        u_m, wp_j = fmj.pass1(jcj, jij, jpj, vc_pad,
                              jnp.asarray(_vgmat(vg, P)))
        u_j = np.asarray(u_m).T
        yc_j, yg_j = fmj.pass2(jcj, jij, jpj, u_m, zp_pad)
        # the port: strided .T views of (M, F) tensors
        jct, jit, jpt = (torch.tensor(x).to(tdt).T for x in (Jc, Ji, Jp))
        assert not jct.is_contiguous()
    ids = torch.tensor(obs_cam), torch.tensor(obs_pt)
    u_t, wp_t = fm.pass1(jct, jit, jpt, *ids, torch.tensor(vc),
                         torch.tensor(vg), Np)
    yc_t, yg_t = fm.pass2(jct, jit, jpt, *ids, u_t, torch.tensor(zp), Nc)
    assert u_t.shape == (2, M) and wp_t.shape == (Np, 3)
    assert yc_t.shape == (Nc, 6) and yg_t.shape == (2 * P, 2)
    _close(u_t, u_j, U_TOL, bf16)
    _close(wp_t, np.asarray(wp_j)[:Np, :3], SUM_TOL, bf16)
    _close(yc_t, np.asarray(yc_j)[:Nc, :6], SUM_TOL, bf16)
    _close(yg_t, np.asarray(yg_j)[:2 * P, :2], SUM_TOL, bf16)


@pytest.mark.parametrize("Nc", [12, 1300])
@pytest.mark.parametrize("transposed", [True, False])
def test_passes_match_pallas_f32(Nc, transposed):
    """f32, both layouts; Nc=1300 exercises JAX's chunked camera
    one-hot (256-column slabs)."""
    _run_both(Nc, transposed, bf16=False)


@pytest.mark.parametrize("transposed", [True, False])
def test_passes_match_pallas_bf16(transposed):
    """bf16 jacobians in both packages: the same rounding points."""
    _run_both(12, transposed, bf16=True)


def test_wrapper_on_other_device_raises():
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    sent down the plain path."""
    M = 32
    j = [torch.zeros(F, M, device="meta") for F in (12, 2, 6)]
    ids = torch.zeros(M, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        fm.pass1(*j, ids, ids, torch.zeros(3, 6, device="meta"),
                 torch.zeros(1, device="meta"), 4)
    with pytest.raises(RuntimeError):
        fm.pass2(*j, ids, ids, torch.zeros(2, M, device="meta"),
                 torch.zeros(4, 3, device="meta"), 3)


@pytest.mark.parametrize("P", [1, 3])
def test_plain_passes_match_dense_algebra(P):
    """The plain versions against the Schur product written densely in
    f64: u = Jc·vc[cam] + Ji·vg, wp = Σ Jpᵀu, yc = Σ Jcᵀd, yg = Ji dᵀ."""
    rng = np.random.default_rng(2)
    M, Nc, Np = 200, 7, 30
    obs_cam, obs_pt, Jc, Ji, Jp, vc, vg, zp = _rand_problem(
        rng, M, Nc, Np, P)
    js = [torch.tensor(x.T.copy()) for x in (Jc, Ji, Jp)]
    ids = torch.tensor(obs_cam), torch.tensor(obs_pt)
    u, wp = fm.pass1(*js, *ids, torch.tensor(vc), torch.tensor(vg), Np)
    yc, yg = fm.pass2(*js, *ids, u, torch.tensor(zp), Nc)
    Jc3, Ji3, Jp3 = (x.astype(np.float64).reshape(M, 2, -1)
                     for x in (Jc, Ji, Jp))
    u_ref = (np.einsum("mki,mi->mk", Jc3, vc[obs_cam]) +
             np.einsum("mkp,p->mk", Ji3, vg))
    wp_ref = np.zeros((Np, 3))
    np.add.at(wp_ref, obs_pt, np.einsum("mkc,mk->mc", Jp3, u_ref))
    d = u_ref - np.einsum("mkc,mc->mk", Jp3, zp[obs_pt])
    yc_ref = np.zeros((Nc, 6))
    np.add.at(yc_ref, obs_cam, np.einsum("mki,mk->mi", Jc3, d))
    yg_ref = Ji.astype(np.float64).T @ d
    for got, ref in ((u.T, u_ref), (wp, wp_ref), (yc, yc_ref), (yg, yg_ref)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Nc", [1, 7, 40])
def test_camera_index_segments_match_index_add(Nc):
    """Pass 2's camera index: cam_order is a stable argsort of obs_cam
    (each camera's observations stay in point order), cam_start its
    segment starts (cameras without observations give empty segments),
    and the plain segmented sum over it (stage B's plain version) equals
    index_add_ to float32 rounding."""
    rng = np.random.default_rng(9)
    M = 1000
    obs_cam = rng.integers(0, Nc, M).astype(np.int32)
    if Nc > 3:
        obs_cam[obs_cam == 3] = 2          # camera 3 has no observation
    cam_index = fm.camera_index(torch.tensor(obs_cam), Nc)
    order, start = cam_index.order, cam_index.start
    assert order.dtype == start.dtype == torch.int32
    # the kernel's workspaces live on CUDA only
    assert cam_index.y_work is None and cam_index.g_work is None
    assert (order.numpy() == np.argsort(obs_cam, kind="stable")).all()
    assert start.numpy().tolist() == [0] + np.cumsum(
        np.bincount(obs_cam, minlength=Nc)).tolist()
    y = torch.tensor(rng.normal(size=(M, 6)), dtype=torch.float32)
    ref = torch.zeros((Nc, 6)).index_add_(0, torch.tensor(obs_cam).long(), y)
    got = fm.camera_sums_plain(y, cam_index)
    assert got.shape == (Nc, 6)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sorted_pts", [True, False],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("Np", [1, 9, 300])
def test_point_index_segments_match_index_add(Np, sorted_pts):
    """The point index of pass 1 and ba_blocks: start is the bincount's
    running sum (points without observations give empty segments), order
    a stable argsort of obs_pt, or None when obs_pt is sorted (the
    solver's case), and the plain segmented sum over it equals
    index_add_ to float32 rounding."""
    rng = np.random.default_rng(12)
    M = 1000
    obs_pt = np.sort(rng.integers(0, Np, M)).astype(np.int32)
    if Np > 3:
        obs_pt[obs_pt == 3] = 2            # point 3 has no observation
    if not sorted_pts:
        obs_pt = rng.permutation(obs_pt)
    pt_index = fm.point_index(torch.tensor(obs_pt), Np)
    order, start = pt_index
    assert start.dtype == torch.int32
    assert start.numpy().tolist() == [0] + np.cumsum(
        np.bincount(obs_pt, minlength=Np)).tolist()
    if sorted_pts or Np == 1:
        assert order is None
    else:
        assert order.dtype == torch.int32
        assert (order.numpy() == np.argsort(obs_pt, kind="stable")).all()
    y = torch.tensor(rng.normal(size=(M, 12)), dtype=torch.float32)
    ref = torch.zeros((Np, 12)).index_add_(0, torch.tensor(obs_pt).long(), y)
    got = fm.point_sums_plain(y, pt_index)
    assert got.shape == (Np, 12)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sorted_pts", [True, False],
                         ids=["sorted", "unsorted"])
def test_pass1_on_cpu_ignores_point_index(sorted_pts):
    """On the CPU pass 1 runs its plain version: given the point index
    (which the CUDA kernel requires) or not, the same bits."""
    rng = np.random.default_rng(5)
    M, Nc, Np, P = 400, 9, 60, 2
    obs_cam, obs_pt, Jc, Ji, Jp, vc, vg, _ = _rand_problem(rng, M, Nc, Np, P)
    if not sorted_pts:
        obs_pt = rng.permutation(obs_pt)
    js = [torch.tensor(x.T.copy()) for x in (Jc, Ji, Jp)]
    ids = torch.tensor(obs_cam), torch.tensor(obs_pt)
    args = (*js, *ids, torch.tensor(vc), torch.tensor(vg), Np)
    u, wp = fm.pass1(*args)
    u_i, wp_i = fm.pass1(*args, fm.point_index(ids[1], Np))
    assert torch.equal(u, u_i) and torch.equal(wp, wp_i)


# ---------------------------------------------------------------------------
# the grouped sweeps (pass1_groups, pass2_groups): a group per observation


def _group_case(rng, Ng, P, by_camera, M=300, Nc=9, Np=40):
    """A problem with Ng intrinsics groups ("Nc": one per camera): the
    group a function of the camera (by_camera) or drawn per observation,
    so that one camera's observations fall in several groups."""
    obs_cam, obs_pt, Jc, Ji, Jp, vc, _, zp = _rand_problem(rng, M, Nc, Np, P)
    Ng = Nc if Ng == "Nc" else Ng
    obs_group = (obs_cam % Ng if by_camera else
                 rng.integers(0, Ng, M)).astype(np.int32)
    if not by_camera:
        assert any(len(set(obs_group[obs_cam == c])) > 1 for c in range(Nc))
    vg = rng.normal(size=(Ng, P)).astype(np.float32)
    return dict(obs_cam=obs_cam, obs_group=obs_group, obs_pt=obs_pt, Jc=Jc,
                Ji=Ji, Jp=Jp, vc=vc, vg=vg, zp=zp, Nc=Nc, Np=Np, Ng=Ng)


def _grouped_passes(c, mv):
    """The grouped wrappers on CPU tensors (their plain versions), the
    jacobians as (F, M) tensors of the matvec type."""
    js = [torch.tensor(c[k].T.copy()).to(mv) for k in ("Jc", "Ji", "Jp")]
    ids = [torch.tensor(c[k]) for k in ("obs_cam", "obs_group", "obs_pt")]
    u, wp = fm.pass1_groups(*js, *ids, torch.tensor(c["vc"]),
                            torch.tensor(c["vg"]), c["Np"])
    yc, yg = fm.pass2_groups(*js, *ids, u, torch.tensor(c["zp"]), c["Nc"],
                             c["Ng"])
    return u, wp, yc, yg


GROUP_CASES = pytest.mark.parametrize(
    "Ng,P,bf16,by_camera",
    [(Ng, P, bf16, by) for Ng in (2, "Nc") for P in (1, 3)
     for bf16 in (False, True) for by in (True, False)],
    ids=lambda v: {True: "T", False: "F"}.get(v, str(v)))


@GROUP_CASES
def test_grouped_passes_match_dense_algebra(Ng, P, bf16, by_camera):
    """The grouped plain versions against the Schur product written
    densely in f64 on the matvec type's values: u = Jc·vc[cam] +
    Ji·vg[group], wp = Σ Jpᵀu, d = u − Jp·zp[pt], yc = Σ Jcᵀd per camera,
    yg = Σ Jiᵀd per group. bf16 also rounds u, zp[pt] and d on the way."""
    c = _group_case(np.random.default_rng(21), Ng, P, by_camera)
    mv = torch.bfloat16 if bf16 else torch.float32
    u, wp, yc, yg = _grouped_passes(c, mv)
    M = c["obs_cam"].shape[0]
    assert u.shape == (2, M) and wp.shape == (c["Np"], 3)
    assert yc.shape == (c["Nc"], 6) and yg.shape == (c["Ng"], P)

    def val(x):
        return torch.tensor(x).to(mv).double().numpy()

    Jc3, Ji3, Jp3 = (val(c[k]).reshape(M, 2, -1) for k in ("Jc", "Ji", "Jp"))
    cam, grp, pt = c["obs_cam"], c["obs_group"], c["obs_pt"]
    u_ref = (np.einsum("mki,mi->mk", Jc3, val(c["vc"])[cam]) +
             np.einsum("mkp,mp->mk", Ji3, val(c["vg"])[grp]))
    wp_ref = np.zeros((c["Np"], 3))
    np.add.at(wp_ref, pt, np.einsum("mkc,mk->mc", Jp3, u_ref))
    d = u_ref - np.einsum("mkc,mc->mk", Jp3, val(c["zp"])[pt])
    yc_ref = np.zeros((c["Nc"], 6))
    np.add.at(yc_ref, cam, np.einsum("mki,mk->mi", Jc3, d))
    yg_ref = np.zeros((c["Ng"], P))
    np.add.at(yg_ref, grp, np.einsum("mkp,mk->mp", Ji3, d))
    for got, ref in ((u.T, u_ref), (wp, wp_ref), (yc, yc_ref),
                     (yg, yg_ref)):
        if bf16:
            _close(got, ref, None, True)
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-4)


@GROUP_CASES
def test_grouped_passes_match_plain_s_matvec(Ng, P, bf16, by_camera):
    """The grouped plain versions against the solver's plain S_matvec
    (bundle_adjustment.py: einsums on (M, 2, k) views, gathers and
    index_add_, with its rounding points), given the same zp."""
    c = _group_case(np.random.default_rng(22), Ng, P, by_camera)
    mv = torch.bfloat16 if bf16 else torch.float32
    u, wp, yc, yg = _grouped_passes(c, mv)
    f32 = torch.float32
    M = c["obs_cam"].shape[0]
    Jc3m, Ji3m, Jp3m = (torch.tensor(c[k]).to(mv).to(f32).reshape(M, 2, -1)
                        for k in ("Jc", "Ji", "Jp"))
    cam, grp, pt = (torch.tensor(c[k]).long()
                    for k in ("obs_cam", "obs_group", "obs_pt"))
    vc, vg, zp = (torch.tensor(c[k]) for k in ("vc", "vg", "zp"))
    u_ref = torch.einsum("mki,mi->mk", Jc3m, fm.round_mv(vc[cam], mv))
    u_ref = u_ref + torch.einsum("mkp,mp->mk", Ji3m,
                                 fm.round_mv(vg, mv)[grp])
    wp_ref = torch.zeros((c["Np"], 3)).index_add_(
        0, pt, torch.einsum("mka,mk->ma", Jp3m, fm.round_mv(u_ref, mv)))
    u2 = torch.einsum("mkj,mj->mk", Jp3m, fm.round_mv(zp[pt], mv))
    d = fm.round_mv(u_ref - u2, mv)
    yc_ref = torch.zeros((c["Nc"], 6)).index_add_(
        0, cam, torch.einsum("mki,mk->mi", Jc3m, d))
    yg_ref = torch.zeros((c["Ng"], P)).index_add_(
        0, grp, torch.einsum("mkp,mk->mp", Ji3m, d))
    # pass 2 from the reference's u, as the solver chains the two
    ids = [torch.tensor(c[k]) for k in ("obs_cam", "obs_group", "obs_pt")]
    js = [torch.tensor(c[k].T.copy()).to(mv) for k in ("Jc", "Ji", "Jp")]
    yc_u, yg_u = fm.pass2_groups(*js, *ids, u_ref.T.contiguous(), zp,
                                 c["Nc"], c["Ng"])
    for got, ref in ((u.T, u_ref), (wp, wp_ref), (yc_u, yc_ref),
                     (yg_u, yg_ref)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    # and chained from its own u: one bf16 ulp of a rounded u at most
    for got, ref in ((yc, yc_ref), (yg, yg_ref)):
        _close(got, ref, 1e-5, bf16)


@pytest.mark.parametrize("Ng", [1, 5, 40])
def test_group_index_segments_match_index_add(Ng):
    """The group index: order a stable argsort of obs_group, start its
    segment starts (groups without observations give empty segments), no
    workspace off the card; the plain segmented sum over it equals
    index_add_ to float32 rounding."""
    rng = np.random.default_rng(13)
    M, P = 1000, 3
    obs_group = rng.integers(0, Ng, M).astype(np.int32)
    if Ng > 3:
        obs_group[obs_group == 3] = 2      # group 3 has no observation
    gi = fm.group_index(torch.tensor(obs_group), Ng, P)
    assert gi.order.dtype == gi.start.dtype == torch.int32
    assert gi.g_work is None
    assert (gi.order.numpy() == np.argsort(obs_group, kind="stable")).all()
    assert gi.start.numpy().tolist() == [0] + np.cumsum(
        np.bincount(obs_group, minlength=Ng)).tolist()
    y = torch.tensor(rng.normal(size=(M, P)), dtype=torch.float32)
    ref = torch.zeros((Ng, P)).index_add_(0, torch.tensor(obs_group).long(),
                                          y)
    got = fm._segment_sums(y, gi.order, gi.start)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_grouped_wrappers_on_other_device_raise():
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    sent down the plain path."""
    M, P = 32, 3
    j = [torch.zeros(F, M, device="meta") for F in (12, 2 * P, 6)]
    ids = torch.zeros(M, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        fm.pass1_groups(*j, ids, ids, ids, torch.zeros(3, 6, device="meta"),
                        torch.zeros(2, P, device="meta"), 4)
    with pytest.raises(RuntimeError):
        fm.pass2_groups(*j, ids, ids, ids, torch.zeros(2, M, device="meta"),
                        torch.zeros(4, 3, device="meta"), 3, 2)
