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
from theiasfm_tpu.sfm.ba.pallas_matvec import PlanShapes as JaxPlanShapes
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


@pytest.mark.parametrize("Nc,Np,block", [(12, 100, 256), (1300, 700, 512)])
def test_plan_matches_jax(Nc, Np, block):
    rng = np.random.default_rng(3)
    M = 4 * block
    obs_pt = np.sort(rng.integers(0, Np, M)).astype(np.int32)
    obs_cam = rng.integers(0, Nc, M).astype(np.int32)
    pj = JaxMatvecPlan(obs_cam, obs_pt, Nc, Np, block=block)
    pt = fm.MatvecPlan(obs_cam, obs_pt, Nc, Np, block=block)
    for name in ("M", "B", "G", "Nc", "Np", "W", "Np_pad", "cam_chunk",
                 "cam_pad"):
        assert getattr(pt, name) == getattr(pj, name), name
    for name in ("tile_p0", "local_pt", "cam_tiles"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    sj = JaxPlanShapes(pj.G, pj.B, Nc, Np, pj.W)
    st = fm.PlanShapes(pt.G, pt.B, Nc, Np, pt.W)
    assert vars(st) == vars(sj)


def test_plan_rejects_unsorted():
    with pytest.raises(ValueError):
        fm.MatvecPlan(np.zeros(8, np.int32), np.array([0, 1] * 4), 1, 2,
                      block=8)


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
