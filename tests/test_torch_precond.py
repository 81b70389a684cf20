"""The SCHUR_JACOBI preconditioner's corrections on the CPU: the plain twin
of csrc/schur_precond.cu (sfm/ba/schur_precond.py corr_plain, what corr
runs on CPU tensors) against the plain route's build
(bundle_adjustment._schur_jacobi_corr), and which of the two the solver
calls on each route. The kernel itself is held to the twin on the card
(tests/test_torch_kernels_cuda.py -k precond)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from theiasfm_tpu_torch.bench_problem import make_problem
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba
from theiasfm_tpu_torch.sfm.ba import fused_matvec as fm
from theiasfm_tpu_torch.sfm.ba import schur_precond as spc
from theiasfm_tpu_torch.utils import dispatch_counts, reset_dispatch_counts

GROUPS = {"one": lambda cam: np.zeros_like(cam),
          "per_camera": lambda cam: cam,
          # each group spans several cameras
          "spanning": lambda cam: cam % 3}


def _case(groups, P, mv, Nc=10, Np=300, seed=0):
    """Observations sorted by point (2-7 a point), cameras drawn per
    observation with camera Nc - 1 left without any (and, per camera, its
    group too), random jacobians rounded to the matvec type mv and the
    Hpp⁻¹ their point blocks give. Returns the twin's arguments and the
    plain build's."""
    rng = np.random.default_rng(seed)
    obs_pt = np.repeat(np.arange(Np), rng.integers(2, 8, Np))
    M = obs_pt.size
    obs_cam = rng.integers(0, Nc - 1, M)
    obs_group = GROUPS[groups](obs_cam)
    Ng = {"one": 1, "per_camera": Nc, "spanning": 3}[groups]
    f32 = torch.float32
    jac = [torch.tensor(rng.normal(size=(F, M)), dtype=f32).to(mv)
           for F in (12, 2 * P, 6)]
    Jp3 = jac[2].to(f32).T.reshape(M, 2, 3)
    ids = [torch.tensor(x, dtype=torch.int32)
           for x in (obs_cam, obs_group, obs_pt)]
    Hpp9 = torch.zeros((Np, 9)).index_add_(
        0, ids[2], torch.einsum("mka,mkb->mab", Jp3, Jp3).reshape(M, 9))
    hinv = ba._inv3_flat(Hpp9 * 1.01, eps_diag=1e-3)
    cam_index = fm.camera_index(ids[0], Nc)
    grp_index = fm.group_index(ids[1], Ng, P) if Ng > 1 else None
    twin = (*jac, ids[2], hinv, Nc, Ng, cam_index, grp_index)
    widened = [j.to(f32).T.reshape(M, 2, -1) for j in jac]
    plain = (*widened, hinv, *ids, Nc, Ng, mv, lambda x: x)
    return twin, plain


# the twin sums only the upper triangle and mirrors it, where the plain
# build sums both halves, which differ by T's rounding; and it sums in
# segment order where index_add_ sums in storage order. On these cases
# the two read 0.7e-7 to 2.7e-7 of the largest entry apart in f32 and up
# to 6.5e-4 in bf16 (a fraction of one bf16 rounding of T, 2^-9 = 2e-3)
TOL = {torch.float32: 2e-6, torch.bfloat16: 4e-3}


@pytest.mark.parametrize("mv", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("groups", list(GROUPS))
def test_twin_matches_plain_build(groups, P, mv):
    """corr_plain against _schur_jacobi_corr at one group, a group per
    camera and groups spanning cameras: both tables within TOL of the
    largest entry, corr_cc symmetric, and the camera (and its group)
    without observations exactly zero."""
    twin, plain = _case(groups, P, mv)
    got = spc.corr(*twin)
    want = ba._schur_jacobi_corr(*plain)
    Nc, Ng = twin[5], twin[6]
    for g, w, n, S in zip(got, want, (Nc, Ng), (6, P)):
        assert g.shape == w.shape == (n, S, S) and g.dtype == torch.float32
        scale = w.abs().max().item()
        assert scale > 0
        assert (g - w).abs().max().item() <= TOL[mv] * scale
        assert torch.equal(g, g.transpose(1, 2))
    assert not got[0][Nc - 1].any()
    if groups == "per_camera":
        assert not got[1][Nc - 1].any()


def test_twin_without_observations_is_zero():
    """No observations: every camera's and group's correction is zero."""
    twin, _ = _case("per_camera", 3, torch.float32)
    jc, ji, jp, obs_pt, hinv, Nc, Ng = twin[:7]
    empty = torch.zeros(0, dtype=torch.int32)
    cc, gg = spc.corr(jc[:, :0], ji[:, :0], jp[:, :0], obs_pt[:0], hinv,
                      Nc, Ng, fm.camera_index(empty, Nc),
                      fm.group_index(empty, Ng, 3))
    assert cc.shape == (Nc, 6, 6) and gg.shape == (Ng, 3, 3)
    assert not cc.any() and not gg.any()


def _solve_case(cell, **options):
    """Venice's options (one group) or Final's (a group per camera) on a
    small problem, 3 LM iterations."""
    p = make_problem(6, 120, 4, device="cpu", perturb_seed=3)
    if cell == "final":
        p = p._replace(intrinsics=p.intrinsics.repeat(6, 1),
                       obs_group=p.obs_cam.clone())
    opts = ba.BAOptions(max_iterations=3, cg_iterations=10, loss="huber",
                        loss_scale=2.0, function_tolerance=0.0,
                        pallas_matvec=True, matvec_bf16=True,
                        optimize_intrinsics=(True,) + (False,) * 4 +
                        (True, True) + (False,) * 3)
    return ba.pad_obs_to_multiple(p, 512), dataclasses.replace(opts,
                                                                **options)


@pytest.mark.parametrize("cell,options,route", [
    ("venice", {}, "kernel"),
    ("final", {}, "kernel"),
    ("final", {"pallas_matvec": False}, "plain"),
    ("venice", {"preconditioner": "block_diag"}, None),
], ids=["venice", "final", "matvec-off", "block-diag"])
def test_solver_builds_on_its_route(monkeypatch, cell, options, route):
    """Each SCHUR_JACOBI build counts once under precond.build and calls
    schur_precond.corr on the kernel route, _schur_jacobi_corr on the
    plain one; block_diag builds neither and counts nothing. On the CPU
    the twin runs, which counts no launch."""
    prob, opts = _solve_case(cell, **options)
    assert ba.kernel_route(prob, opts).precond == (route or "plain")
    calls = []
    for mod, name in ((spc, "corr"), (ba, "_schur_jacobi_corr")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(mod, name, spy)
    reset_dispatch_counts()
    _, s = ba.bundle_adjust(prob, opts)
    builds = dispatch_counts().get("precond.build", 0)
    assert "precond_kernel" not in dispatch_counts()
    want = {"kernel": "corr", "plain": "_schur_jacobi_corr"}.get(route)
    assert calls == [want] * builds
    assert builds == (s.num_iterations if route else 0)
    assert float(s.final_cost) < float(s.initial_cost)
