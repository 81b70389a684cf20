"""Sparse Levenberg–Marquardt bundle adjustment with Schur-complement
reduction, in PyTorch (port of theiasfm_tpu/sfm/ba/bundle_adjustment.py).

  * The problem is a struct of tensors: observations in COO form
    (camera, intrinsics group, point, pixel) with a mask. One
    torch.func.vmap(jacrev(...)) evaluates all per-observation
    residual jacobians (2x6 camera, 2xP intrinsics, 2x3 point).
  * The point block of the Hessian is block-diagonal 3x3, inverted in
    closed form, batched.
  * The reduced camera system S = Hcc - Hcp Hpp^-1 Hpc is never formed:
    S·v is two sweeps over the observations. With
    `BAOptions.pallas_matvec` (and Ng == 1, a plan attached by
    add_pallas_matvec_plan, f32 parameters) the sweeps are the CUDA
    kernels of fused_matvec.py; otherwise S_matvec below computes them
    with gathers, einsums and index_add_.
  * Preconditioner: SCHUR_JACOBI (exact 6x6 diagonal blocks of S) or
    block_diag.
  * The undamped normal-equation blocks (make_blocks) are one sweep
    over the observations: with `BAOptions.pallas_blocks` (and the
    matvec kernels eligible) the ba_blocks CUDA kernel, otherwise its
    plain version fused_matvec.blocks_plain.
  * `linear_solver="dense_schur"` forms the reduced camera system S
    densely from per-point observation pairs (pt_idx_map) and solves it
    with a Cholesky factorization instead of PCG.
  * LM trust region with accept/reject and lambda adaptation, as a
    host loop; the CG loop tests its stopping rule on the host once per
    iteration.
  * Each phase of an LM iteration is a `torch.profiler` range named
    "ba.<phase>" (linearize, blocks, rhs, precond, cg, factor, backsub,
    inner, cost), so a profile splits the iteration's device time by
    phase.

The solver runs on the device of the problem's tensors. The JAX
solver's workarounds for the TPU (flat one-hot einsums, gather-table
reductions, lane-padded buffers) are not ported: the same math is
written with einsum on (M, 2, k) views and index_add_. So the BAProblem
fields that only choose a TPU reduction strategy — cam_idx_map/valid,
grp_idx_map/valid, cam_sort_perm, obs_cam_sorted — are accepted and not
read, as are the dense-Schur gather tables (cam_pair_tables,
cam_pair_perm_fwd/rev): the dense solver forms its correction blocks
from pt_idx_map/valid with index_add_ (the PCG solver does not read
those either). `axis_name` (the sharded solver)
raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ...camera import models as cm
from ...utils.device import full_f32
from ...utils.dispatch import count_dispatch
from ...utils.padding import next_bucket
from . import fused_matvec as fm
from .fused_matvec import round_mv
from .losses import robust_weight


class BAProblem(NamedTuple):
    """Bundle adjustment problem (tensors on one device)."""
    extrinsics: torch.Tensor    # (Nc, 6) [position, angle-axis]
    intrinsics: torch.Tensor    # (Ng, 10) padded per-group params
    points: torch.Tensor        # (Np, 3)
    obs_cam: torch.Tensor       # (M,) int32 camera index
    obs_group: torch.Tensor     # (M,) int32 intrinsics-group index
    obs_pt: torch.Tensor        # (M,) int32 point index
    obs_pix: torch.Tensor       # (M, 2) observed pixels
    obs_mask: torch.Tensor      # (M,) bool (False = padding)
    cam_mask: Optional[torch.Tensor] = None    # (Nc,) False = constant
    point_mask: Optional[torch.Tensor] = None  # (Np,)
    # accepted, not read (TPU reduction strategies; see module doc),
    # except pt_idx_map/valid, which the dense solver reads
    cam_idx_map: Optional[torch.Tensor] = None
    cam_idx_valid: Optional[torch.Tensor] = None
    pt_idx_map: Optional[torch.Tensor] = None
    pt_idx_valid: Optional[torch.Tensor] = None
    grp_idx_map: Optional[torch.Tensor] = None
    grp_idx_valid: Optional[torch.Tensor] = None
    cam_sort_perm: Optional[torch.Tensor] = None
    obs_cam_sorted: Optional[torch.Tensor] = None
    # fused-matvec plan (add_pallas_matvec_plan); its presence makes the
    # problem eligible for the CUDA kernels. pmv_window is a (W,) int8
    # zeros shape carrier, as in the JAX package.
    pmv_cam_tiles: Optional[torch.Tensor] = None   # (G, B) int32
    pmv_lpt_tiles: Optional[torch.Tensor] = None   # (G, B) int32
    pmv_p0: Optional[torch.Tensor] = None          # (G,) int32
    pmv_window: Optional[torch.Tensor] = None      # (W,) int8
    # accepted, not read (the TPU's scatter-free dense-Schur tables; see
    # add_cam_pair_tables)
    cam_pair_tables: Optional[tuple] = None
    cam_pair_perm_fwd: Optional[torch.Tensor] = None
    cam_pair_perm_rev: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class BAOptions:
    """Solver options; same fields and defaults as the JAX BAOptions
    (see its comments for each knob's measured history)."""
    model_type: int = int(cm.CameraModelType.PINHOLE)
    loss: str = "trivial"
    loss_scale: float = 1.0
    max_iterations: int = 50
    cg_iterations: int = 50
    cg_tol: float = 1e-6
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e12
    # a rejected step whose cost exceeds twice the current cost
    # multiplies lambda by 100 instead of 10
    reject_growth_aggressive: bool = False
    # which of the 10 intrinsics slots are optimized
    optimize_intrinsics: tuple = (True,) + (False,) * 9
    optimize_cameras: bool = True
    optimize_points: bool = True
    function_tolerance: float = 1e-9
    # Ruhe–Wedin inner iterations: GN sweeps over the point blocks with
    # cameras fixed after each candidate step (per-point cost guard)
    inner_iterations: int = 1
    # stop as soon as the accepted cost is <= target_cost (when > 0)
    target_cost: float = 0.0
    # record per-iteration candidate costs (negative = rejected)
    trace_costs: bool = False
    # observations sorted by point (informational here: the kernels and
    # index_add_ are correct in any order)
    point_indices_sorted: bool = False
    # "pcg" or "dense_schur" (needs pt_idx_map)
    linear_solver: str = "pcg"
    # round the jacobians to bfloat16 inside the CG matvec (f32
    # accumulation; preconditioner, RHS and back-substitution stay in
    # the parameters' type)
    matvec_bf16: bool = False
    # inexact-Newton forcing: CG stops at ||r|| <= max(cg_tol, cg_eta)·||b||
    cg_eta: float = 0.0
    # "schur_jacobi" or "block_diag"
    preconditioner: str = "schur_jacobi"
    # run S·v through the CUDA kernels when eligible (Ng == 1, plan
    # attached, f32 parameters); on CPU tensors the kernels' plain
    # versions run
    pallas_matvec: bool = False
    # kernel jacobian layout: (F, M) copies made once per damped solve
    # (True) or strided views of the (M, F) arrays (False)
    pallas_transposed: bool = True
    # also run make_blocks' sweep through the ba_blocks kernel when the
    # matvec kernels are eligible
    pallas_blocks: bool = False
    # keep jacobians and the undamped blocks across rejected steps
    jacobian_reuse: bool = False
    # keep the SCHUR_JACOBI preconditioner across rejected steps
    precond_reuse: bool = False
    # shard_map axis of the multi-device solver: not ported yet
    axis_name: Optional[str] = None


class BASummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: int
    final_lambda: torch.Tensor
    # (max_iterations,) candidate costs when BAOptions.trace_costs
    cost_trace: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------


def _residual_one(model_type, extr, intr, pt, pix):
    """Reprojection residual and cheirality flag; broadcasts over
    leading dims (one observation under vmap, or all at once)."""
    pixel, depth = cm.project(model_type, extr, intr, pt)
    r = pixel - pix
    # behind-camera observations get a zero, gradient-free residual
    bad = depth <= 1e-8
    return torch.where(bad[..., None], torch.zeros_like(r), r), bad


def _all_jacobians(model_type, prob: BAProblem, weights, r_raw=None):
    """Residuals and weighted per-observation jacobian blocks.

    Returns r (M, 2), Jc (M, 2, 6), Ji (M, 2, 10), Jp (M, 2, 3).
    r_raw: precomputed unweighted residuals."""
    extr = prob.extrinsics[prob.obs_cam]
    intr = prob.intrinsics[prob.obs_group]
    pts = prob.points[prob.obs_pt]

    def f(e, i, p, pix):
        return _residual_one(model_type, e, i, p, pix)[0]

    r = f(extr, intr, pts, prob.obs_pix) if r_raw is None else r_raw
    # reverse mode: the residual is R^19 -> R^2
    Jc, Ji, Jp = torch.func.vmap(torch.func.jacrev(f, argnums=(0, 1, 2)))(
        extr, intr, pts, prob.obs_pix)
    w = weights[:, None]
    return r * w, Jc * w[..., None], Ji * w[..., None], Jp * w[..., None]


def _apply_masks(prob: BAProblem, opts: BAOptions, Jc, Ji, Jp):
    if not opts.optimize_cameras:
        Jc = Jc * 0.0
    elif prob.cam_mask is not None:
        Jc = Jc * prob.cam_mask[prob.obs_cam].to(Jc.dtype)[:, None, None]
    intr_sel = torch.tensor(opts.optimize_intrinsics, dtype=Ji.dtype,
                            device=Ji.device)
    Ji = Ji * intr_sel[None, None, :]
    if not opts.optimize_points:
        Jp = Jp * 0.0
    elif prob.point_mask is not None:
        Jp = Jp * prob.point_mask[prob.obs_pt].to(Jp.dtype)[:, None, None]
    return Jc, Ji, Jp


def _per_obs_cost(opts: BAOptions, r, bad, obs_valid):
    s = torch.sum(r * r, dim=-1)
    w2 = robust_weight(opts.loss, s, opts.loss_scale) ** 2
    # cheirality violations: constant penalty so LM rejects steps that
    # push points behind cameras (their jacobians are zeroed)
    cost_m = torch.where(bad, torch.full_like(s, 1e8), w2 * s)
    return torch.where(obs_valid, cost_m, torch.zeros_like(s))


def ba_cost(prob: BAProblem, opts: BAOptions):
    """Total (robustified) cost."""
    r, bad = _residual_one(opts.model_type, prob.extrinsics[prob.obs_cam],
                           prob.intrinsics[prob.obs_group],
                           prob.points[prob.obs_pt], prob.obs_pix)
    return 0.5 * torch.sum(_per_obs_cost(opts, r, bad, prob.obs_mask))


def _inv3_flat(H9, eps_diag=0.0):
    """Batched closed-form 3x3 inverse on flat (N, 9) row-major storage
    (adjugate / det); optionally adds eps_diag to the diagonal first."""
    a, b, c = H9[:, 0], H9[:, 1], H9[:, 2]
    d, e, f = H9[:, 3], H9[:, 4], H9[:, 5]
    g, h, i = H9[:, 6], H9[:, 7], H9[:, 8]
    if eps_diag:
        a, e, i = a + eps_diag, e + eps_diag, i + eps_diag
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    return torch.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33],
                       dim=-1) / det[:, None]


def _mat3vec(H9, v):
    """Per-row (3, 3) @ (3,) on flat (N, 9) and (N, 3) storage."""
    return torch.sum(H9.reshape(-1, 3, 3) * v[:, None, :], dim=-1)


def _diagonal_only(A):
    """Zero off-diagonals of (..., K, K) blocks."""
    return A * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _check_supported(prob: BAProblem, opts: BAOptions):
    if opts.linear_solver not in ("pcg", "dense_schur"):
        raise ValueError(f"unknown linear_solver {opts.linear_solver!r}")
    if opts.linear_solver == "dense_schur" and prob.pt_idx_map is None:
        raise ValueError(
            "linear_solver='dense_schur' requires pt_idx_map — build the "
            "problem with add_point_obs_map/pad_ba_problem("
            "build_point_obs_map=True)")
    if opts.axis_name is not None:
        raise NotImplementedError(
            "axis_name (the sharded multi-device solver) is not ported "
            "to theiasfm_tpu_torch yet (see ROADMAP.md)")
    if opts.preconditioner not in ("schur_jacobi", "block_diag"):
        raise ValueError(f"unknown preconditioner {opts.preconditioner!r}")


def kernels_eligible(prob: BAProblem, opts: BAOptions) -> bool:
    """Whether bundle_adjust runs S·v through the fused-matvec kernels
    (decided from options and shapes alone, as in the JAX solver)."""
    return (opts.pallas_matvec and prob.intrinsics.shape[0] == 1 and
            prob.pmv_p0 is not None and
            prob.points.dtype == torch.float32)


def blocks_kernel_eligible(prob: BAProblem, opts: BAOptions) -> bool:
    """Whether make_blocks runs through the ba_blocks kernel: the matvec
    kernels are eligible and the options ask for it (JAX's rule)."""
    return (kernels_eligible(prob, opts) and opts.pallas_blocks and
            opts.axis_name is None)


def bundle_adjust(prob: BAProblem, opts: BAOptions):
    """Run LM. Returns (BAProblem with updated params, BASummary)."""
    _check_supported(prob, opts)
    Nc = prob.extrinsics.shape[0]
    Ng = prob.intrinsics.shape[0]
    Np = prob.points.shape[0]
    dtype = prob.points.dtype
    device = prob.points.device
    Pfull = prob.intrinsics.shape[1]
    obs_cam = prob.obs_cam.to(torch.int32).contiguous()
    obs_pt = prob.obs_pt.to(torch.int32).contiguous()
    obs_group = prob.obs_group
    obs_valid = prob.obs_mask
    M = obs_cam.shape[0]

    # active-intrinsics compression: only the optimized slots ride
    # through the group-side algebra; the step is expanded back
    active = tuple(i for i, b in enumerate(opts.optimize_intrinsics)
                   if b and i < Pfull)
    P = max(1, len(active))
    active_idx = torch.tensor(active if active else (0,), device=device)

    def compress_ji(Ji):
        Ji = Ji[:, :, active_idx]
        return Ji if active else Ji * 0.0

    def expand_dg(dg):
        out = torch.zeros((Ng, Pfull), dtype=dg.dtype, device=device)
        if active:
            out[:, active_idx] = dg
        return out

    def seg_cam(x):
        out = torch.zeros((Nc,) + x.shape[1:], dtype=x.dtype, device=device)
        return out.index_add_(0, obs_cam, x)

    def seg_pt(x):
        out = torch.zeros((Np,) + x.shape[1:], dtype=x.dtype, device=device)
        return out.index_add_(0, obs_pt, x)

    def seg_grp(x):
        if Ng == 1:
            return torch.sum(x, dim=0, keepdim=True)
        out = torch.zeros((Ng,) + x.shape[1:], dtype=x.dtype, device=device)
        return out.index_add_(0, obs_group, x)

    def grp_reduce(Ji3, t):
        """sum over obs of Ji^T t per group -> (Ng, P)."""
        if Ng == 1:
            Z = Ji3.reshape(M, 2 * P).T @ t                  # (2P, 2)
            Z3 = Z.reshape(2, P, 2)
            return (Z3[0, :, 0] + Z3[1, :, 1])[None]
        return seg_grp(torch.einsum("mkp,mk->mp", Ji3, t))

    def group_term(Ji3, vg):
        """per-obs Ji·vg[group] -> (M, 2)."""
        if Ng == 1:
            return torch.einsum("mkp,p->mk", Ji3, vg[0])
        return torch.einsum("mkp,mp->mk", Ji3, vg[obs_group])

    use_kernels = kernels_eligible(prob, opts)
    dense = opts.linear_solver == "dense_schur"
    # the dense solver's observation pairs: fixed by pt_idx_map, so found
    # once per solve
    obs_pairs = _point_obs_pairs(prob) if dense else None
    cam_index = pt_index = None
    if use_kernels:
        if M:
            # the kernels trust their indices: check them once per solve
            lo = torch.stack([obs_cam.min(), obs_pt.min()])
            hi = torch.stack([obs_cam.max(), obs_pt.max()])
            (cmin, pmin), (cmax, pmax) = lo.tolist(), hi.tolist()
            if min(cmin, pmin) < 0 or cmax >= Nc or pmax >= Np:
                raise ValueError("observation indices out of range")
        # the kernels' camera and point segments, fixed by obs_cam and
        # obs_pt: once per solve
        cam_index = fm.camera_index(obs_cam, Nc)
        pt_index = fm.point_index(obs_pt, Np)
    blocks_fn = (functools.partial(fm.blocks, cam_index=cam_index,
                                   pt_index=pt_index)
                 if blocks_kernel_eligible(prob, opts) else fm.blocks_plain)

    def build_system(extr, intr, pts, r0):
        """Weighted residuals and jacobians at (extr, intr, pts); r0 are
        the raw residuals there. Returns r (M, 2), Jc (M, 12),
        Ji (M, 2P), Jp (M, 6)."""
        p = prob._replace(extrinsics=extr, intrinsics=intr, points=pts)
        with record_function("ba.linearize"):
            s = torch.sum(r0 * r0, dim=-1)
            w = robust_weight(opts.loss, s, opts.loss_scale)
            w = torch.where(obs_valid, w, torch.zeros_like(w))
            r, Jc, Ji, Jp = _all_jacobians(opts.model_type, p, w, r_raw=r0)
            Jc, Ji, Jp = _apply_masks(prob, opts, Jc, Ji, Jp)
            Ji = compress_ji(Ji)
            return (r, Jc.reshape(M, 12), Ji.reshape(M, 2 * P),
                    Jp.reshape(M, 6))

    def make_blocks(r, Jc12, JiP, Jp6):
        """Lambda-independent pieces of the normal equations: undamped
        Hpp (flat (Np, 9)), Hcc (Nc, 6, 6), Hgg (Ng, P, P) and the
        gradients gc, gg, gp."""
        with record_function("ba.blocks"):
            return _make_blocks(r, Jc12, JiP, Jp6)

    def _make_blocks(r, Jc12, JiP, Jp6):
        pt_blk, cam_blk, X, Y = blocks_fn(Jc12, JiP, Jp6, r, obs_cam,
                                          obs_pt, Nc, Np)
        Hpp9, gp = pt_blk[:, :9], pt_blk[:, 9:]
        Hcc = cam_blk[:, :36].reshape(Nc, 6, 6)
        gc = cam_blk[:, 36:]
        if Ng == 1:
            X = X.reshape(2, P, 2, P)
            Hgg = (X[0, :, 0, :] + X[1, :, 1, :])[None]
            Y = Y.reshape(2, P, 2)
            gg = (Y[0, :, 0] + Y[1, :, 1])[None]
        else:
            Ji3 = JiP.reshape(M, 2, P)
            Hgg = seg_grp(torch.einsum("mki,mkj->mij", Ji3, Ji3))
            gg = seg_grp(torch.einsum("mki,mk->mi", Ji3, r))
        return Hpp9, Hcc, Hgg, gc, gg, gp

    def backsub_points(Jc12, JiP, Jp6, dc, dg, Hpp_inv, gp):
        """dp = Hpp^-1 (-gp - Hpc dc - Hpi dg)."""
        u = torch.einsum("mki,mi->mk", Jc12.reshape(M, 2, 6), dc[obs_cam])
        u = u + group_term(JiP.reshape(M, 2, P), dg)
        hp = seg_pt(torch.einsum("mka,mk->ma", Jp6.reshape(M, 2, 3), u))
        return _mat3vec(Hpp_inv, -gp - hp)

    def solve_normal_eqs(r, Jc12, JiP, Jp6, blocks, lam, P_state,
                         rebuild_precond):
        """One damped Schur/PCG solve. Returns (dc, dg, dp, P_state);
        P_state carries (Pc_inv, Pg_inv) across rejected steps when
        precond_reuse is on (rebuild_precond False reuses it)."""
        Hpp9, Hcc, Hgg, gc, gg, gp = blocks

        with record_function("ba.rhs"):
            diag9 = torch.zeros(9, dtype=dtype, device=device)
            diag9[[0, 4, 8]] = 1.0
            Hpp_inv = _inv3_flat(Hpp9 * (1.0 + lam * diag9[None, :]),
                                 eps_diag=1e-12)           # (Np, 9)

            # reduced RHS: b = -g_c + Hcp Hpp^-1 g_p (camera and group)
            yp = _mat3vec(Hpp_inv, gp)
            t = torch.einsum("mkj,mj->mk", Jp6.reshape(M, 2, 3),
                             yp[obs_pt])
            bc = -gc + seg_cam(torch.einsum("mki,mk->mi",
                                            Jc12.reshape(M, 2, 6), t))
            bg = -gg + grp_reduce(JiP.reshape(M, 2, P), t)

        if dense:
            if rebuild_precond is False:
                # stale-on-reject reuse: the correction blocks keep the
                # previous (smaller) lambda inside Hpp^-1; a system that
                # is then not positive definite yields a NaN step that LM
                # rejects, raising lambda (JAX's recovery). Hcg is
                # lambda-independent, hence exact.
                corr = P_state
            else:
                with record_function("ba.precond"):
                    corr = _dense_schur_corr(prob, Jc12, JiP, Jp6, Hpp_inv,
                                             obs_pairs)
            with record_function("ba.factor"):
                dc, dg = _dense_schur_factor_solve(Hcc, Hgg, bc, bg, lam,
                                                   *corr)
            with record_function("ba.backsub"):
                dp = backsub_points(Jc12, JiP, Jp6, dc, dg, Hpp_inv, gp)
            return dc, dg, dp, corr

        mv = torch.bfloat16 if opts.matvec_bf16 else dtype
        diag_c = lam * torch.diagonal(Hcc, dim1=-2, dim2=-1)   # (Nc, 6)
        diag_g = lam * torch.diagonal(Hgg, dim1=-2, dim2=-1)   # (Ng, P)

        # the matvec's jacobians: values rounded to the matvec type
        # (products in the parameters' type, f32 sums)
        Jc_mv, Ji_mv, Jp_mv = (x.to(mv) for x in (Jc12, JiP, Jp6))

        if use_kernels:
            if opts.pallas_transposed:
                # one transpose per damped solve; every CG iteration
                # then reads (F, M) rows coalesced along M
                jc_k, ji_k, jp_k = (x.T.contiguous()
                                    for x in (Jc_mv, Ji_mv, Jp_mv))
            else:
                jc_k, ji_k, jp_k = Jc_mv.T, Ji_mv.T, Jp_mv.T

            def S_matvec(vc, vg):
                count_dispatch("schur_matvec")
                u, wp = fm.pass1(jc_k, ji_k, jp_k, obs_cam, obs_pt,
                                 vc.contiguous(), vg[0].contiguous(), Np,
                                 pt_index)
                zp = _mat3vec(Hpp_inv, wp)
                yc, yg2 = fm.pass2(jc_k, ji_k, jp_k, obs_cam, obs_pt, u,
                                   zp, Nc, cam_index)
                g2 = yg2.reshape(2, P, 2)
                yg = (g2[0, :, 0] + g2[1, :, 1])[None]
                return yc + diag_c * vc, yg + diag_g * vg
        else:
            Jc3m = Jc_mv.to(dtype).reshape(M, 2, 6)
            Ji3m = Ji_mv.to(dtype).reshape(M, 2, P)
            Jp3m = Jp_mv.to(dtype).reshape(M, 2, 3)

            def S_matvec(vc, vg):
                """Plain matrix-free S·v (the "XLA matvec" config)."""
                count_dispatch("schur_matvec")
                u = torch.einsum("mki,mi->mk", Jc3m,
                                 round_mv(vc[obs_cam], mv))
                u = u + group_term(Ji3m, round_mv(vg, mv))
                wp = seg_pt(torch.einsum("mka,mk->ma", Jp3m,
                                         round_mv(u, mv)))
                zp = _mat3vec(Hpp_inv, wp)
                u2 = torch.einsum("mkj,mj->mk", Jp3m,
                                  round_mv(zp[obs_pt], mv))
                d = round_mv(u - u2, mv)
                yc = seg_cam(torch.einsum("mki,mk->mi", Jc3m, d))
                yg = grp_reduce(Ji3m, d)
                return yc + diag_c * vc, yg + diag_g * vg

        def build_precond():
            eye6 = torch.eye(6, dtype=dtype, device=device)
            eyeP = torch.eye(P, dtype=dtype, device=device)
            if opts.preconditioner == "block_diag":
                Scc0 = Hcc + lam * _diagonal_only(Hcc) + 1e-10 * eye6
                Sgg0 = Hgg + lam * _diagonal_only(Hgg) + 1e-10 * eyeP
                return (torch.linalg.inv_ex(Scc0)[0],
                        torch.linalg.inv_ex(Sgg0)[0])
            # SCHUR_JACOBI: exact 6x6 diagonal blocks of S (each
            # (camera, point) pair has at most one observation); the
            # per-obs intermediates are rounded to the matvec type,
            # the inverses stay full precision
            Jc3 = Jc_mv.to(dtype).reshape(M, 2, 6)
            Jp3 = Jp_mv.to(dtype).reshape(M, 2, 3)
            Ji3 = Ji_mv.to(dtype).reshape(M, 2, P)
            H9 = round_mv(Hpp_inv[obs_pt], mv).reshape(M, 3, 3)
            U = round_mv(torch.einsum("mka,mkc->mac", Jc3, Jp3), mv)
            T = round_mv(torch.einsum("mac,mce->mae", U, H9), mv)
            D = torch.einsum("mac,mbc->mab", T, U).reshape(M, 36)
            Scc_corr = seg_cam(D).reshape(Nc, 6, 6)
            Scc = Hcc + lam * _diagonal_only(Hcc) - Scc_corr + 1e-10 * eye6
            Pc_inv = torch.linalg.inv_ex(Scc)[0]
            if Ng == 1:
                Ug = round_mv(torch.einsum("mkp,mkc->mpc", Ji3, Jp3), mv)
                Tg = round_mv(torch.einsum("mpc,mce->mpe", Ug, H9), mv)
                G2 = (Tg.reshape(M, 3 * P).T @ Ug.reshape(M, 3 * P))
                Sgg_corr = torch.diagonal(G2.reshape(P, 3, P, 3),
                                          dim1=1, dim2=3).sum(-1)[None]
            else:
                Wg = round_mv(torch.einsum("mkc,mkp->mcp", Jp3, Ji3), mv)
                HWg = round_mv(torch.einsum("mdc,mcp->mdp", H9, Wg), mv)
                Sgg_corr = seg_grp(torch.einsum("mcp,mcq->mpq", Wg, HWg))
            Sgg = Hgg + lam * _diagonal_only(Hgg) - Sgg_corr + 1e-10 * eyeP
            return Pc_inv, torch.linalg.inv_ex(Sgg)[0]

        if rebuild_precond is False:
            # stale-on-reject reuse: only the CG convergence rate is
            # affected (the operator itself uses the fresh lambda)
            Pc_inv, Pg_inv = P_state
        else:
            with record_function("ba.precond"):
                Pc_inv, Pg_inv = build_precond()

        def precond(vc, vg):
            return (torch.einsum("nij,nj->ni", Pc_inv, vc),
                    torch.einsum("nij,nj->ni", Pg_inv, vg))

        def dot(ac, ag, bc_, bg_):
            return torch.sum(ac * bc_) + torch.sum(ag * bg_)

        with record_function("ba.cg"):
            x_c = torch.zeros((Nc, 6), dtype=dtype, device=device)
            x_g = torch.zeros((Ng, P), dtype=dtype, device=device)
            r_c, r_g = bc, bg
            z_c, z_g = precond(r_c, r_g)
            p_c, p_g = z_c, z_g
            rz = dot(r_c, r_g, z_c, z_g)
            b_norm = torch.sqrt(dot(bc, bg, bc, bg))
            tol2 = (max(opts.cg_tol, opts.cg_eta) * b_norm) ** 2
            tiny = torch.tensor(1e-30, dtype=dtype, device=device)
            for _ in range(opts.cg_iterations):
                # one host sync per CG iteration: the stopping rule
                if not bool(dot(r_c, r_g, r_c, r_g) > tol2):
                    break
                Ap_c, Ap_g = S_matvec(p_c, p_g)
                pAp = dot(p_c, p_g, Ap_c, Ap_g)
                alpha = rz / torch.where(torch.abs(pAp) < 1e-30, tiny, pAp)
                x_c = x_c + alpha * p_c
                x_g = x_g + alpha * p_g
                r_c = r_c - alpha * Ap_c
                r_g = r_g - alpha * Ap_g
                z_c, z_g = precond(r_c, r_g)
                rz_new = dot(r_c, r_g, z_c, z_g)
                beta = rz_new / torch.where(torch.abs(rz) < 1e-30, tiny, rz)
                p_c = z_c + beta * p_c
                p_g = z_g + beta * p_g
                rz = rz_new
        with record_function("ba.backsub"):
            dp = backsub_points(Jc12, JiP, Jp6, x_c, x_g, Hpp_inv, gp)
        return x_c, x_g, dp, (Pc_inv, Pg_inv)

    # --------------------------------------------------------- inner iters
    def refine_points(extr, intr, pts):
        """Ruhe–Wedin inner iterations: re-optimize every point block
        with cameras fixed (batched 3x3 GN; a per-point cost guard keeps
        each sweep monotone non-increasing in the total cost)."""
        extr_m = extr[obs_cam]
        intr_m = intr[obs_group]

        def f(e, i, p, pix):
            return _residual_one(opts.model_type, e, i, p, pix)[0]

        def res(pts_):
            return _residual_one(opts.model_type, extr_m, intr_m,
                                 pts_[obs_pt], prob.obs_pix)

        r0_, bad0_ = res(pts)
        c_pt = seg_pt(_per_obs_cost(opts, r0_, bad0_, obs_valid))
        for _ in range(opts.inner_iterations):
            pts_m = pts[obs_pt]
            r, bad = res(pts)
            s = torch.sum(r * r, dim=-1)
            w = robust_weight(opts.loss, s, opts.loss_scale)
            w = torch.where(obs_valid & ~bad, w, torch.zeros_like(w))
            Jp = torch.func.vmap(torch.func.jacrev(f, argnums=2))(
                extr_m, intr_m, pts_m, prob.obs_pix)
            Jp3 = Jp * w[:, None, None]
            rw = r * w[:, None]
            Hpp9_m = torch.einsum("mka,mkb->mab", Jp3, Jp3).reshape(M, 9)
            gp3_m = torch.einsum("mka,mk->ma", Jp3, rw)
            blk = seg_pt(torch.cat([Hpp9_m, gp3_m], dim=1))
            Hinv = _inv3_flat(blk[:, :9], eps_diag=1e-10)
            dp_ = -_mat3vec(Hinv, blk[:, 9:])
            if prob.point_mask is not None:
                dp_ = dp_ * prob.point_mask[:, None].to(dtype)
            pts_c = pts + dp_
            r2, bad2 = res(pts_c)
            c_new = seg_pt(_per_obs_cost(opts, r2, bad2, obs_valid))
            better = c_new < c_pt
            pts = torch.where(better[:, None], pts_c, pts)
            c_pt = torch.where(better, c_new, c_pt)
        return pts

    # ----------------------------------------------------------------- LM
    def cost_and_residuals(extr, intr, pts):
        """Total robust cost and the raw residuals (reused for the next
        iteration's jacobian weights)."""
        with record_function("ba.cost"):
            r, bad = _residual_one(opts.model_type, extr[obs_cam],
                                   intr[obs_group], pts[obs_pt],
                                   prob.obs_pix)
            cost_m = _per_obs_cost(opts, r, bad, obs_valid)
            return 0.5 * torch.sum(cost_m), r

    extr, intr, pts = prob.extrinsics, prob.intrinsics, prob.points
    cost, r_cur = cost_and_residuals(extr, intr, pts)
    cost0 = cost
    lam = torch.tensor(opts.initial_lambda, dtype=dtype, device=device)
    trace = (torch.zeros(opts.max_iterations, dtype=dtype, device=device)
             if opts.trace_costs else None)
    # precond reuse is valid without jacobian reuse: a rejected step
    # leaves the parameters (hence the jacobians and undamped blocks)
    # unchanged; only lambda differs
    J_state = B_state = P_state = None
    prev_accepted, done, it = True, False, 0
    while it < opts.max_iterations and not done:
        if opts.jacobian_reuse:
            # a rejected step leaves the parameters unchanged: reuse the
            # jacobians and the undamped blocks
            if prev_accepted:
                J_state = build_system(extr, intr, pts, r_cur)
                B_state = make_blocks(*J_state)
            system, blocks = J_state, B_state
        else:
            system = build_system(extr, intr, pts, r_cur)
            blocks = make_blocks(*system)
        rebuild = prev_accepted if opts.precond_reuse else None
        dc, dg, dp, P_state = solve_normal_eqs(*system, blocks, lam,
                                               P_state, rebuild)
        extr_new = extr + dc
        intr_new = intr + expand_dg(dg)
        pts_new = pts + dp
        if opts.inner_iterations > 0 and opts.optimize_points:
            with record_function("ba.inner"):
                pts_new = refine_points(extr_new, intr_new, pts_new)
        new_cost, r_new = cost_and_residuals(extr_new, intr_new, pts_new)
        accept_t = new_cost < cost
        growth = 10.0
        if opts.reject_growth_aggressive:
            growth = torch.where(new_cost > 2.0 * cost, 100.0, 10.0).to(dtype)
        lam = torch.where(accept_t,
                          torch.clamp(lam * 0.33, min=opts.min_lambda),
                          torch.clamp(lam * growth, max=opts.max_lambda))
        rel_decrease = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        done_t = accept_t & (rel_decrease < opts.function_tolerance)
        cost = torch.where(accept_t, new_cost, cost)
        if opts.target_cost > 0:
            done_t = done_t | (cost <= opts.target_cost)
        if trace is not None:
            trace[it] = torch.where(accept_t, new_cost, -new_cost)
        it += 1
        # one host sync per LM iteration
        prev_accepted, done = torch.stack([accept_t, done_t]).tolist()
        if prev_accepted:
            extr, intr, pts, r_cur = extr_new, intr_new, pts_new, r_new

    out = prob._replace(extrinsics=extr, intrinsics=intr, points=pts)
    return out, BASummary(initial_cost=cost0, final_cost=cost,
                          num_iterations=it, final_lambda=lam,
                          cost_trace=trace)


# --------------------------------------------------------------------------
# dense Schur


def _point_obs_pairs(prob: BAProblem):
    """(k, l): every ordered pair of valid observations of one point
    (k == l included), from the (Np, K) table pt_idx_map."""
    idx = prob.pt_idx_map.long()
    valid = prob.pt_idx_valid.bool()
    n, i, j = torch.nonzero(valid[:, :, None] & valid[:, None, :],
                            as_tuple=True)
    return idx[n, i], idx[n, j]


def _dense_schur_corr(prob: BAProblem, Jc12, JiP, Jp6, Hpp_inv, obs_pairs):
    """The correction blocks of the reduced camera system

        S = [Hcc  Hcg] - [Hcp] Hpp^-1 [Hpc Hpg]
            [Hgc  Hgg]   [Hgp]

    Returns (corr_cc (Nc*Nc, 36), corr_cg (Nc, Ng, 6, P), corr_gg
    (Ng, Ng, P, P), Hcg (Nc, Ng, 6, P)): everything but the damped
    diagonal, the RHS and the factorization, and the part that
    precond_reuse keeps across rejected steps.

    The corrections couple the cameras (and groups) of observations of a
    common point: for observations k, l of point n the pair block is
    T_k U_l^T, with U = Jc^T Jp (6x3), T = U Hpp^-1[n]. The blocks are
    formed for every pair of obs_pairs and reduced with index_add_ keyed
    on (cam_k, cam_l) — the JAX solver's permutation gathers and
    zero-scatter tables were a TPU workaround, and its row-chunked
    un-flattening a guard against the TPU's tile padding."""
    Nc, Ng = prob.extrinsics.shape[0], prob.intrinsics.shape[0]
    M, P = Jc12.shape[0], JiP.shape[1] // 2
    dtype, device = Jc12.dtype, Jc12.device
    cam = prob.obs_cam.long()
    grp = prob.obs_group.long()
    Jc3, Ji3, Jp3 = (Jc12.reshape(M, 2, 6), JiP.reshape(M, 2, P),
                     Jp6.reshape(M, 2, 3))
    Hcg = torch.zeros((Nc * Ng, 6 * P), dtype=dtype, device=device)
    Hcg.index_add_(0, cam * Ng + grp, torch.einsum(
        "mka,mkb->mab", Jc3, Ji3).reshape(M, 6 * P))
    H = Hpp_inv[prob.obs_pt.long()].reshape(M, 3, 3)
    U = torch.einsum("mka,mkc->mac", Jc3, Jp3)          # (M, 6, 3)
    Ug = torch.einsum("mkp,mkc->mpc", Ji3, Jp3)         # (M, P, 3)
    T, Tg = U @ H, Ug @ H
    corr_cc = torch.zeros((Nc * Nc, 36), dtype=dtype, device=device)
    corr_cg = torch.zeros((Nc * Ng, 6 * P), dtype=dtype, device=device)
    corr_gg = torch.zeros((Ng * Ng, P * P), dtype=dtype, device=device)
    k_all, l_all = obs_pairs
    # chunks of pairs bound the (pairs, 36) temporaries
    step = 1 << 22
    for s in range(0, k_all.shape[0], step):
        k, l = k_all[s:s + step], l_all[s:s + step]
        Tk, Ul, Ugl = T[k], U[l], Ug[l]
        corr_cc.index_add_(0, cam[k] * Nc + cam[l],
                           (Tk @ Ul.transpose(1, 2)).reshape(-1, 36))
        corr_cg.index_add_(0, cam[k] * Ng + grp[l],
                           (Tk @ Ugl.transpose(1, 2)).reshape(-1, 6 * P))
        corr_gg.index_add_(0, grp[k] * Ng + grp[l],
                           (Tg[k] @ Ugl.transpose(1, 2)).reshape(-1, P * P))
    return (corr_cc, corr_cg.reshape(Nc, Ng, 6, P),
            corr_gg.reshape(Ng, Ng, P, P), Hcg.reshape(Nc, Ng, 6, P))


def _dense_schur_factor_solve(Hcc, Hgg, bc, bg, lam, corr_cc, corr_cg,
                              corr_gg, Hcg):
    """Assemble the damped reduced camera system from the correction
    blocks and solve it with a Cholesky factorization, in full float32
    whatever the caller's TF32 setting. A factorization that fails (S
    not positive definite) gives a NaN step, which LM rejects; no host
    sync."""
    Nc, Ng, _, P = Hcg.shape
    Dc, Dg = 6 * Nc, P * Ng
    with full_f32():
        Acc = -corr_cc.reshape(Nc, Nc, 6, 6)
        ic = torch.arange(Nc, device=Hcc.device)
        Acc[ic, ic] += Hcc + lam * _diagonal_only(Hcc)
        Agg = -corr_gg
        ig = torch.arange(Ng, device=Hcc.device)
        Agg[ig, ig] += Hgg + lam * _diagonal_only(Hgg)
        Acg = Hcg - corr_cg
        A = torch.cat([
            torch.cat([Acc.permute(0, 2, 1, 3).reshape(Dc, Dc),
                       Acg.permute(0, 2, 1, 3).reshape(Dc, Dg)], dim=1),
            torch.cat([Acg.permute(1, 3, 0, 2).reshape(Dg, Dc),
                       Agg.permute(0, 2, 1, 3).reshape(Dg, Dg)], dim=1)])
        b = torch.cat([bc.reshape(-1), bg.reshape(-1)])
        # masked cameras, non-optimized intrinsics slots and padding have
        # all-zero rows: pin them to identity so the factorization is
        # well-posed (their rhs is zero, so is their step)
        d = torch.diagonal(A)
        A = A + torch.diag((torch.abs(d) < 1e-12).to(A.dtype))
        L, info = torch.linalg.cholesky_ex(A)
        x = torch.cholesky_solve(b[:, None], L)[:, 0]
        x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
    return x[:Dc].reshape(Nc, 6), x[Dc:].reshape(Ng, P)


def build_cam_pair_tables(obs_cam, pt_idx_map, pt_idx_valid, n_cams,
                          classes=(4, 16, 64, 256, 1024),
                          max_entries=1 << 20, device="cpu"):
    """The JAX package's camera-pair gather tables for its scatter-free
    dense-Schur assembly on the TPU, built the same way (host-side numpy)
    so that problems carry the same fields in both packages. This
    package's dense solver does not read them.

    Returns (tables, perm_fwd, perm_rev): tables is a tuple of
    (kidx, lidx, valid) tensors; perm_fwd/perm_rev are (Nc*Nc, R) int32
    row indices into [table rows | Nc diagonal rows | 1 zero row]."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)

    def dev(x):
        return torch.as_tensor(x, device=device)

    idx = host(pt_idx_map)
    val = host(pt_idx_valid)
    Np, K = idx.shape
    cam = host(obs_cam)[idx]
    iu, ju = np.triu_indices(K, k=1)
    k_e = idx[:, iu].reshape(-1)
    l_e = idx[:, ju].reshape(-1)
    v_e = (val[:, iu] & val[:, ju]).reshape(-1)
    pid = (cam[:, iu].astype(np.int64) * n_cams +
           cam[:, ju]).reshape(-1)
    k_e, l_e, pid = k_e[v_e], l_e[v_e], pid[v_e]
    order = np.argsort(pid, kind="stable")
    k_e, l_e, pid = k_e[order], l_e[order], pid[order]
    uids, starts, counts = np.unique(pid, return_index=True,
                                     return_counts=True)
    E, U = len(pid), len(uids)
    caps = np.asarray(classes)
    capmax = classes[-1]
    cls = np.searchsorted(caps, np.minimum(np.maximum(counts, 1),
                                           capmax))
    cap_u = caps[cls]
    nrows_u = -(-counts // cap_u)
    u_of_e = np.repeat(np.arange(U), counts)
    rank = np.arange(E) - np.repeat(starts, counts)
    tables = []
    row_ids = []  # ordered-pair id of every produced table row
    for ci, cap in enumerate(classes):
        sel_u = np.flatnonzero(cls == ci)
        if len(sel_u) == 0:
            continue
        nrows = nrows_u[sel_u]
        row_base = np.zeros(len(sel_u), np.int64)
        np.cumsum(nrows[:-1], out=row_base[1:])
        P_c = int(nrows.sum())
        e_idx = np.flatnonzero(cls[u_of_e] == ci)
        lu = np.searchsorted(sel_u, u_of_e[e_idx])
        r = rank[e_idx]
        row = row_base[lu] + r // cap
        col = r % cap
        kk = np.zeros((P_c, cap), np.int32)
        ll = np.zeros((P_c, cap), np.int32)
        vv = np.zeros((P_c, cap), bool)
        kk[row, col] = k_e[e_idx]
        ll[row, col] = l_e[e_idx]
        vv[row, col] = True
        # per-row pair ids (spilled groups repeat the id; ids ascend
        # within the class, so forward-fill by running max)
        rid = np.zeros(P_c, np.int64)
        rid[row_base] = uids[sel_u]
        filled = np.zeros(P_c, bool)
        filled[row_base] = True
        np.maximum.accumulate(np.where(filled, rid, 0), out=rid)
        rows_per_chunk = max(1, max_entries // cap)
        for s in range(0, P_c, rows_per_chunk):
            e = min(s + rows_per_chunk, P_c)
            tables.append((dev(kk[s:e]), dev(ll[s:e]), dev(vv[s:e])))
            row_ids.append(rid[s:e])
    n_table_rows = int(sum(len(r) for r in row_ids))
    zero_row = n_table_rows + n_cams
    # forward targets: table rows at their ordered-pair id, then the Nc
    # diagonal segment rows at ids i*Nc+i
    diag_ids = np.arange(n_cams, dtype=np.int64) * (n_cams + 1)
    fwd_ids = np.concatenate([np.concatenate(row_ids)
                              if row_ids else np.zeros(0, np.int64),
                              diag_ids])
    perm_fwd, _ = _build_idx_map(fwd_ids, n_cams * n_cams, zero_row,
                                 bucket_min=1)
    # reverse targets (transpose): table rows only, at (b*Nc + a)
    tab_ids = fwd_ids[:n_table_rows]
    rev_ids = (tab_ids % n_cams) * n_cams + tab_ids // n_cams
    perm_rev, _ = _build_idx_map(rev_ids, n_cams * n_cams, zero_row,
                                 bucket_min=1)
    return tuple(tables), dev(perm_fwd), dev(perm_rev)


def add_cam_pair_tables(prob: BAProblem,
                        classes=(4, 16, 64, 256, 1024),
                        max_entries=1 << 20,
                        build_cam_maps=True) -> BAProblem:
    """Attach the camera-pair tables and, with build_cam_maps, the
    per-camera observation tables, as the JAX package does (host-side;
    call after add_point_obs_map / pad_ba_problem). Accepted for parity:
    this package's dense solver reads neither."""
    if prob.pt_idx_map is None:
        raise ValueError("add_cam_pair_tables requires pt_idx_map — "
                         "call add_point_obs_map first")
    dev = prob.obs_cam.device
    tables, perm_fwd, perm_rev = build_cam_pair_tables(
        prob.obs_cam, prob.pt_idx_map, prob.pt_idx_valid,
        prob.extrinsics.shape[0], classes=classes,
        max_entries=max_entries, device=dev)
    out = prob._replace(cam_pair_tables=tables,
                        cam_pair_perm_fwd=perm_fwd,
                        cam_pair_perm_rev=perm_rev)
    if build_cam_maps and prob.cam_idx_map is None:
        M = prob.obs_cam.shape[0]
        cm_, cv_ = _build_idx_map(
            prob.obs_cam.cpu().numpy(), prob.extrinsics.shape[0], M - 1,
            obs_valid=prob.obs_mask.cpu().numpy())
        out = out._replace(cam_idx_map=torch.as_tensor(cm_, device=dev),
                           cam_idx_valid=torch.as_tensor(cv_, device=dev))
    return out


# --------------------------------------------------------------------------
# problem preparation (host side)

def _full_like_rows(x, n, fill):
    return torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)


def pad_obs_to_multiple(prob: BAProblem, multiple: int) -> BAProblem:
    """Append masked observations so M % multiple == 0 (keeps obs_pt
    non-decreasing by repeating the last point index)."""
    M = prob.obs_cam.shape[0]
    pad = (-M) % multiple
    if pad == 0:
        return prob
    last_pt = int(prob.obs_pt[-1]) if M else 0

    def padrows(x, fill):
        return torch.cat([x, _full_like_rows(x, pad, fill)])

    return prob._replace(
        obs_cam=padrows(prob.obs_cam, 0),
        obs_group=padrows(prob.obs_group, 0),
        obs_pt=padrows(prob.obs_pt, last_pt),
        obs_pix=padrows(prob.obs_pix, 0.0),
        obs_mask=padrows(prob.obs_mask, False))


def add_pallas_matvec_plan(prob: BAProblem, block: int = 1024) -> BAProblem:
    """Attach the fused-matvec plan (host side). Requires point-sorted
    observations and M % block == 0 (use pad_obs_to_multiple first).
    The solver runs S·v through the kernels when BAOptions.pallas_matvec
    is set and the plan is attached."""
    plan = fm.MatvecPlan(prob.obs_cam.cpu().numpy(),
                         prob.obs_pt.cpu().numpy(),
                         prob.extrinsics.shape[0], prob.points.shape[0],
                         block=block)
    dev = prob.obs_cam.device
    return prob._replace(
        pmv_cam_tiles=torch.as_tensor(plan.cam_tiles, device=dev),
        pmv_lpt_tiles=torch.as_tensor(plan.local_pt, device=dev),
        pmv_p0=torch.as_tensor(plan.tile_p0, device=dev),
        pmv_window=torch.zeros(plan.W, dtype=torch.int8, device=dev))


def _build_idx_map(indices: np.ndarray, num_segments: int,
                   pad_target: int, bucket_min: int = 4,
                   obs_valid: Optional[np.ndarray] = None):
    """Host-side inverse map: for each segment, the (padded) list of
    observation indices. Padding slots point at `pad_target` with
    valid=False; masked observations are excluded."""
    if obs_valid is not None:
        keep = np.flatnonzero(np.asarray(obs_valid))
    else:
        keep = np.arange(len(indices))
    kept_idx = indices[keep]
    counts = np.bincount(kept_idx, minlength=num_segments)
    kmax = next_bucket(int(counts.max()) if counts.size else 1,
                       bucket_min)
    order = np.argsort(kept_idx, kind="stable")
    idx_map = np.full((num_segments, kmax), pad_target, np.int32)
    valid = np.zeros((num_segments, kmax), bool)
    starts = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    sorted_idx = kept_idx[order]
    ranks = np.arange(len(order)) - starts[sorted_idx]
    idx_map[sorted_idx, ranks] = keep[order]
    valid[sorted_idx, ranks] = True
    return idx_map, valid


def add_point_obs_map(prob: BAProblem, bucket_min: int = 4) -> BAProblem:
    """Attach the (Np, Kmax) per-point observation table (accepted for
    parity with the JAX package; the PCG solver here does not read it)."""
    Np = prob.points.shape[0]
    M = prob.obs_pt.shape[0]
    idx_map, valid = _build_idx_map(
        prob.obs_pt.cpu().numpy(), Np, M - 1, bucket_min=bucket_min,
        obs_valid=prob.obs_mask.cpu().numpy())
    dev = prob.obs_pt.device
    return prob._replace(pt_idx_map=torch.as_tensor(idx_map, device=dev),
                         pt_idx_valid=torch.as_tensor(valid, device=dev))


def pad_ba_problem(prob: BAProblem, minimum: int = 8,
                   sort_by_point: bool = True,
                   build_reduction_maps: bool = False,
                   sort_by_camera: bool = False,
                   build_point_obs_map: bool = False) -> BAProblem:
    """Sort observations by point and pad every axis to power-of-two
    buckets (cameras >= minimum, points >= 64, observations >= 256);
    padding is masked out. The optional TPU reduction maps are built as
    in the JAX package (and not read by this solver)."""
    if sort_by_point and prob.obs_pt.shape[0] > 0:
        order = torch.argsort(prob.obs_pt, stable=True)
        prob = prob._replace(
            obs_cam=prob.obs_cam[order], obs_group=prob.obs_group[order],
            obs_pt=prob.obs_pt[order], obs_pix=prob.obs_pix[order],
            obs_mask=prob.obs_mask[order])

    Nc, Ng, Np, M = (prob.extrinsics.shape[0], prob.intrinsics.shape[0],
                     prob.points.shape[0], prob.obs_cam.shape[0])
    Ncb, Ngb = next_bucket(Nc, minimum), next_bucket(Ng, 1)
    Npb, Mb = next_bucket(Np, 64), next_bucket(M, 256)
    dev = prob.points.device

    def padrows(x, n, fill=0.0):
        if x.shape[0] == n:
            return x
        return torch.cat([x, _full_like_rows(x, n - x.shape[0], fill)])

    cam_mask = (prob.cam_mask if prob.cam_mask is not None
                else torch.ones(Nc, dtype=torch.bool, device=dev))
    point_mask = (prob.point_mask if prob.point_mask is not None
                  else torch.ones(Np, dtype=torch.bool, device=dev))
    obs_cam_p = padrows(prob.obs_cam, Mb)
    obs_group_p = padrows(prob.obs_group, Mb)
    # pad with the last point index so obs_pt stays non-decreasing
    obs_pt_p = padrows(prob.obs_pt, Mb, Npb - 1)

    maps = {}
    if sort_by_camera and M > 0 and not build_reduction_maps:
        perm = np.argsort(obs_cam_p.cpu().numpy(), kind="stable")
        maps.update(
            cam_sort_perm=torch.as_tensor(perm.astype(np.int32),
                                          device=dev),
            obs_cam_sorted=torch.as_tensor(
                obs_cam_p.cpu().numpy()[perm].astype(np.int32),
                device=dev))
    if build_reduction_maps and M > 0:
        cm_, cv_ = _build_idx_map(obs_cam_p[:M].cpu().numpy(), Ncb, Mb - 1)
        gm_, gv_ = _build_idx_map(obs_group_p[:M].cpu().numpy(), Ngb,
                                  Mb - 1)
        maps = dict(
            cam_idx_map=torch.as_tensor(cm_, device=dev),
            cam_idx_valid=torch.as_tensor(cv_, device=dev),
            grp_idx_map=torch.as_tensor(gm_, device=dev),
            grp_idx_valid=torch.as_tensor(gv_, device=dev))

    out = BAProblem(
        extrinsics=padrows(prob.extrinsics, Ncb),
        intrinsics=padrows(prob.intrinsics, Ngb, 1.0),
        points=padrows(prob.points, Npb),
        obs_cam=obs_cam_p,
        obs_group=obs_group_p,
        obs_pt=obs_pt_p,
        obs_pix=padrows(prob.obs_pix, Mb),
        obs_mask=padrows(prob.obs_mask, Mb, False),
        cam_mask=padrows(cam_mask, Ncb, False),
        point_mask=padrows(point_mask, Npb, False),
        **maps,
    )
    if build_point_obs_map:
        out = add_point_obs_map(out)
    return out


def bundle_adjust_host_f64(prob: BAProblem, opts: BAOptions):
    """Final-polish BA in float64 (the counterpart of the JAX function of
    this name, whose name it keeps).

    The JAX version moves the problem to the host CPU only because a TPU
    has no float64. The card computes in float64, so this casts every
    float field to float64 and solves on the problem's own device (the
    card by default). The kernels take float32 only, so this solve runs
    the plain matvec and the plain blocks, as JAX's eligibility rule
    decides (kernels_eligible is False in float64). Returns
    (BAProblem in float64, BASummary)."""
    def to64(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(to64(e) for e in x)
        return x.to(torch.float64) if x.is_floating_point() else x

    return bundle_adjust(BAProblem(*[to64(f) for f in prob]), opts)


def bundle_adjust_bucketed(prob: BAProblem, opts: BAOptions):
    """Pad to buckets (sorted by point), attach the fused-matvec plan
    when the options ask for the kernels and the padded problem is
    eligible, solve, and slice back."""
    Nc, Np = prob.extrinsics.shape[0], prob.points.shape[0]
    padded = pad_ba_problem(prob)
    opts = dataclasses.replace(opts, point_indices_sorted=True)
    if (opts.pallas_matvec and padded.intrinsics.shape[0] == 1 and
            padded.obs_cam.shape[0] % 1024 == 0):
        padded = add_pallas_matvec_plan(padded, block=1024)
    out, summary = bundle_adjust(padded, opts)
    result = prob._replace(extrinsics=out.extrinsics[:Nc],
                           intrinsics=out.intrinsics[
                               :prob.intrinsics.shape[0]],
                           points=out.points[:Np])
    return result, summary
