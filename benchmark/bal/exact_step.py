"""The exact Levenberg-Marquardt step of a small bundle-adjustment
problem, in plain torch and float64: the whole Jacobian formed densely
and the damped normal equations solved at once, with no Schur step.

It imports nothing of the program under test. It is the plain reference
of the dense Schur solver (a Schur complement formed from per-point
observation pairs, assembled densely and factored with Cholesky): the
same LM step by another route. Only small problems fit, since the
Jacobian is a dense (2M, 6 Nc + P Ng + 3 Np) matrix.

The problem is the solver's: cameras (Nc, 6) [position, angle-axis] and
points (Np, 3) move additively; of the intrinsics (Ng, 10) of each
group only the `active` slots move. Each observation's residual and
Jacobian rows are weighted by sqrt(rho'(s)) of Huber's loss at the
residual (benchmark/bal/camera.py); a masked observation weighs 0, one
behind its camera has a zero residual and zero rows. `cam_mask` and
`point_mask`, where given, hold those cameras and points constant (their
columns are zero). With H = J^T J and g = J^T r the step solves

    (H + lam * diag(H)) x = -g,

which is the solver's damping: the point blocks' diagonals times
(1 + lam), the camera and group blocks plus lam times their diagonals.

Departures from the dense Schur solver's arithmetic, none of which
changes the step beyond rounding:

* no Schur complement: the point unknowns are solved with the rest,
  by torch.linalg.solve (LU), where the solver forms S from
  Hpp^-1, factors S with Cholesky in float32 or float64 and
  back-substitutes the points;
* the solver adds 1e-12 to each damped point block's diagonal before
  inverting it; here nothing is added;
* all-zero rows (held cameras, unused groups, points with no weighted
  observation) are pinned to the identity here in the whole system; the
  solver pins them in S and lets a point's zero gradient give it a zero
  step. Either way their step is 0;
* a system that is not positive definite is solved by LU here, where
  the solver's Cholesky fails and it returns a NaN step.

`cost` is the solver's stated cost, 1/2 sum rho'(s) s (1e8 for an
observation behind its camera), and `lm_solve` the solver's LM rule on
it without inner iterations: a step is accepted where the cost falls,
lam times 0.33 then (at least `min_lambda`), else times 10 (at most
`max_lambda`).
"""
from __future__ import annotations

import torch

from . import camera

BEHIND = 1e8


def _weights(r, behind, mask, a):
    s = torch.sum(r * r, dim=-1)
    w = camera.huber_weight(s, a)
    return torch.where(mask & ~behind, w, torch.zeros_like(w))


def cost(extrinsics, intrinsics, points, obs_cam, obs_group, obs_pt,
         obs_pix, obs_mask, loss_scale):
    """The solver's stated cost, 1/2 sum rho'(s) s over the unmasked
    observations."""
    r, behind = camera.residuals(extrinsics[obs_cam], intrinsics[obs_group],
                                 points[obs_pt], obs_pix)
    s = torch.sum(r * r, dim=-1)
    per = camera.huber_weight(s, loss_scale) ** 2 * s
    per = torch.where(behind, torch.full_like(s, BEHIND), per)
    return 0.5 * torch.sum(torch.where(obs_mask, per, torch.zeros_like(s)))


def damped_system(extrinsics, intrinsics, points, obs_cam, obs_group,
                  obs_pt, obs_pix, obs_mask, active, lam, loss_scale,
                  cam_mask=None, point_mask=None):
    """The damped normal equations A x = b in float64, the unknowns
    ordered cameras (6 each), groups (len(active) each), points (3
    each), with all-zero rows pinned to the identity."""
    f64 = torch.float64
    extr, intr, pts = (x.to(f64) for x in (extrinsics, intrinsics, points))
    pix = obs_pix.to(f64)
    cam, grp, pt = (x.long() for x in (obs_cam, obs_group, obs_pt))
    Nc, Ng, Np, M = extr.shape[0], intr.shape[0], pts.shape[0], cam.shape[0]
    act = torch.tensor(active, dtype=torch.long)
    P = len(active)
    # the active slots as a selector: intrinsics = fixed slots + ga @ E
    E = torch.zeros(P, intr.shape[1], dtype=f64)
    E[torch.arange(P), act] = 1.0
    keep = 1.0 - E.sum(0)

    def f(e, ga, g, p, x):
        return camera.residuals(e, g * keep + ga @ E, p, x)[0]

    e, g, p = extr[cam], intr[grp], pts[pt]
    r, behind = camera.residuals(e, g, p, pix)
    Jc, Jg, Jp = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1, 3)))(
        e, g[:, act], g, p, pix)
    w = _weights(r, behind, obs_mask.bool(), loss_scale)
    if cam_mask is not None:
        Jc = Jc * cam_mask.to(f64)[cam][:, None, None]
    if point_mask is not None:
        Jp = Jp * point_mask.to(f64)[pt][:, None, None]
    r, Jc, Jg, Jp = (x * w.reshape((M,) + (1,) * (x.dim() - 1))
                     for x in (r, Jc, Jg, Jp))

    Dc, Dg = 6 * Nc, P * Ng
    J = torch.zeros(M, 2, Dc + Dg + 3 * Np, dtype=f64)
    rows = torch.arange(M)[:, None]
    J[rows, :, (6 * cam[:, None] + torch.arange(6))] = Jc.transpose(1, 2)
    J[rows, :, (Dc + P * grp[:, None] + torch.arange(P))] = \
        Jg.transpose(1, 2)
    J[rows, :, (Dc + Dg + 3 * pt[:, None] + torch.arange(3))] = \
        Jp.transpose(1, 2)
    J = J.reshape(2 * M, -1)
    H = J.T @ J
    gvec = J.T @ r.reshape(-1)
    d = torch.diagonal(H)
    return H + torch.diag(lam * d + (d.abs() < 1e-12).to(f64)), -gvec


def lm_step(extrinsics, intrinsics, points, obs_cam, obs_group, obs_pt,
            obs_pix, obs_mask, active, lam, loss_scale, cam_mask=None,
            point_mask=None):
    """The damped Gauss-Newton step (dc (Nc, 6), dg (Ng, len(active)),
    dp (Np, 3)) in float64."""
    A, b = damped_system(extrinsics, intrinsics, points, obs_cam, obs_group,
                         obs_pt, obs_pix, obs_mask, active, lam, loss_scale,
                         cam_mask, point_mask)
    x = torch.linalg.solve(A, b)
    Nc, Ng = extrinsics.shape[0], intrinsics.shape[0]
    Dc, Dg = 6 * Nc, len(active) * Ng
    return (x[:Dc].reshape(Nc, 6), x[Dc:Dc + Dg].reshape(Ng, -1),
            x[Dc + Dg:].reshape(-1, 3))


def lm_solve(extrinsics, intrinsics, points, obs_cam, obs_group, obs_pt,
             obs_pix, obs_mask, active, iterations, loss_scale,
             initial_lambda, min_lambda=1e-12, max_lambda=1e12,
             cam_mask=None, point_mask=None):
    """`iterations` LM steps from the given start by lm_step; returns
    (extrinsics, intrinsics, points, cost) in float64."""
    f64 = torch.float64
    extr, intr, pts = (x.to(f64) for x in (extrinsics, intrinsics, points))
    obs = (obs_cam, obs_group, obs_pt, obs_pix.to(f64), obs_mask)
    act = torch.tensor(active, dtype=torch.long)
    c = cost(extr, intr, pts, *obs, loss_scale)
    lam = initial_lambda
    for _ in range(iterations):
        dc, dg, dp = lm_step(extr, intr, pts, *obs, active, lam, loss_scale,
                             cam_mask, point_mask)
        intr_n = intr.clone()
        intr_n[:, act] += dg
        cand = (extr + dc, intr_n, pts + dp)
        c_new = cost(*cand, *obs, loss_scale)
        if c_new < c:
            (extr, intr, pts), c = cand, c_new
            lam = max(lam * 0.33, min_lambda)
        else:
            lam = min(lam * 10.0, max_lambda)
    return extr, intr, pts, c
