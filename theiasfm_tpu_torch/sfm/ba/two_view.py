"""Two-view bundle adjustment (port of theiasfm_tpu/sfm/ba/two_view.py).

ref: src/theia/sfm/bundle_adjustment/bundle_adjust_two_views.{h,cc}
(refine the relative pose of a verified pair on the angular epipolar
error) and optimize_relative_position_with_known_rotation.{h,cc}
(global pipeline step 5).

Small fixed-iteration Gauss–Newton problems, batched over leading dims:
every pair is one problem, and all of them step together (a step is
kept per problem only where it lowers that problem's cost). The
jacobians come from torch.func.jacfwd under vmap over the flattened
batch. The tensors' device is the caller's.
"""
from __future__ import annotations

import torch

from ...math import rotation as rot
from ...utils import linalg


def _gauss_newton(residual, p, args, iters, damping):
    """Fixed-iteration GN on a batch: p (B, D); residual(p_one, *arg_one)
    -> (N,); args are (B, ...) tensors."""
    res_b = torch.func.vmap(residual)
    jac_b = torch.func.vmap(torch.func.jacfwd(residual))
    eye = damping * torch.eye(p.shape[-1], dtype=p.dtype, device=p.device)
    for _ in range(iters):
        r = res_b(p, *args)                                 # (B, N)
        J = jac_b(p, *args)                                 # (B, N, D)
        Jt = J.transpose(1, 2)
        # a singular system gives inf/NaN, which `better` rejects (on
        # the card torch.linalg.solve would raise)
        delta = linalg.solve(Jt @ J + eye, (Jt @ r[..., None]))[..., 0]
        p_new = p - delta
        better = (torch.sum(res_b(p_new, *args) ** 2, dim=-1) <
                  torch.sum(r ** 2, dim=-1))
        p = torch.where(better[:, None], p_new, p)
    return p


def _unit(t):
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def bundle_adjust_two_views_angular(aa_rel, t_rel, x1, x2, weights,
                                    iters: int = 10):
    """Refine (R, t) on the ANGULAR epipolar error over normalized
    correspondences (ref AngularEpipolarError / BundleAdjustTwoViews
    angular mode). aa_rel, t_rel (..., 3); x1, x2 (..., N, 2); weights
    (..., N). Returns (aa_refined (..., 3), t_refined_unit (..., 3))."""
    batch = aa_rel.shape[:-1]
    N = x1.shape[-2]
    p0 = torch.cat([aa_rel, t_rel], dim=-1).reshape(-1, 6)
    sw = torch.sqrt(weights).reshape(-1, N)
    f1 = _unit(_homogeneous(x1)).reshape(-1, N, 3)
    f2 = _unit(_homogeneous(x2)).reshape(-1, N, 3)

    def residual(p, f1_, f2_, sw_):
        R = rot.angle_axis_to_rotation_matrix(p[:3])
        E = rot.skew(_unit(p[3:6])) @ R
        # angular epipolar error: f2^T E f1 (normalized rays)
        return sw_ * torch.einsum("ni,ij,nj->n", f2_, E, f1_)

    p = _gauss_newton(residual, p0, (f1, f2, sw), iters, 1e-12)
    return (p[:, :3].reshape(batch + (3,)),
            _unit(p[:, 3:6]).reshape(batch + (3,)))


def optimize_relative_position_with_known_rotation(
        rel_position, R1, R2, x1, x2, weights, iters: int = 12):
    """Refine the relative position t (unit) given FIXED global
    rotations, from feature correspondences (ref
    optimize_relative_position_with_known_rotation.cc — global pipeline
    step 5). Minimizes the epipolar constraint with rotations folded
    in: for rays r1 = R1^T f1, r2 = R2^T f2 (world frame), residual =
    t . (r1 x r2) scaled — the 'translation direction' constraint.

    rel_position (..., 3): initial position of camera 2 in the camera-1
    frame; R1, R2 (..., 3, 3); x1, x2 (..., N, 2); weights (..., N).
    Returns the refined unit position_2 (..., 3), camera-1 frame."""
    batch = rel_position.shape[:-1]
    N = x1.shape[-2]
    R1f = R1.reshape(-1, 3, 3)
    # world-frame rays: R^T applied rowwise
    r1 = _unit(_homogeneous(x1).reshape(-1, N, 3) @ R1f)
    r2 = _unit(_homogeneous(x2).reshape(-1, N, 3) @ R2.reshape(-1, 3, 3))
    cross = torch.linalg.cross(r1, r2, dim=-1)
    cross = cross * torch.sqrt(weights).reshape(-1, N)[..., None]
    # direction in the world frame
    t0_world = (rel_position.reshape(-1, 1, 3) @ R1f)[:, 0]

    def residual(t, cross_):
        return cross_ @ _unit(t)

    t = _unit(_gauss_newton(residual, t0_world, (cross,), iters, 1e-10))
    # keep the sign consistent with the initialization
    sign = torch.where(torch.sum(t * t0_world, dim=-1) < 0, -1.0, 1.0)
    t_world = t * sign[:, None].to(t.dtype)
    # back to the camera-1 frame
    return (R1f @ t_world[..., None])[..., 0].reshape(batch + (3,))
