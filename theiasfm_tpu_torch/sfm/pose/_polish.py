"""Batched Gauss-Newton polish with closed-form jacobians, shared by the
sweep-and-polish minimal solvers (p4pf, pnp_focal_radial,
radial_homography).

The JAX modules differentiate each residual with jax.jacfwd under
vmap; here every residual function returns its jacobian in closed form
alongside the residual, so one polish step is a handful of batched
tensor operations over all problems and candidates at once.
"""
from __future__ import annotations

import torch

from ...math import rotation as rot
from ...utils import linalg


def gauss_newton(res_jac, p, iters: int, damping: float):
    """Fixed-iteration GN with step acceptance, batched over leading
    dims: p (..., P); res_jac(p, jac) -> (r (..., m), J (..., m, P) or
    None when jac is False). Each step solves (J^T J + damping I) d =
    J^T r and keeps p - d where it lowers the sum of squares (a NaN or
    inf step never does)."""
    eye = damping * torch.eye(p.shape[-1], dtype=p.dtype, device=p.device)
    for _ in range(iters):
        r, J = res_jac(p, True)
        Jt = J.transpose(-1, -2)
        delta = linalg.solve(Jt @ J + eye, Jt @ r[..., None])[..., 0]
        p_new = p - delta
        r_new, _ = res_jac(p_new, False)
        better = torch.sum(r_new ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        p = torch.where(better[..., None], p_new, p)
    return p


def project_focal(p, world, jac: bool):
    """Pinhole projection with a focal length: p (..., 7) = [position(3),
    angle-axis(3), focal], world (..., N, 3) -> proj (..., N, 2) =
    f * xy / max(z, 1e-6) of R (X - c), and d proj / d p (..., N, 2, 7)
    when jac (else None)."""
    d = world - p[..., None, 0:3]
    aa = p[..., None, 3:6].expand(d.shape)
    if jac:
        pc, Jaa = rot.angle_axis_rotate_point_jacobian(aa, d)
    else:
        pc = rot.angle_axis_rotate_point(aa, d)
    f = p[..., None, 6]
    z = torch.clamp(pc[..., 2], min=1e-6)
    xy = pc[..., :2] / z[..., None]
    proj = xy * f[..., None]
    if not jac:
        return proj, None
    # d proj / d pc: f/z on the diagonal, -f xy/z in the z column (zero
    # where the depth is clamped)
    live = (pc[..., 2] > 1e-6).to(p.dtype)
    fz = f / z
    zero = torch.zeros_like(fz)
    dz = -fz[..., None] * xy * live[..., None]
    dproj_dpc = torch.stack([
        torch.stack([fz, zero, dz[..., 0]], dim=-1),
        torch.stack([zero, fz, dz[..., 1]], dim=-1)], dim=-2)  # (.., 2, 3)
    R = rot.angle_axis_to_rotation_matrix(p[..., 3:6])[..., None, :, :]
    J = torch.cat([-(dproj_dpc @ R), dproj_dpc @ Jaa, xy[..., None]],
                  dim=-1)
    return proj, J
