"""Two-sided radial-distortion homography, H6_l1l2 (port of
theiasfm_tpu/sfm/pose/radial_homography.py).

ref: src/theia/sfm/pose/six_point_radial_distortion_homography.{h,cc} —
the 6-point two-sided radial homography solver of Kukelova et al.
(CVPR 2015, "Radial distortion homography"): a plane-induced homography
between two cameras that each follow the one-parameter division model,

    (x2, y2, 1 + l2 r2^2)^T  ~  H (x1, y1, 1 + l1 r1^2)^T ,

with r^2 the squared DISTORTED radius in normalized image coordinates.

The problem is linear in H once (l1, l2) are fixed, so, as in the JAX
module, a 2-D grid over [lmin, lmax]^2 is swept — one batched SVD of
12x9 DLT matrices over (problems x cells), ranked by the smallest
singular value — and the best cells polished with a joint Gauss-Newton
over (H, l1, l2) on the algebraic constraints, with a closed-form
jacobian. On clean data the polished minima are exact roots; the
reference's H6 variant returns 2 solutions, mirrored by `top`.
"""
from __future__ import annotations

import torch

from ...utils import linalg
from ._polish import gauss_newton
from .p4pf import _gather_last

__all__ = ["six_point_radial_distortion_homography",
           "radial_homography_symmetric_error_sq",
           "distort_division_homogeneous", "undistorted_homogeneous"]

_GRID = 14


def undistorted_homogeneous(x, l):
    """(..., N, 2) distorted normalized points, l (...) -> (..., N, 3)
    undistorted homogeneous vectors (x, y, 1 + l r^2) of the division
    model."""
    r2 = torch.sum(x ** 2, dim=-1)
    l = torch.as_tensor(l, dtype=x.dtype, device=x.device)
    w = 1.0 + l[..., None] * r2
    return torch.cat([x.expand(w.shape + (2,)), w[..., None]], dim=-1)


def distort_division_homogeneous(y, l):
    """Inverse of `undistorted_homogeneous`: map a homogeneous
    undistorted vector y (..., 3) to the distorted 2-D point d with
    (d, 1 + l |d|^2) ~ y. Solves t^2 - y_z t + l rho^2 = 0 for the
    scale t (rho^2 = y_x^2 + y_y^2), picking the root that tends to
    y_z as l -> 0 (the physical branch: t with the sign of y_z)."""
    rho2 = y[..., 0] ** 2 + y[..., 1] ** 2
    yz = y[..., 2]
    disc = torch.sqrt(torch.clamp(yz ** 2 - 4.0 * l * rho2, min=0.0))
    sgn = torch.where(yz < 0, -torch.ones_like(yz), torch.ones_like(yz))
    t = 0.5 * (yz + sgn * disc)
    t = torch.where(t.abs() < 1e-12, 1e-12 * sgn, t)
    return y[..., :2] / t[..., None]


def _dlt_matrix(u1, u2):
    """(..., 12, 9) DLT matrix A with A h = 0 for h = vec(H) (row-major)
    from (..., 6, 3) undistorted homogeneous points."""
    z = torch.zeros_like(u1)
    # rows: [-w2 u1, 0, x2 u1] and [0, -w2 u1, y2 u1]
    r1 = torch.cat([-u2[..., 2:3] * u1, z, u2[..., 0:1] * u1], dim=-1)
    r2 = torch.cat([z, -u2[..., 2:3] * u1, u2[..., 1:2] * u1], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _algebraic(p, x1, x2, jac: bool):
    """Algebraic residuals (..., 2N) of p = [vec(H), l1, l2] and, when
    jac, their jacobian (..., 2N, 11)."""
    r1 = torch.sum(x1 ** 2, dim=-1)
    r2 = torch.sum(x2 ** 2, dim=-1)
    u1 = undistorted_homogeneous(x1, p[..., 9])
    u2 = undistorted_homogeneous(x2, p[..., 10])
    H = p[..., :9].unflatten(-1, (3, 3))
    y = u1 @ H.transpose(-1, -2)                       # (.., N, 3)
    rA = u2[..., 0] * y[..., 2] - u2[..., 2] * y[..., 0]
    rB = u2[..., 1] * y[..., 2] - u2[..., 2] * y[..., 1]
    r = torch.cat([rA, rB], dim=-1)
    if not jac:
        return r, None
    z = torch.zeros_like(u1)
    # d y_a / d H_ab = u1_b; d y / d l1 = H[:, 2] r1^2; d u2_z / d l2 = r2^2
    dA_h = torch.cat([-u2[..., 2:3] * u1, z, u2[..., 0:1] * u1], dim=-1)
    dB_h = torch.cat([z, -u2[..., 2:3] * u1, u2[..., 1:2] * u1], dim=-1)
    dy_l1 = H[..., None, :, 2] * r1[..., None]          # (.., N, 3)
    dA_l1 = u2[..., 0] * dy_l1[..., 2] - u2[..., 2] * dy_l1[..., 0]
    dB_l1 = u2[..., 1] * dy_l1[..., 2] - u2[..., 2] * dy_l1[..., 1]
    dA_l2 = -r2 * y[..., 0]
    dB_l2 = -r2 * y[..., 1]
    JA = torch.cat([dA_h, dA_l1[..., None], dA_l2[..., None]], dim=-1)
    JB = torch.cat([dB_h, dB_l1[..., None], dB_l2[..., None]], dim=-1)
    return r, torch.cat([JA, JB], dim=-2)


def six_point_radial_distortion_homography(x1, x2, lmin: float = -2.0,
                                           lmax: float = 0.5,
                                           top: int = 2,
                                           gn_iters: int = 15):
    """x1, x2: (..., 6, 2) distorted NORMALIZED image points (inv(K) *
    p, matching six_point_radial_distortion_homography.h:61-75).

    Returns (models (..., top, 11) [vec(H) row-major with unit
    Frobenius norm, l1, l2], valid (..., top)): the numbers of the JAX
    module's dict {"H", "l1", "l2"}, flat, as the engine stores models.
    """
    dt, dev = x1.dtype, x1.device
    ls = torch.linspace(lmin, lmax, _GRID, dtype=dt, device=dev)
    l1 = ls[:, None].expand(_GRID, _GRID).reshape(-1)      # (G*G,)
    l2 = ls[None, :].expand(_GRID, _GRID).reshape(-1)
    u1 = undistorted_homogeneous(x1[..., None, :, :], l1)  # (.., G*G, 6, 3)
    u2 = undistorted_homogeneous(x2[..., None, :, :], l2)
    _, s, Vt = linalg.svd(_dlt_matrix(u1, u2), full_matrices=False)
    flat_h = Vt[..., -1, :]                                # (.., G*G, 9)
    flat_s = s[..., -1]
    order = torch.argsort(flat_s, dim=-1, stable=True)[..., :top]
    p0 = torch.cat([_gather_last(flat_h, order), l1[order][..., None],
                    l2[order][..., None]], dim=-1)         # (.., top, 11)

    xb1, xb2 = x1[..., None, :, :], x2[..., None, :, :]

    def res_jac(p, jac):
        r, J = _algebraic(p, xb1, xb2, jac)
        gauge = torch.sum(p[..., :9] ** 2, dim=-1) - 1.0
        r = torch.cat([r, gauge[..., None]], dim=-1)
        if jac:
            dg = torch.cat([2.0 * p[..., :9],
                            torch.zeros_like(p[..., 9:])], dim=-1)
            J = torch.cat([J, dg[..., None, :]], dim=-2)
        return r, J

    ps = gauss_newton(res_jac, p0, gn_iters, 1e-10)
    costs = torch.sum(_algebraic(ps, xb1, xb2, False)[0] ** 2, dim=-1)
    h = ps[..., :9]
    h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                        min=1e-12)
    valid = torch.isfinite(costs) & torch.isfinite(ps).all(dim=-1)
    return torch.cat([h, ps[..., 9:]], dim=-1), valid


def radial_homography_symmetric_error_sq(model, x1, x2):
    """Symmetric transfer error in distorted normalized coordinates
    (ref CheckRadialSymmetricError,
    six_point_radial_distortion_homography.h:86-90, with focal = 1).
    model (..., 11) [vec(H), l1, l2]; x1, x2 (..., N, 2). Returns
    (..., N)."""
    H = model[..., :9].unflatten(-1, (3, 3))
    l1, l2 = model[..., 9], model[..., 10]
    u1 = undistorted_homogeneous(x1, l1)
    u2 = undistorted_homogeneous(x2, l2)
    fwd = u1 @ H.transpose(-1, -2)                     # predicted undist 2
    Hinv = linalg.inv3(H + 1e-15 * torch.eye(3, dtype=H.dtype,
                                             device=H.device))
    bwd = u2 @ Hinv.transpose(-1, -2)                  # predicted undist 1
    d2 = distort_division_homogeneous(fwd, l2[..., None])
    d1 = distort_division_homogeneous(bwd, l1[..., None])
    return (torch.sum((d2 - x2) ** 2, dim=-1) +
            torch.sum((d1 - x1) ** 2, dim=-1))
