"""P3P — absolute pose from 3 world points + 3 calibrated rays (port of
theiasfm_tpu/sfm/pose/p3p.py).

ref: src/theia/sfm/pose/perspective_three_point.{h,cc} (Kneip's P3P).
The same problem solved through Grunert's classical depth formulation
(Haralick et al., IJCV 1994 review): the two ratio equations between
the three law-of-cosines constraints reduce to a quartic in v = s3/s1,
assembled from fixed-size coefficient products and solved with the
batched Aberth finder (math/polynomial.py). Each real root yields
depths -> camera-frame points -> rigid alignment (Horn) to the world
points. Up to 4 (R, t) solutions.

Batched over leading dims: solve(world (..., 3, 3), rays (..., 3, 2)
normalized image coords) -> (extrinsics (..., 4, 6), valid (..., 4))
with extrinsics = [position, angle-axis], the camera.models layout.
"""
from __future__ import annotations

import torch

from ...math import polynomial as poly
from ...math import rotation as rot
from ...utils import linalg


def _conv(a, b):
    """Polynomial product over the last dim, coefficient vectors
    highest-degree first (jnp.convolve's full mode), batched."""
    n, m = a.shape[-1], b.shape[-1]
    out = a.new_zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]) +
                      (n + m - 1,))
    for i in range(n):
        out[..., i:i + m] += a[..., i:i + 1] * b
    return out


def rigid_align(src, dst, weights=None):
    """Least-squares rigid transform: dst ~ R @ src + t (Horn/Umeyama,
    ref: sfm/transformation/align_point_clouds.h). src/dst (..., N, 3).
    The batch of 3x3 SVDs goes to linalg.svd in one call."""
    if weights is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    else:
        w = weights
    sw = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2) / sw
    mu_d = torch.sum(dst * w[..., None], dim=-2) / sw
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (dc * w[..., None]).transpose(-1, -2) @ sc
    U, _, Vt = linalg.svd(cov)
    d = linalg.det3(U @ Vt)
    D = torch.ones(cov.shape[:-2] + (3,), dtype=cov.dtype,
                   device=cov.device)
    D = torch.cat([D[..., :2], d[..., None]], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def p3p_grunert(world, image):
    """world (..., 3, 3); image (..., 3, 2) normalized (undistorted,
    focal-removed). Returns (extrinsics (..., 4, 6), valid (..., 4))."""
    f = torch.cat([image, torch.ones_like(image[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)  # unit rays

    p1, p2, p3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]
    a = torch.linalg.norm(p2 - p3, dim=-1)  # opposite vertex 1
    b = torch.linalg.norm(p1 - p3, dim=-1)  # opposite vertex 2
    c = torch.linalg.norm(p1 - p2, dim=-1)  # opposite vertex 3
    cos_al = _dot(f[..., 1, :], f[..., 2, :])
    cos_be = _dot(f[..., 0, :], f[..., 2, :])
    cos_ga = _dot(f[..., 0, :], f[..., 1, :])

    b2 = torch.clamp(b * b, min=1e-15)
    A = (a * a) / b2
    C = (c * c) / b2

    # s2 = u s1, s3 = v s1. Ratio equations:
    #  eq1: u^2 + v^2 - 2 u v cos_al - A (1 + v^2 - 2 v cos_be) = 0
    #  eq2: 1 + u^2 - 2 u cos_ga - C (1 + v^2 - 2 v cos_be) = 0
    # eq1 - eq2 is linear in u:  u * 2(cos_ga - v cos_al) + N(v) = 0
    # with N(v) = v^2 - 1 - (A - C)(1 + v^2 - 2 v cos_be)
    # => u = N(v) / D(v),  D(v) = 2 (v cos_al - cos_ga)
    AC = A - C
    Nv = torch.stack([1.0 - AC, 2.0 * AC * cos_be, -1.0 - AC], dim=-1)
    Dv = torch.stack([2.0 * cos_al, -2.0 * cos_ga], dim=-1)

    # Substitute u = N/D into eq2 multiplied by D^2:
    #   N^2 - 2 cos_ga N D + (1 - C - C v^2 + 2 C v cos_be) D^2 = 0
    Q = torch.stack([-C, 2.0 * C * cos_be, 1.0 - C], dim=-1)
    ND = _conv(Nv, Dv)
    quart = (_conv(Nv, Nv)
             - 2.0 * cos_ga[..., None] * torch.cat(
                 [torch.zeros_like(ND[..., :1]), ND], dim=-1)
             + _conv(Q, _conv(Dv, Dv)))  # degree 4 -> 5 coeffs

    roots = poly.poly_roots(quart, iters=60)
    real = poly.real_roots_mask(roots, rel_tol=1e-4, abs_tol=1e-7)
    v = roots.real  # (..., 4)

    denom_u = 2.0 * (v * cos_al[..., None] - cos_ga[..., None])
    denom_u = torch.where(denom_u.abs() < 1e-12,
                          torch.full_like(denom_u, 1e-12), denom_u)
    u = poly.polyval(Nv[..., None, :], v) / denom_u
    s1_sq = b2[..., None] / torch.clamp(
        1.0 + v * v - 2.0 * v * cos_be[..., None], min=1e-15)
    s1 = torch.sqrt(s1_sq)
    s2 = u * s1
    s3 = v * s1
    valid = real & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points, (..., 4 solutions, 3 points, 3)
    depths = torch.stack([s1, s2, s3], dim=-1)
    cam_pts = depths[..., None] * f[..., None, :, :]
    world_b = world[..., None, :, :].expand(cam_pts.shape)
    # camera extrinsics: p_cam = R (X - pos) -> align world->cam
    R, t = rigid_align(world_b, cam_pts)
    aa = rot.rotation_matrix_to_angle_axis(R)
    pos = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # c = -R^T t
    return torch.cat([pos, aa], dim=-1), valid
