"""EPnP: closed-form O(N) perspective-n-point (port of
theiasfm_tpu/sfm/pose/epnp.py).

ref role: src/theia/sfm/pose/dls_pnp.{h,cc} and upnp.{h,cc} — the
reference's nonminimal PnP solvers. EPnP (Lepetit et al., IJCV 2009)
fills the same role: 4 control points via PCA, barycentric
coordinates, a 12-dim nullspace from eigh of M^T M, the single-beta
case solved in closed form, then rigid alignment. Batched over leading
dims.
"""
from __future__ import annotations

import torch

from ...math import rotation as rot
from ...utils import linalg
from .p3p import rigid_align

_PAIR_A = [0, 0, 0, 1, 1, 2]
_PAIR_B = [1, 2, 3, 2, 3, 3]


def _pair_d(P):
    return torch.linalg.norm(P[..., _PAIR_A, :] - P[..., _PAIR_B, :],
                             dim=-1)


def epnp(world, image, weights=None):
    """world (..., N, 3); image (..., N, 2) normalized coords; N >= 6;
    optional weights (..., N).

    Returns (extrinsics (..., 6) [position, angle-axis], ok (...)).
    """
    w = torch.ones(world.shape[:-1], dtype=world.dtype,
                   device=world.device) if weights is None else weights
    sw = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    sqw = torch.sqrt(w)[..., None]

    # control points: centroid + principal axes (weighted PCA)
    c0 = torch.sum(world * w[..., None], dim=-2) / sw[..., None]
    centered = (world - c0[..., None, :]) * sqw
    cov = centered.transpose(-1, -2) @ centered / sw[..., None, None]
    eigval, eigvec = linalg.eigh(cov)
    scale = torch.sqrt(torch.clamp(eigval, min=1e-12))
    ctrl = torch.cat([c0[..., None, :], c0[..., None, :] + (
        eigvec * scale[..., None, :]).transpose(-1, -2)], dim=-2)  # (.., 4, 3)

    # barycentric coordinates: world = alphas @ ctrl, sum(alpha) = 1
    ones4 = torch.ones_like(ctrl[..., :1, :1]).expand(ctrl.shape[:-2] + (1, 4))
    A = torch.cat([ctrl.transpose(-1, -2), ones4], dim=-2)         # (.., 4, 4)
    b = torch.cat([world.transpose(-1, -2),
                   torch.ones_like(world[..., :1]).transpose(-1, -2)],
                  dim=-2)                                          # (.., 4, N)
    alphas = linalg.solve(A, b).transpose(-1, -2)                  # (.., N, 4)

    # M: each observation gives 2 rows over the 12 control-point coords
    # [x of 4 ctrl pts in the camera frame, y, z]
    u, v = image[..., 0:1], image[..., 1:2]
    zero = torch.zeros_like(alphas)
    rows_u = torch.cat([alphas, zero, -u * alphas], dim=-1)        # (.., N, 12)
    rows_v = torch.cat([zero, alphas, -v * alphas], dim=-1)
    M = torch.cat([rows_u * sqw, rows_v * sqw], dim=-2)            # (.., 2N, 12)
    _, V = linalg.eigh(M.transpose(-1, -2) @ M)
    # beta case 1: camera ctrl points = beta * v0, the scale from the
    # preserved pairwise control-point distances
    v0 = V[..., :, 0]
    cc = torch.stack([v0[..., 0:4], v0[..., 4:8], v0[..., 8:12]], dim=-1)
    d_w = _pair_d(ctrl)
    d_c = _pair_d(cc)
    beta = torch.sum(d_w * d_c, dim=-1) / torch.clamp(
        torch.sum(d_c * d_c, dim=-1), min=1e-15)
    cc = cc * beta[..., None, None]
    # enforce positive depth of the point cloud
    pts_cam = alphas @ cc
    neg = torch.sum(pts_cam[..., 2] * w, dim=-1) < 0
    cc = torch.where(neg[..., None, None], -cc, cc)

    # rigid transform world ctrl -> camera ctrl
    R, t = rigid_align(ctrl, cc)
    aa = rot.rotation_matrix_to_angle_axis(R)
    pos = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    extr = torch.cat([pos, aa], dim=-1)
    return extr, torch.isfinite(extr).all(dim=-1)
