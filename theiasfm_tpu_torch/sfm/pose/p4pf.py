"""P4Pf — absolute pose + focal length from 4 correspondences (port of
theiasfm_tpu/sfm/pose/p4pf.py).

ref: src/theia/sfm/pose/four_point_focal_length.{h,cc} (Bujnak et al.'s
Groebner-basis minimal solver). The same interface through a FOCAL
SWEEP: P3P (Grunert) on 3 of the points for each of F log-spaced focal
candidates (all F * 8 solutions of one problem in one batched P3P
call), scored by the held-out point's reprojection, then a joint
Gauss-Newton polish over (extrinsics, focal) with a closed-form
jacobian. Batched over leading dims.
"""
from __future__ import annotations

import math

import torch

from ...math import rotation as rot
from ._polish import gauss_newton, project_focal
from .p3p import p3p_grunert

_NUM_FOCAL_CANDIDATES = 24
_MAX_MODELS = 4
# the two 3-point subsets and the point each holds out
_SUBSETS = ([0, 1, 2], [0, 1, 3])
_HELD = (3, 2)


def _focal_grid(image_px, lo, hi, num):
    """(..., num) focal candidates: [lo, hi] log-spaced, times 1.5 x the
    largest image coordinate magnitude."""
    base = torch.clamp(image_px.abs().amax(dim=(-2, -1)), min=1e-6) * 1.5
    fracs = 10.0 ** torch.linspace(math.log10(lo), math.log10(hi), num,
                                   dtype=image_px.dtype,
                                   device=image_px.device)
    return base[..., None] * fracs


def _gather_last(x, idx):
    """x (..., C, *k), idx (..., m) -> (..., m, *k)."""
    extra = x.shape[idx.dim():]
    i = idx.reshape(idx.shape + (1,) * len(extra)).expand(
        idx.shape + extra)
    return torch.gather(x, idx.dim() - 1, i)


def p4pf(world, image_px, focal_lo: float = 0.2, focal_hi: float = 5.0):
    """world (..., 4, 3); image_px (..., 4, 2) pixels CENTERED on the
    principal point. Focal candidates span [lo, hi] times 1.5 x the
    largest image coordinate magnitude.

    Returns (models (..., 4, 7) [position, angle-axis, focal], valid
    (..., 4)).
    """
    focals = _focal_grid(image_px, focal_lo, focal_hi,
                         _NUM_FOCAL_CANDIDATES)              # (..., F)
    norm = image_px[..., None, :, :] / focals[..., :, None, None]
    sel = torch.tensor(_SUBSETS, device=world.device)
    held = torch.tensor(_HELD, device=world.device)
    w3 = world[..., sel, :]                                  # (.., 2, 3, 3)
    n3 = norm[..., sel, :]                                   # (.., F, 2, 3, 2)
    extr, valid = p3p_grunert(w3[..., None, :, :, :].expand(
        n3.shape[:-1] + (3,)), n3)                           # (.., F, 2, 4, 6)
    wh = world[..., held, :][..., None, :, None, :]          # (.., 1, 2, 1, 3)
    nh = norm[..., held, :][..., None, :]                    # (.., F, 2, 1, 2)
    p_cam = rot.angle_axis_rotate_point(extr[..., 3:6],
                                        wh - extr[..., 0:3])
    z = p_cam[..., 2]
    bad = z < 1e-6
    proj = p_cam[..., :2] / torch.where(bad, torch.ones_like(z),
                                        z)[..., None]
    err = torch.sum((proj - nh) ** 2, dim=-1)
    err = torch.where(valid & ~bad, err, torch.full_like(err, math.inf))

    flat_err = err.flatten(-3)                               # (..., F*8)
    order = torch.argsort(flat_err, dim=-1, stable=True)[..., :_MAX_MODELS]
    cand_extr = _gather_last(extr.flatten(-4, -2), order)    # (..., 4, 6)
    cand_f = torch.gather(focals, -1, order // 8)
    cand_valid = torch.isfinite(torch.gather(flat_err, -1, order))

    # joint GN polish over (extrinsics 6, focal 1) on all 4 points
    wb = world[..., None, :, :]
    ib = image_px[..., None, :, :]

    def res_jac(p, jac):
        proj, J = project_focal(p, wb, jac)
        r = (proj - ib).flatten(-2)
        return r, (None if J is None else J.flatten(-3, -2))

    p0 = torch.cat([cand_extr, cand_f[..., None]], dim=-1)
    polished = gauss_newton(res_jac, p0, 15, 1e-8)
    valid = cand_valid & (polished[..., 6] > 0) & \
        torch.isfinite(polished).all(dim=-1)
    return polished, valid
