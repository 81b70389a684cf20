"""Absolute pose + focal length + radial distortion minimal solvers
(port of theiasfm_tpu/sfm/pose/pnp_focal_radial.py).

ref: src/theia/sfm/pose/four_point_focal_length_radial_distortion.{h,cc}
(P4Pfr, Larsson et al. ICCV 2017 — Groebner basis) and
src/theia/sfm/pose/five_point_focal_length_radial_distortion.{h,cc}
(P5Pfr, Kukelova et al. ICCV 2013 — null-space + SVD).

The focal sweep of p4pf.py extended to a 2-D (focal, distortion) sweep:

- undistort the observed pixels with each candidate division-model
  distortion k (u = d / (1 + k r^2), the reference's
  DIVISION_UNDISTORTION convention,
  division_undistortion_camera_model.h);
- for each (k, f) grid cell run P3P (Grunert) on 3-point subsets and
  score the held-out point(s) by undistorted reprojection;
- polish the best candidates with a joint Gauss-Newton over
  (position, angle-axis, focal, k1[, k2, k3]) with a closed-form
  jacobian.

The grid is one batched P3P call over (problems x K x F x subsets) and
the polish one batched GN over (problems x candidates). With 4 points
and one distortion parameter the system is exactly determined (8
residuals, 8 unknowns), so the polish converges to the algebraic root.
"""
from __future__ import annotations

import math

import torch

from ...math import rotation as rot
from ._polish import gauss_newton, project_focal
from .p3p import p3p_grunert
from .p4pf import _focal_grid, _gather_last

__all__ = ["four_point_focal_length_radial_distortion",
           "five_point_focal_length_radial_distortion"]

_NUM_FOCAL = 16
_NUM_DIST = 12
_MAX_MODELS = 4


def _sweep_candidates(world, image_px, focal_lo, focal_hi, dist_lo,
                      dist_hi):
    """(f, k) grid sweep. Returns (extrs (..., C, 6), focals (..., C),
    ks (..., C), errs (..., C)) over all C = K*F*S*4 candidates, in the
    JAX module's (k, f, subset, solution) order."""
    n = world.shape[-2]
    dev, dt = world.device, world.dtype
    focals = _focal_grid(image_px, focal_lo, focal_hi, _NUM_FOCAL)  # (.., F)
    r2 = torch.sum(image_px ** 2, dim=-1)                           # (.., n)
    r2max = torch.clamp(r2.amax(dim=-1), min=1e-9)
    # normalized distortion kappa = k * r2max, mostly barrel (k < 0)
    kappas = torch.linspace(dist_lo, dist_hi, _NUM_DIST, dtype=dt,
                            device=dev)
    ks = kappas / r2max[..., None]                                  # (.., K)

    # 3-point subsets; held-out indices score the model
    if n == 4:
        subsets, held = [[0, 1, 2], [0, 1, 3]], [[3], [2]]
    else:
        subsets = [[0, 1, 2], [0, 3, 4], [1, 2, 3]]
        held = [[3, 4], [1, 2], [0, 4]]
    sel = torch.tensor(subsets, device=dev)                         # (S, 3)
    hel = torch.tensor(held, device=dev)                            # (S, h)

    undist = image_px[..., None, :, :] / \
        (1.0 + ks[..., :, None] * r2[..., None, :])[..., None]      # (.., K, n, 2)
    norm = undist[..., None, :, :] / \
        focals[..., None, :, None, None]                            # (.., K, F, n, 2)
    n3 = norm[..., sel, :]                                          # (.., K, F, S, 3, 2)
    w3 = world[..., sel, :][..., None, None, :, :, :].expand(
        n3.shape[:-1] + (3,))
    extr, valid = p3p_grunert(w3, n3)                               # (.., K, F, S, 4, 6)
    wh = world[..., hel, :][..., None, None, :, None, :, :]         # (.., 1, 1, S, 1, h, 3)
    nh = norm[..., hel, :][..., None, :, :]                         # (.., K, F, S, 1, h, 2)
    e = extr[..., None, :]
    p_cam = rot.angle_axis_rotate_point(
        e[..., 3:6].expand(e.shape[:-2] + (hel.shape[1], 3)),
        wh - e[..., 0:3])
    z = p_cam[..., 2]
    bad = (z < 1e-6).any(dim=-1)
    proj = p_cam[..., :2] / torch.clamp(z, min=1e-6)[..., None]
    err = torch.sum((proj - nh) ** 2, dim=(-2, -1))
    err = torch.where(valid & ~bad, err, torch.full_like(err, math.inf))

    K, F, S4 = _NUM_DIST, _NUM_FOCAL, len(subsets) * 4
    batch = world.shape[:-2]
    flat_extr = extr.reshape(batch + (K * F * S4, 6))
    flat_err = err.reshape(batch + (K * F * S4,))
    flat_f = focals[..., None, :, None].expand(batch + (K, F, S4)).reshape(
        batch + (-1,))
    flat_k = ks[..., :, None, None].expand(batch + (K, F, S4)).reshape(
        batch + (-1,))
    return flat_extr, flat_f, flat_k, flat_err


def _polish(world, image_px, p0, num_radial, iters):
    """Joint GN over (extrinsics 6, focal, k1..k_nr) on all points.
    Residual in undistorted pixel space:
    f * project(R (X - c)) - px / (1 + k1 r^2 + k2 r^4 + k3 r^6)."""
    r2 = torch.sum(image_px ** 2, dim=-1)

    def res_jac(p, jac):
        proj, J = project_focal(p[..., :7], world, jac)
        w = torch.ones_like(r2)
        pows = []
        rpow = r2
        for j in range(num_radial):
            w = w + p[..., 7 + j, None] * rpow
            pows.append(rpow)
            rpow = rpow * r2
        undist = image_px / w[..., None]
        r = (proj - undist).flatten(-2)
        if not jac:
            return r, None
        # d(-px / w) / d k_j = px r^(2(j+1)) / w^2
        dk = [(image_px * (pw / (w * w))[..., None])[..., None]
              for pw in pows]
        J = torch.cat([J] + dk, dim=-1)
        return r, J.flatten(-3, -2)

    return gauss_newton(res_jac, p0, iters, 1e-8)


def _solve(world, image_px, num_radial, iters, focal_lo, focal_hi,
           dist_lo, dist_hi):
    flat_extr, flat_f, flat_k, flat_err = _sweep_candidates(
        world, image_px, focal_lo, focal_hi, dist_lo, dist_hi)
    order = torch.argsort(flat_err, dim=-1, stable=True)[..., :_MAX_MODELS]
    cand_valid = torch.isfinite(torch.gather(flat_err, -1, order))
    k0 = torch.gather(flat_k, -1, order)[..., None]
    p0 = torch.cat([_gather_last(flat_extr, order),
                    torch.gather(flat_f, -1, order)[..., None], k0,
                    torch.zeros(k0.shape[:-1] + (num_radial - 1,),
                                dtype=k0.dtype, device=k0.device)], dim=-1)
    polished = _polish(world[..., None, :, :], image_px[..., None, :, :],
                       p0, num_radial, iters)
    valid = cand_valid & (polished[..., 6] > 0) & \
        torch.isfinite(polished).all(dim=-1)
    return polished, valid


def four_point_focal_length_radial_distortion(
        world, image_px, focal_lo: float = 0.2, focal_hi: float = 5.0,
        dist_lo: float = -0.7, dist_hi: float = 0.15):
    """P4Pfr: pose + focal + one division-model distortion from 4
    2D-3D matches (ref FourPointsPoseFocalLengthRadialDistortion,
    four_point_focal_length_radial_distortion.h:55-71).

    world (..., 4, 3); image_px (..., 4, 2) DISTORTED pixels centered on
    the principal point. dist_lo/hi bound k * r_max^2.

    Returns (models (..., 4, 8) [position(3), angle-axis(3), focal, k],
    valid (..., 4)). Projection convention: undistorted pixel
    u = f * proj(R (X - c)); distorted d satisfies u = d / (1 + k |d|^2).
    """
    return _solve(world, image_px, 1, 15, focal_lo, focal_hi, dist_lo,
                  dist_hi)


def five_point_focal_length_radial_distortion(
        world, image_px, num_radial: int = 1,
        focal_lo: float = 0.2, focal_hi: float = 5.0,
        dist_lo: float = -0.7, dist_hi: float = 0.15):
    """P5Pfr: pose + focal + 1-3 division-model distortion parameters
    from 5 2D-3D matches (ref FivePointFocalLengthRadialDistortion,
    five_point_focal_length_radial_distortion.h:46-76; the reference
    returns up-to-scale projection matrices — here the calibrated
    decomposition [position, angle-axis, focal, k1..k_nr] directly).

    Returns (models (..., 4, 7 + num_radial), valid (..., 4)).
    """
    if num_radial not in (1, 2, 3):
        raise ValueError(f"num_radial must be 1, 2 or 3, not {num_radial}")
    return _solve(world, image_px, num_radial, 20, focal_lo, focal_hi,
                  dist_lo, dist_hi)
