"""Calibrated absolute pose: P3P + RANSAC + Gauss-Newton refinement (port
of theiasfm_tpu/sfm/estimators/absolute_pose.py).

ref: src/theia/sfm/estimators/estimate_calibrated_absolute_pose.cc
(P3P minimal solver, squared reprojection residual in normalized
coords). The reference's RefineModel/DLS-PnP nonminimal step is
replaced by a batched fixed-iteration Gauss-Newton on the 6-parameter
extrinsics, the role Ceres plays in BundleAdjustView.

Data layout: {"world": (B, N, 3), "image": (B, N, 2) normalized
coords}. Model: extrinsics (6,) = [position(3), angle-axis(3)]. The
spec follows the batched engine's contract (solvers.MinimalSolverSpec);
where the JAX module takes a PRNG key, `estimate_calibrated_absolute_pose`
takes a torch.Generator or precomputed (H, 3) sample indices.
"""
from __future__ import annotations

import torch

from ...math import rotation as rot
from ...solvers import MinimalSolverSpec, RansacOptions, ransac
from ...utils import linalg
from ..pose.p3p import p3p_grunert
from ._batch import pad_data


def _reproject_sq_error(extr, world, image):
    """Squared normalized reprojection error of extrinsics (..., 6) on
    world (..., N, 3) / image (..., N, 2); 1e12 behind the camera."""
    d = world - extr[..., None, 0:3]
    p_cam = rot.angle_axis_rotate_point(
        extr[..., None, 3:6].expand(d.shape), d)
    z = p_cam[..., 2]
    behind = z < 1e-6
    z_safe = torch.where(behind, torch.ones_like(z), z)
    proj = p_cam[..., :2] / z_safe[..., None]
    err = torch.sum((proj - image) ** 2, dim=-1)
    return torch.where(behind, torch.full_like(err, 1e12), err)


def _residual_vec(p, world, image, weights):
    """Weighted normalized reprojection residuals (2N,) of one pose."""
    p_cam = rot.angle_axis_rotate_point(p[3:6].expand(world.shape),
                                        world - p[0:3])
    z = p_cam[..., 2]
    z = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    proj = p_cam[..., :2] / z[..., None]
    return ((proj - image) * weights[..., None]).reshape(-1)


def refine_absolute_pose_gn(extr, world, image, weights, iters: int = 8,
                            damping: float = 1e-8):
    """Weighted Gauss-Newton on normalized reprojection error, batched:
    extr (B, 6), world (B, N, 3), image (B, N, 2), weights (B, N).

    Fixed iteration count + step acceptance per problem; the damping
    (scaled diagonal plus 1e-12 I) makes it LM-flavoured far from the
    optimum. The jacobians come from torch.func.jacfwd under vmap."""
    res_b = torch.func.vmap(_residual_vec)
    jac_b = torch.func.vmap(torch.func.jacfwd(_residual_vec))
    eye = torch.eye(6, dtype=extr.dtype, device=extr.device)
    p = extr
    for _ in range(iters):
        r = res_b(p, world, image, weights)                  # (B, 2N)
        J = jac_b(p, world, image, weights)                  # (B, 2N, 6)
        Jt = J.transpose(1, 2)
        JtJ = Jt @ J
        diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
        JtJ = JtJ + damping * torch.diag_embed(diag) + 1e-12 * eye
        # a singular system gives inf/NaN, which `better` rejects
        delta = linalg.solve(JtJ, Jt @ r[..., None])[..., 0]
        p_new = p - delta
        better = (torch.sum(res_b(p_new, world, image, weights) ** 2,
                            dim=-1) < torch.sum(r ** 2, dim=-1))
        p = torch.where(better[:, None], p_new, p)
    return p


def absolute_pose_spec() -> MinimalSolverSpec:
    def solve(d):
        return p3p_grunert(d["world"], d["image"])

    def residuals(M, d):
        # M (B, C, 6) against data (B, N, k) -> (B, C, N)
        return _reproject_sq_error(M, d["world"][:, None],
                                   d["image"][:, None])

    def refine(extr, d, w):
        return refine_absolute_pose_gn(extr, d["world"], d["image"], w)

    return MinimalSolverSpec("calibrated_absolute_pose", 3, 4, solve,
                             residuals, refine)


def estimate_calibrated_absolute_pose(samples, world, image,
                                      options: RansacOptions, mask=None):
    """ref: estimate_calibrated_absolute_pose.h. world (N, 3), image
    (N, 2) tensors; the data are padded to a bucket of 64 (unit-depth
    points, masked out), and `samples` (a torch.Generator or (H, 3)
    indices into the padded data) lie on their device. Returns
    dict(extrinsics, inliers, num_inliers, confidence)."""
    data, mask, n = pad_data({"world": world, "image": image},
                             {"world": [0.0, 0.0, 1.0]}, mask, 64)
    extr, summary = ransac(samples, absolute_pose_spec(), data, options,
                           data_mask=mask)
    return {"extrinsics": extr, "inliers": summary.inliers[:n],
            "num_inliers": summary.num_inliers,
            "confidence": summary.confidence}
