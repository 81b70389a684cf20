"""Uncalibrated estimators: absolute pose with unknown focal (P4Pf or
the 6-point DLT) and relative pose with unknown focals (8-pt +
Bougnoux) (port of theiasfm_tpu/sfm/estimators/uncalibrated.py).

ref: src/theia/sfm/estimators/estimate_uncalibrated_absolute_pose.cc
(the P4Pf minimal solver, model extrinsics + focal) and
estimate_uncalibrated_relative_pose.cc (8-pt + focal extraction +
decomposition). The entry points take one problem or a leading batch of
problems (`_batch.run`) and, where the JAX module takes a PRNG key, a
torch.Generator or precomputed sample indices into the padded data.
"""
from __future__ import annotations

import torch

from ...math import rotation as rot
from ...solvers import MinimalSolverSpec, RansacOptions
from ..pose.dlt_pnp import (decompose_projection_matrix, dlt_pnp,
                            intrinsics_model, six_point_pnp)
from ..pose.eight_point import eight_point_fundamental, npoint_fundamental
from ..pose.focal_from_fundamental import focal_lengths_from_fundamental
from ..pose.p4pf import p4pf
from ..pose.twoview_utils import (relative_pose_from_essential,
                                  sampson_distance_sq)
from . import _batch


def _camera_points(model, world):
    """World points (B, 1, N, 3) in the frames of models (B, C, >= 6)
    -> (B, C, N, 3)."""
    d = world - model[..., None, 0:3]
    return rot.angle_axis_rotate_point(
        model[..., None, 3:6].expand(d.shape), d)


def _refine_dlt(model, d, w):
    """Weighted DLT re-estimation on the inliers, kept where it
    succeeded (ref Estimator::RefineModel)."""
    P, ok = dlt_pnp(d["world"], d["image"], weights=w)
    new = intrinsics_model(*decompose_projection_matrix(P))
    good = ok & torch.isfinite(new).all(dim=-1)
    return torch.where(good[..., None], new, model)


def p4pf_spec() -> MinimalSolverSpec:
    """4-pt pose+focal minimal solver (ref P4Pf role,
    estimate_uncalibrated_absolute_pose.cc). Model: (10,) padded
    [extrinsics(6), focal, aspect=1, ppx=0, ppy=0]; data in
    principal-point-centered pixels."""
    def solve(d):
        models, valid = p4pf(d["world"], d["image"])      # (..., 4, 7)
        pad = torch.zeros(models.shape[:-1] + (3,), dtype=models.dtype,
                          device=models.device)
        pad[..., 0] = 1.0  # aspect
        return torch.cat([models, pad], dim=-1), valid

    def residuals(model, d):
        p_cam = _camera_points(model, d["world"][:, None])
        z = p_cam[..., 2]
        bad = z < 1e-6
        zs = torch.where(bad, torch.ones_like(z), z)
        proj = p_cam[..., :2] / zs[..., None] * model[..., None, 6:7]
        err = torch.sum((proj - d["image"][:, None]) ** 2, dim=-1)
        return torch.where(bad, torch.full_like(err, 1e12), err)

    return MinimalSolverSpec("p4pf", 4, 4, solve, residuals, _refine_dlt)


def uncalibrated_absolute_pose_spec() -> MinimalSolverSpec:
    """Model: (10,) [extrinsics(6), focal, aspect, ppx, ppy].
    Data: {"world": (N,3), "image": (N,2) pixels (pp-centered ok)}."""
    def solve(d):
        return six_point_pnp(d["world"], d["image"])

    def residuals(model, d):
        p_cam = _camera_points(model, d["world"][:, None])
        f, a, px, py = (model[..., None, i] for i in (6, 7, 8, 9))
        z = p_cam[..., 2]
        bad = z < 1e-6
        zs = torch.where(bad, torch.ones_like(z), z)
        u = f * p_cam[..., 0] / zs + px
        v = f * a * p_cam[..., 1] / zs + py
        img = d["image"][:, None]
        err = (u - img[..., 0]) ** 2 + (v - img[..., 1]) ** 2
        return torch.where(bad, torch.full_like(err, 1e12), err)

    return MinimalSolverSpec("uncalibrated_absolute_pose", 6, 1, solve,
                             residuals, _refine_dlt)


def estimate_uncalibrated_absolute_pose(samples, world, image,
                                        options: RansacOptions,
                                        mask=None):
    """RANSAC P4Pf. world (..., N, 3), image (..., N, 2) pixels centered
    on the principal point, one problem or a leading batch; the data
    are padded to a bucket of 64 (unit-depth points, masked out) and
    `samples` (a torch.Generator or (..., H, 4) indices into the padded
    data) lie on their device. Returns dict(extrinsics, focal_length,
    intrinsics_tail, inliers, num_inliers, confidence)."""
    data, maskp, n = _batch.pad_data(
        {"world": world, "image": image}, {"world": [0.0, 0.0, 1.0]},
        mask, 64)
    model, summary = _batch.run(samples, p4pf_spec(), data, options, maskp)
    return {"extrinsics": model[..., :6], "focal_length": model[..., 6],
            "intrinsics_tail": model[..., 7:],
            "inliers": summary.inliers[..., :n],
            "num_inliers": summary.num_inliers,
            "confidence": summary.confidence}


def uncalibrated_relative_pose_spec() -> MinimalSolverSpec:
    """8-pt fundamental scored with Sampson (pixels); focal extraction
    happens after RANSAC. Data {"x1", "x2"} in principal-point-centered
    pixel coordinates."""
    def solve(d):
        return eight_point_fundamental(d["x1"], d["x2"])

    def residuals(F, d):
        return sampson_distance_sq(F, d["x1"][:, None], d["x2"][:, None])

    def refine(F, d, w):
        F_new, ok = npoint_fundamental(d["x1"], d["x2"], weights=w)
        return torch.where(ok[..., None, None], F_new, F)

    return MinimalSolverSpec("uncalibrated_relative_pose", 8, 1, solve,
                             residuals, refine)


def estimate_uncalibrated_relative_pose(samples, x1_centered, x2_centered,
                                        options: RansacOptions,
                                        mask=None):
    """x coordinates (..., N, 2) must be principal-point-centered
    pixels; one problem or a leading batch, padded to a bucket of 64.
    Returns F, the focal lengths (Bougnoux), and (R, t) from the implied
    essential matrix (ref estimate_uncalibrated_relative_pose.cc)."""
    data, maskp, n = _batch.pad_data(
        {"x1": x1_centered, "x2": x2_centered}, {}, mask, 64)
    F, summary = _batch.run(samples, uncalibrated_relative_pose_spec(),
                            data, options, maskp)
    zero = torch.zeros(F.shape[:-2] + (2,), dtype=F.dtype, device=F.device)
    f1, f2, focal_valid = focal_lengths_from_fundamental(F, zero, zero)
    # E = K2^T F K1 (pp at origin)
    one = torch.ones_like(f1)
    K1 = torch.diag_embed(torch.stack([f1, f1, one], dim=-1))
    K2 = torch.diag_embed(torch.stack([f2, f2, one], dim=-1))
    E = K2.transpose(-1, -2) @ F @ K1
    x1n = data["x1"] / f1[..., None, None]
    x2n = data["x2"] / f2[..., None, None]
    R, t, _ = relative_pose_from_essential(E, x1n, x2n,
                                           mask=summary.inliers)
    return {"F": F, "focal_length_1": f1, "focal_length_2": f2,
            "focal_valid": focal_valid, "R": R, "t": t,
            "inliers": summary.inliers[..., :n],
            "num_inliers": summary.num_inliers,
            "confidence": summary.confidence}
