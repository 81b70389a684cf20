"""RANSAC estimators for two-view geometry (port of
theiasfm_tpu/sfm/estimators/twoview_estimators.py).

ref: src/theia/sfm/estimators/estimate_relative_pose.cc (5-pt +
Sampson), estimate_fundamental_matrix.cc (8-pt), estimate_homography.cc
(4-pt). Each wires a minimal solver into the batched engine
(solvers/ransac.py) with the reference's residual choices, and a
nonminimal weighted refinement as the RefineModel equivalent.

Data layout: correspondences as a dict {"x1": (..., N, 2), "x2": (...,
N, 2)} in NORMALIZED image coordinates for the calibrated solvers and
pixel coordinates for the uncalibrated ones. The specs follow the
batched engine's contract (solvers.MinimalSolverSpec).
"""
from __future__ import annotations

import functools

import torch

from ...math import rotation as rot
from ...solvers import MinimalSolverSpec, RansacOptions, ransac
from ..ba.two_view import _gauss_newton
from ..pose.eight_point import eight_point_fundamental, npoint_fundamental
from ..pose.five_point import five_point_essential
from ..pose.homography import (four_point_homography,
                               homography_transfer_error_sq,
                               npoint_homography)
from ..pose.radial_homography import (
    radial_homography_symmetric_error_sq,
    six_point_radial_distortion_homography)
from ..pose.twoview_utils import (essential_from_rt,
                                  relative_pose_from_essential,
                                  sampson_distance_sq)
from ._batch import pad_data


def _sampson_residual(p, x1h, x2h, sw):
    """Signed first-order Sampson residual of one pose p = [aa, t]."""
    R = rot.angle_axis_to_rotation_matrix(p[:3])
    t = p[3:6]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    Em = rot.skew(t) @ R
    Ex1 = x1h @ Em.T
    Etx2 = x2h @ Em
    c = torch.sum(x2h * Ex1, dim=-1)
    denom = torch.sqrt(Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 +
                       Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2 + 1e-15)
    return sw * c / denom


def refine_relative_pose_gn(E, x1, x2, w, iters: int = 10):
    """Gauss–Newton on the signed first-order Sampson residual over an
    (angle-axis, translation) parameterization of the essential
    manifold, batched: E (B, 3, 3), x1/x2 (B, N, 2), w (B, N) -> E
    (B, 3, 3). The batched replacement for the reference's
    BundleAdjustTwoViews angular refinement."""
    R0, t0, _ = relative_pose_from_essential(E, x1, x2, mask=w > 0)
    p0 = torch.cat([rot.rotation_matrix_to_angle_axis(R0), t0], dim=-1)
    ones = torch.ones_like(x1[..., :1])
    x1h = torch.cat([x1, ones], dim=-1)
    x2h = torch.cat([x2, ones], dim=-1)
    p = _gauss_newton(_sampson_residual, p0, (x1h, x2h, torch.sqrt(w)),
                      iters, 1e-10)
    R = rot.angle_axis_to_rotation_matrix(p[:, :3])
    t = p[:, 3:6] / torch.clamp(torch.linalg.norm(p[:, 3:6], dim=-1,
                                                  keepdim=True), min=1e-12)
    return essential_from_rt(R, t)


def _pairwise(fn):
    """residuals(models (B, C, 3, 3), data) -> (B, C, N) from a
    two-view error fn(M, x1, x2) that broadcasts."""
    def residuals(M, d):
        return fn(M, d["x1"][:, None], d["x2"][:, None])
    return residuals


def relative_pose_spec() -> MinimalSolverSpec:
    """5-pt essential with Sampson residuals (normalized coords).
    ref: estimate_relative_pose.cc:62-83."""
    def solve(d):
        return five_point_essential(d["x1"], d["x2"])

    def refine(E, d, w):
        return refine_relative_pose_gn(E, d["x1"], d["x2"], w)

    return MinimalSolverSpec("relative_pose", 5, 10, solve,
                             _pairwise(sampson_distance_sq), refine)


def _refine_keep(npoint):
    """Weighted N-point re-estimation, kept where it succeeded."""
    def refine(M, d, w):
        M_new, ok = npoint(d["x1"], d["x2"], weights=w)
        return torch.where(ok[:, None, None], M_new, M)
    return refine


def fundamental_spec() -> MinimalSolverSpec:
    """8-pt fundamental with Sampson residuals (pixel coords).
    ref: estimate_fundamental_matrix.cc."""
    def solve(d):
        return eight_point_fundamental(d["x1"], d["x2"])

    return MinimalSolverSpec("fundamental", 8, 1, solve,
                             _pairwise(sampson_distance_sq),
                             _refine_keep(npoint_fundamental))


def homography_spec() -> MinimalSolverSpec:
    """4-pt homography with forward transfer error.
    ref: estimate_homography.cc."""
    def solve(d):
        return four_point_homography(d["x1"], d["x2"])

    return MinimalSolverSpec("homography", 4, 1, solve,
                             _pairwise(homography_transfer_error_sq),
                             _refine_keep(npoint_homography))


def radial_distortion_homography_spec() -> MinimalSolverSpec:
    """6-pt two-sided radial-distortion homography (H6_l1l2) with the
    symmetric distorted-space transfer error. Model (11,) [vec(H), l1,
    l2]. ref: estimate_radial_distortion_homography.cc."""
    def solve(d):
        return six_point_radial_distortion_homography(d["x1"], d["x2"])

    def residuals(model, d):
        return radial_homography_symmetric_error_sq(
            model, d["x1"][:, None], d["x2"][:, None])

    return MinimalSolverSpec("radial_homography", 6, 2, solve, residuals)


@functools.lru_cache(maxsize=None)
def _singleton_spec(kind: str):
    return {"relative_pose": relative_pose_spec,
            "fundamental": fundamental_spec,
            "homography": homography_spec,
            "radial_homography": radial_distortion_homography_spec}[kind]()


def _estimate(kind, samples, x1, x2, options, mask):
    """Pad the correspondences to a power-of-two bucket of at least 64
    (the JAX module's padding, so both sample over the same N) and run
    RANSAC."""
    data, maskp, n = pad_data({"x1": x1, "x2": x2}, {}, mask, 64)
    model, summary = ransac(samples, _singleton_spec(kind), data, options,
                            data_mask=maskp)
    return model, summary, data["x1"], data["x2"], n


def estimate_relative_pose(samples, x1, x2, options: RansacOptions,
                           mask=None):
    """Full calibrated relative pose: RANSAC 5-pt -> (R, t) by
    cheirality. x1/x2 (N, 2) tensors; samples a torch.Generator or
    (H, 5) indices into the padded data.

    Returns dict(E, R, t, inliers, num_inliers, confidence). The inlier
    mask refers to the first N input correspondences."""
    E, summary, x1p, x2p, n = _estimate("relative_pose", samples, x1, x2,
                                        options, mask)
    R, t, _ = relative_pose_from_essential(E, x1p, x2p,
                                           mask=summary.inliers)
    return {"E": E, "R": R, "t": t, "inliers": summary.inliers[:n],
            "num_inliers": summary.num_inliers,
            "confidence": summary.confidence}


def estimate_fundamental(samples, x1, x2, options: RansacOptions,
                         mask=None):
    F, summary, _, _, n = _estimate("fundamental", samples, x1, x2,
                                    options, mask)
    return {"F": F, "inliers": summary.inliers[:n],
            "num_inliers": summary.num_inliers,
            "confidence": summary.confidence}


def estimate_homography(samples, x1, x2, options: RansacOptions,
                        mask=None):
    H, summary, _, _, n = _estimate("homography", samples, x1, x2,
                                    options, mask)
    return {"H": H, "inliers": summary.inliers[:n],
            "num_inliers": summary.num_inliers,
            "confidence": summary.confidence}


def estimate_radial_distortion_homography(samples, x1, x2,
                                          options: RansacOptions,
                                          mask=None):
    """RANSAC radial homography between two division-model cameras.

    x1, x2 (N, 2) distorted NORMALIZED coordinates; samples a
    torch.Generator or (H, 6) indices into the padded data. Returns
    dict(H, l1, l2, inliers, num_inliers, confidence)
    (ref EstimateRadialHomographyMatrix,
    estimate_radial_distortion_homography.h)."""
    model, summary, _, _, n = _estimate("radial_homography", samples, x1,
                                        x2, options, mask)
    return {"H": model[:9].reshape(3, 3), "l1": model[9], "l2": model[10],
            "inliers": summary.inliers[:n],
            "num_inliers": summary.num_inliers,
            "confidence": summary.confidence}
