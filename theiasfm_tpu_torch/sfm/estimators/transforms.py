"""RANSAC estimators for 3D-3D transforms, the dominant plane, robust
triangulation and the generalized 2D-3D similarity (port of
theiasfm_tpu/sfm/estimators/transforms.py).

ref: src/theia/sfm/estimators/estimate_rigid_transformation_2d_3d.cc,
estimate_similarity_transformation_2d_3d.cc (here the 3D-3D point
variants used by AlignReconstructions, and gDLS over generalized camera
rays), estimate_dominant_plane_from_points.cc and
estimate_triangulation.cc (RANSAC midpoint triangulation over ray pairs
with reprojection gating). Each entry point takes one problem or a
leading batch of problems, padded as the JAX module pads (`_batch`),
and a torch.Generator or precomputed sample indices into the padded
data.
"""
from __future__ import annotations

import torch

from ...solvers import MinimalSolverSpec, RansacOptions
from ...utils import linalg
from ..pose.gdls import gdls_similarity_transform
from ..pose.p3p import rigid_align
from . import _batch


def _finite(x):
    return torch.isfinite(x).all(dim=-1)


def _transform_model(R, t, s):
    return torch.cat([R.flatten(-2), t, s[..., None]], dim=-1)


def _apply(model, pts):
    """s R p + t of (B, C, 13) models on (B, 1, N, 3) points."""
    R = model[..., :9].unflatten(-1, (3, 3))
    return (pts * model[..., None, 12:13]) @ R.transpose(-1, -2) + \
        model[..., None, 9:12]


def rigid_transform_spec(with_scale: bool = False) -> MinimalSolverSpec:
    """3-point rigid/similarity transform: dst ~ s R src + t.
    Model: (13,) [R.flatten(9), t(3), s(1)]."""
    def scale_of(src, dst, w=None):
        if not with_scale:
            return torch.ones(src.shape[:-2], dtype=src.dtype,
                              device=src.device)
        if w is None:
            ns = torch.linalg.norm(src - src.mean(-2, keepdim=True),
                                   dim=-1).mean(-1)
            nd = torch.linalg.norm(dst - dst.mean(-2, keepdim=True),
                                   dim=-1).mean(-1)
        else:
            sw = torch.clamp(torch.sum(w, dim=-1), min=1e-12)[..., None]
            mu_s = torch.sum(src * w[..., None], dim=-2) / sw
            mu_d = torch.sum(dst * w[..., None], dim=-2) / sw
            ns = torch.sum(torch.linalg.norm(src - mu_s[..., None, :],
                                             dim=-1) * w, dim=-1) / sw[..., 0]
            nd = torch.sum(torch.linalg.norm(dst - mu_d[..., None, :],
                                             dim=-1) * w, dim=-1) / sw[..., 0]
        return nd / torch.clamp(ns, min=1e-12)

    def solve(d):
        src, dst = d["src"], d["dst"]
        s = scale_of(src, dst)
        R, t = rigid_align(src * s[..., None, None], dst)
        model = _transform_model(R, t, s)
        return model[..., None, :], _finite(model)[..., None]

    def residuals(model, d):
        return torch.sum((_apply(model, d["src"][:, None]) -
                          d["dst"][:, None]) ** 2, dim=-1)

    def refine(model, d, w):
        src, dst = d["src"], d["dst"]
        s = scale_of(src, dst, w)
        R, t = rigid_align(src * s[..., None, None], dst, weights=w)
        new = _transform_model(R, t, s)
        return torch.where(_finite(new)[..., None], new, model)

    name = "similarity_transform" if with_scale else "rigid_transform"
    return MinimalSolverSpec(name, 3, 1, solve, residuals, refine)


def estimate_rigid_transform(samples, src, dst, options: RansacOptions,
                             with_scale: bool = False, mask=None):
    """RANSAC rigid (or, with_scale, similarity) transform dst ~ s R src
    + t from (..., N, 3) point pairs, padded to a bucket of 16. Returns
    dict(R, t, scale, inliers, num_inliers)."""
    data, maskp, n = _batch.pad_data({"src": src, "dst": dst}, {}, mask, 16)
    model, summary = _batch.run(samples, rigid_transform_spec(with_scale),
                                data, options, maskp)
    return {"R": model[..., :9].unflatten(-1, (3, 3)),
            "t": model[..., 9:12], "scale": model[..., 12],
            "inliers": summary.inliers[..., :n],
            "num_inliers": summary.num_inliers}


def _midpoint(o, r, w=None):
    """Least-squares intersection of (..., V, 3) rays (origins o, unit
    directions r), optionally weighted."""
    eye = torch.eye(3, dtype=o.dtype, device=o.device)
    A_v = eye - r[..., :, None] * r[..., None, :]
    if w is not None:
        A_v = A_v * w[..., None, None]
    b = (A_v @ o[..., None])[..., 0].sum(dim=-2)
    return linalg.solve(A_v.sum(dim=-3) + 1e-9 * eye, b[..., None])[..., 0]


def triangulation_spec() -> MinimalSolverSpec:
    """Robust N-view triangulation: sample 2 observations -> midpoint;
    residual = angular error between observed and predicted rays.
    Data: {"origins": (N,3), "directions": (N,3) unit world rays}.
    ref: estimate_triangulation.cc."""
    def solve(d):
        X = _midpoint(d["origins"], d["directions"])
        return X[..., None, :], torch.ones(X.shape[:-1] + (1,),
                                           dtype=torch.bool,
                                           device=X.device)

    def residuals(X, d):
        to_pt = X[..., None, :] - d["origins"][:, None]
        dist = torch.linalg.norm(to_pt, dim=-1)
        to_pt = to_pt / torch.clamp(dist[..., None], min=1e-12)
        # squared chordal distance between rays; behind-origin rejected
        err = 2.0 * (1.0 - torch.sum(to_pt * d["directions"][:, None],
                                     dim=-1))
        return torch.where(dist < 1e-9, torch.full_like(err, 1e12), err)

    def refine(X, d, w):
        X_new = _midpoint(d["origins"], d["directions"], w)
        return torch.where(_finite(X_new)[..., None], X_new, X)

    return MinimalSolverSpec("triangulation", 2, 1, solve, residuals,
                             refine)


def estimate_triangulation(samples, origins, directions,
                           options: RansacOptions, mask=None):
    """RANSAC triangulation of (..., N, 3) world rays, padded to a bucket
    of 8 (rays along +z from the origin, masked out). Returns
    dict(point, inliers, num_inliers)."""
    data, maskp, n = _batch.pad_data(
        {"origins": origins, "directions": directions},
        {"directions": [0.0, 0.0, 1.0]}, mask, 8)
    X, summary = _batch.run(samples, triangulation_spec(), data, options,
                            maskp)
    return {"point": X, "inliers": summary.inliers[..., :n],
            "num_inliers": summary.num_inliers}


def plane_spec() -> MinimalSolverSpec:
    """3-point plane RANSAC (ref
    estimate_dominant_plane_from_points.cc). Model: (4,) [n(3), d] with
    n.x + d = 0, ||n|| = 1. Residual: squared point-plane distance."""
    def solve(d):
        p = d["points"]
        n = torch.linalg.cross(p[..., 1, :] - p[..., 0, :],
                               p[..., 2, :] - p[..., 0, :], dim=-1)
        norm = torch.linalg.norm(n, dim=-1)
        ok = norm > 1e-12
        n = n / torch.where(ok, norm, torch.ones_like(norm))[..., None]
        off = -torch.sum(n * p[..., 0, :], dim=-1)
        return torch.cat([n, off[..., None]], dim=-1)[..., None, :], \
            ok[..., None]

    def residuals(model, d):
        return ((d["points"][:, None] @ model[..., :3, None])[..., 0] +
                model[..., None, 3]) ** 2

    def refine(model, d, w):
        # weighted total least squares plane: centroid + smallest
        # eigenvector of the weighted covariance
        p = d["points"]
        sw = torch.clamp(torch.sum(w, dim=-1), min=1e-12)[..., None]
        mu = torch.sum(p * w[..., None], dim=-2) / sw
        q = (p - mu[..., None, :]) * torch.sqrt(w)[..., None]
        _, V = linalg.eigh(q.transpose(-1, -2) @ q)
        n = V[..., :, 0]
        new = torch.cat([n, -torch.sum(n * mu, dim=-1, keepdim=True)],
                        dim=-1)
        return torch.where(_finite(new)[..., None], new, model)

    return MinimalSolverSpec("dominant_plane", 3, 1, solve, residuals,
                             refine)


def estimate_dominant_plane_from_points(samples, points,
                                        options: RansacOptions,
                                        mask=None):
    """RANSAC plane through (..., N, 3) points, padded to a bucket of
    16. Returns dict(plane, inliers, num_inliers)."""
    data, maskp, n = _batch.pad_data({"points": points}, {}, mask, 16)
    model, summary = _batch.run(samples, plane_spec(), data, options,
                                maskp)
    return {"plane": model, "inliers": summary.inliers[..., :n],
            "num_inliers": summary.num_inliers}


def similarity_transform_2d_3d_spec() -> MinimalSolverSpec:
    """4-point gDLS similarity transform from camera rays to 3D points
    (ref estimate_similarity_transformation_2d_3d.cc: RANSAC over
    CameraAndFeatureCorrespondence2D3D with gDLS as the minimal solver).

    Data: {"origin": (N, 3) ray origins, "dir": (N, 3) unit ray
    directions, "point": (N, 3) world points}. Model (13,)
    [R.flatten(9), t(3), s(1)] with R X + t - s o parallel to dir.
    Residual: 1 - cos of the angle between the ray and the transformed
    point — the normalized-space analog of the reference's pixel
    reprojection threshold."""
    def solve(d):
        R, t, s, _ = gdls_similarity_transform(d["origin"], d["dir"],
                                               d["point"], gn_iters=10)
        model = _transform_model(R, t, s)
        return model[..., None, :], _finite(model)[..., None]

    def residuals(model, d):
        R = model[..., :9].unflatten(-1, (3, 3))
        v = d["point"][:, None] @ R.transpose(-1, -2) + \
            model[..., None, 9:12] - \
            model[..., None, 12:13] * d["origin"][:, None]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                            min=1e-12)
        return 1.0 - torch.sum(v * d["dir"][:, None], dim=-1)

    return MinimalSolverSpec("similarity_2d_3d", 4, 1, solve, residuals)


def estimate_similarity_transform_2d_3d(samples, ray_origins, ray_dirs,
                                        points, options: RansacOptions,
                                        mask=None):
    """RANSAC gDLS: the similarity aligning (..., N, 3) 3D points onto
    multi-camera rays, padded to a bucket of 16. error_thresh is on
    (1 - cos angle). Returns dict(R, t, scale, inliers, num_inliers)."""
    data, maskp, n = _batch.pad_data(
        {"origin": ray_origins, "dir": ray_dirs, "point": points},
        {"dir": [0.0, 0.0, 1.0]}, mask, 16)
    model, summary = _batch.run(samples, similarity_transform_2d_3d_spec(),
                                data, options, maskp)
    return {"R": model[..., :9].unflatten(-1, (3, 3)),
            "t": model[..., 9:12], "scale": model[..., 12],
            "inliers": summary.inliers[..., :n],
            "num_inliers": summary.num_inliers}
