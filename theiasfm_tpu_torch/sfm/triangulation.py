"""Batched multi-view triangulation (port of
theiasfm_tpu/sfm/triangulation.py).

ref: src/theia/sfm/triangulation/triangulation.h:48-68 (Triangulate =
Lindstrom iterative optimal two-view, TriangulateDLT,
TriangulateMidpoint, TriangulateNView SVD, cheirality and angle tests).
Every routine works on fixed-size stacked inputs with a validity mask,
so thousands of tracks triangulate in one batched computation.

Projection matrices are (3, 4) world->pixel maps: P = K [R | -R c].
N-view inputs are padded to a fixed `max_views` with `mask`.
"""
from __future__ import annotations

import torch

from ..math import rotation as rot
from ..utils import linalg


def projection_matrix(extrinsics, K):
    """extrinsics (..., 6) [c, aa], K (..., 3, 3) -> P (..., 3, 4)."""
    R = rot.angle_axis_to_rotation_matrix(extrinsics[..., 3:6])
    t = -(R @ extrinsics[..., 0:3, None])
    return K @ torch.cat([R, t], dim=-1)


def calibration_matrix(intr):
    """Padded intrinsics vector -> (..., 3, 3) K (linear part only)."""
    f = intr[..., 0]
    fy = f * intr[..., 1]
    s = intr[..., 2]
    px, py = intr[..., 3], intr[..., 4]
    z = torch.zeros_like(f)
    o = torch.ones_like(f)
    return torch.stack([f, s, px, z, fy, py, z, z, o], dim=-1).reshape(
        intr.shape[:-1] + (3, 3))


def triangulate_dlt(P1, P2, x1, x2):
    """Two-view DLT. P (..., 3, 4); x (..., 2) pixel (or normalized)
    coords. Returns homogeneous (..., 4). ref: TriangulateDLT."""
    rows = torch.stack([
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)  # (..., 4, 4)
    return _smallest_singular_vector(rows)


def triangulate_nview(Ps, xs, mask=None):
    """N-view DLT in normal-equation form: Ps (..., V, 3, 4), xs (...,
    V, 2), mask (..., V) -> homogeneous (..., 4). The smallest
    eigenvector of sum_v A_v^T A_v (4x4) equals the stacked SVD's (ref
    TriangulateNViewSVD) at a fixed size whatever V."""
    rows = torch.stack([
        xs[..., 0, None] * Ps[..., 2, :] - Ps[..., 0, :],
        xs[..., 1, None] * Ps[..., 2, :] - Ps[..., 1, :],
    ], dim=-2)  # (..., V, 2, 4)
    if mask is not None:
        rows = rows * mask[..., None, None]
    A = rows.reshape(rows.shape[:-3] + (-1, 4))
    _, vecs = linalg.eigh(A.transpose(-1, -2) @ A)
    return _canon_homog(vecs[..., :, 0])


def triangulate_midpoint(origins, directions, mask=None):
    """Midpoint of N rays. origins/directions (..., V, 3), unit dirs.
    Solves sum_v (I - d d^T) X = sum_v (I - d d^T) o.
    ref: TriangulateMidpoint."""
    d = directions
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    A_v = eye - d[..., :, None] * d[..., None, :]  # (..., V, 3, 3)
    b_v = (A_v @ origins[..., None])[..., 0]
    if mask is not None:
        A_v = A_v * mask[..., None, None]
        b_v = b_v * mask[..., None]
    A = torch.sum(A_v, dim=-3)
    b = torch.sum(b_v, dim=-2)
    X = linalg.solve(A, b[..., None])[..., 0]
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def triangulate_two_view_optimal(P1, P2, x1, x2, E, iters: int = 10):
    """Lindstrom (2010) iterative optimal two-view triangulation in
    normalized coordinates. x1/x2 NORMALIZED image points (..., 2), E
    the essential matrix mapping 1->2 with x2^T E x1 = 0. The
    correction of ref Triangulate (triangulation.cc:87-124) as a
    fixed-iteration Gauss–Newton on the epipolar residual, then DLT on
    the corrected points."""
    def to_h(x):
        return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)

    E_t = E.transpose(-1, -2)
    x1c, x2c = x1, x2
    for _ in range(iters):
        Ex1 = (E @ to_h(x1c)[..., None])[..., 0]
        Etx2 = (E_t @ to_h(x2c)[..., None])[..., 0]
        c = torch.sum(to_h(x2c) * Ex1, dim=-1)
        n1 = Ex1[..., :2]
        n2 = Etx2[..., :2]
        denom = torch.sum(n1 * n1, dim=-1) + torch.sum(n2 * n2, dim=-1)
        lam = c / torch.where(denom < 1e-15, torch.ones_like(denom), denom)
        # correct the original points
        x1c, x2c = x1 - lam[..., None] * n2, x2 - lam[..., None] * n1
    return triangulate_dlt(P1, P2, x1c, x2c)


def _dehomog(X):
    w = X[..., None, 3:]
    return X[..., None, :3] / torch.where(w.abs() < 1e-15,
                                          torch.full_like(w, 1e-15), w)


def is_in_front_of_cameras(extrinsics, X, mask=None):
    """Cheirality: depth > 0 for every (valid) view. extrinsics (..., V,
    6), X homogeneous (..., 4). ref IsTriangulatedPointInFrontOfCameras."""
    cam_pt = rot.angle_axis_rotate_point(
        extrinsics[..., 3:6], _dehomog(X) - extrinsics[..., 0:3])
    front = cam_pt[..., 2] > 0
    if mask is not None:
        front = front | ~mask
    return torch.all(front, dim=-1)


def triangulation_angles(origins, X, mask=None):
    """Max pairwise angle between viewing rays (degrees), ref
    SufficientTriangulationAngle. origins (..., V, 3); X homogeneous
    (..., 4)."""
    rays = _dehomog(X) - origins
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True),
                              min=1e-15)
    cos = rays @ rays.transpose(-1, -2)
    if mask is not None:
        pair_ok = mask[..., :, None] & mask[..., None, :]
        cos = torch.where(pair_ok, cos, torch.ones_like(cos))
    ang = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    return ang.amax(dim=(-1, -2))


def _smallest_singular_vector(A):
    """Right singular vector of (..., M, 4) A for its smallest singular
    value, by eigh of A^T A, canonicalized."""
    _, vecs = linalg.eigh(A.transpose(-1, -2) @ A)
    return _canon_homog(vecs[..., :, 0])


def _canon_homog(X):
    """Flip the sign so w >= 0 (a stable form for homogeneous points)."""
    return X * torch.where(X[..., 3:] < 0, -1.0, 1.0).to(X.dtype)
