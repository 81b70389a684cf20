"""DLT PnP: the full projection matrix from N >= 6 2D-3D correspondences,
plus its RQ decomposition into K, R, t (port of
theiasfm_tpu/sfm/pose/dlt_pnp.py).

ref: src/theia/sfm/pose/ projection-matrix utilities and
src/theia/math/matrix/rq_decomposition.h. Batched over leading dims;
the RQ decomposition of each 3x3 block is a closed-form Gram-Schmidt on
its rows (no QR factorization call).
"""
from __future__ import annotations

import math

import torch

from ...math import rotation as rot
from ...utils import linalg


def _normalize(x, w, target):
    """Centroid and isotropic scale (mean distance -> target), weighted
    if w is given. Returns (normalized, mean (..., d), scale (...))."""
    if w is None:
        mean = torch.mean(x, dim=-2, keepdim=True)
        scale = target / torch.clamp(torch.mean(
            torch.linalg.norm(x - mean, dim=-1), dim=-1), min=1e-12)
    else:
        sw = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
        mean = torch.sum(x * w[..., None], dim=-2, keepdim=True) / \
            sw[..., None, None]
        scale = target / torch.clamp(torch.sum(
            torch.linalg.norm(x - mean, dim=-1) * w, dim=-1) / sw,
            min=1e-12)
    return (x - mean) * scale[..., None, None], mean[..., 0, :], scale


def dlt_pnp(world, image, weights=None):
    """Projection matrix P (..., 3, 4) s.t. image ~ P [world; 1].

    world (..., N, 3), image (..., N, 2), N >= 6, optional weights
    (..., N). Returns (P, ok).
    """
    xn, mean2, s2 = _normalize(image, weights, math.sqrt(2.0))
    Xn, mean3, s3 = _normalize(world, weights, math.sqrt(3.0))
    u, v = xn[..., 0], xn[..., 1]
    X = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=-1)
    z = torch.zeros_like(X)
    r1 = torch.cat([X, z, -u[..., None] * X], dim=-1)   # (..., N, 12)
    r2 = torch.cat([z, X, -v[..., None] * X], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    _, vecs = linalg.eigh(A.transpose(-1, -2) @ A)
    P = vecs[..., :, 0].unflatten(-1, (3, 4))
    # denormalize: T2^-1 P T3
    zero, one = torch.zeros_like(s2), torch.ones_like(s2)
    T2_inv = torch.stack([1.0 / s2, zero, mean2[..., 0],
                          zero, 1.0 / s2, mean2[..., 1],
                          zero, zero, one], dim=-1).unflatten(-1, (3, 3))
    T3 = torch.stack([s3, zero, zero, -s3 * mean3[..., 0],
                      zero, s3, zero, -s3 * mean3[..., 1],
                      zero, zero, s3, -s3 * mean3[..., 2],
                      zero, zero, zero, one], dim=-1).unflatten(-1, (4, 4))
    P = T2_inv @ P @ T3
    ok = torch.linalg.norm(P.flatten(-2), dim=-1) > 1e-12
    return P, ok


def _rq3(M):
    """RQ decomposition M = K R of (..., 3, 3) M with K upper triangular
    with a positive diagonal and R orthonormal: Gram-Schmidt on the rows
    from the last (m3 = K33 r3, m2 = K22 r2 + K23 r3, ...), the unique
    such factorization of a nonsingular M."""
    m1, m2, m3 = M[..., 0, :], M[..., 1, :], M[..., 2, :]

    def unit(x):
        n = torch.linalg.norm(x, dim=-1)
        return x / n[..., None], n

    r3, k33 = unit(m3)
    k23 = torch.sum(m2 * r3, dim=-1)
    r2, k22 = unit(m2 - k23[..., None] * r3)
    k13 = torch.sum(m1 * r3, dim=-1)
    k12 = torch.sum(m1 * r2, dim=-1)
    r1, k11 = unit(m1 - k12[..., None] * r2 - k13[..., None] * r3)
    z = torch.zeros_like(k11)
    K = torch.stack([k11, k12, k13, z, k22, k23, z, z, k33],
                    dim=-1).unflatten(-1, (3, 3))
    return K, torch.stack([r1, r2, r3], dim=-2)


def decompose_projection_matrix(P):
    """P (..., 3, 4) -> (K (..., 3, 3) upper-triangular, positive
    diagonal; extrinsics (..., 6) [position, angle-axis]). ref:
    rq_decomposition.h + projection matrix utils. The JAX module takes
    the RQ through a QR of the flipped matrix and then forces a positive
    diagonal; the closed-form RQ here yields that factorization
    directly."""
    K, R = _rq3(P[..., :3])
    # proper rotation: det(-R) = -det(R) for 3x3, so scaling both K and
    # R by det R flips an improper R while preserving M = K R
    detR = linalg.det3(R)[..., None, None]
    R = R * detR
    K = K * detR
    # solve for t BEFORE normalizing K (P and K share the projective
    # scale; normalizing first loses it): back substitution on K t = p4
    b = P[..., 3]
    t3 = b[..., 2] / K[..., 2, 2]
    t2 = (b[..., 1] - K[..., 1, 2] * t3) / K[..., 1, 1]
    t1 = (b[..., 0] - K[..., 0, 1] * t2 - K[..., 0, 2] * t3) / K[..., 0, 0]
    t = torch.stack([t1, t2, t3], dim=-1)
    K = K / K[..., 2:3, 2:3]
    c = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    aa = rot.rotation_matrix_to_angle_axis(R)
    return K, torch.cat([c, aa], dim=-1)


def intrinsics_model(K, extr):
    """(..., 10) [extrinsics(6), focal, aspect, ppx, ppy] from K and the
    extrinsics."""
    return torch.cat([extr, torch.stack(
        [K[..., 0, 0], K[..., 1, 1] / K[..., 0, 0], K[..., 0, 2],
         K[..., 1, 2]], dim=-1)], dim=-1)


def six_point_pnp(world, image):
    """Engine-format minimal solver (sample size 6): world (..., 6, 3),
    image (..., 6, 2) -> (models (..., 1, 10) [extrinsics(6), focal,
    aspect, ppx, ppy], valid (..., 1))."""
    P, ok = dlt_pnp(world, image)
    model = intrinsics_model(*decompose_projection_matrix(P))
    valid = ok & torch.isfinite(model).all(dim=-1)
    return model[..., None, :], valid[..., None]
