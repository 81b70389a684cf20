"""Normalized 8-point fundamental matrix, minimal and weighted N-point
(port of theiasfm_tpu/sfm/pose/eight_point.py).

ref: src/theia/sfm/pose/eight_point_fundamental_matrix.{h,cc}
(Hartley-normalized DLT + rank-2 projection). The nullspace comes from
eigh of the 9x9 normal matrix; weights fold in as W in A^T W A, so the
same code is the minimal solver, the nonminimal refinement and the
IRLS inner step. Batched over leading dims.
"""
from __future__ import annotations

import math

import torch

from ...utils import linalg


def _normalize_points(x, w=None):
    """Hartley normalization -> (x_norm, T) with T (..., 3, 3) s.t.
    x_norm = T @ [x;1]. Weighted centroid/scale if w given."""
    if w is None:
        mean = torch.mean(x, dim=-2, keepdim=True)
        d = torch.linalg.norm(x - mean, dim=-1)
        scale = math.sqrt(2.0) / torch.clamp(torch.mean(d, dim=-1),
                                             min=1e-12)
    else:
        sw = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
        mean = torch.sum(x * w[..., None], dim=-2, keepdim=True) / \
            sw[..., None, None]
        d = torch.linalg.norm(x - mean, dim=-1)
        scale = math.sqrt(2.0) / torch.clamp(
            torch.sum(d * w, dim=-1) / sw, min=1e-12)
    xn = (x - mean) * scale[..., None, None]
    z, o = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([scale, z, -scale * mean[..., 0, 0],
                     z, scale, -scale * mean[..., 0, 1],
                     z, z, o], dim=-1).reshape(scale.shape + (3, 3))
    return xn, T


def _epipolar_rows(x1, x2):
    """Rows a with a . vec(F) = 0 for x2^T F x1 = 0. (..., N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                        u1, v1, one], dim=-1)


def npoint_fundamental(x1, x2, weights=None, enforce_rank2: bool = True):
    """Weighted N >= 8 point fundamental. x1/x2 (..., N, 2).

    Returns (F (..., 3, 3), ok (...,) bool)."""
    x1n, T1 = _normalize_points(x1, weights)
    x2n, T2 = _normalize_points(x2, weights)
    A = _epipolar_rows(x1n, x2n)
    if weights is not None:
        A = A * weights[..., None]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = linalg.eigh(AtA)
    F = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 3))
    if enforce_rank2:
        U, s, Vt = linalg.svd(F)
        s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
        F = (U * s[..., None, :]) @ Vt
    # denormalize: x2^T T2^T F T1 x1
    F = T2.transpose(-1, -2) @ F @ T1
    norm = torch.linalg.norm(F.flatten(-2), dim=-1)
    ok = norm > 1e-12
    F = F / torch.clamp(norm[..., None, None], min=1e-12)
    return F, ok


def eight_point_fundamental(x1, x2):
    """Minimal 8-point solver in engine format: x1/x2 (..., 8, 2) ->
    (F (..., 1, 3, 3), valid (..., 1))."""
    F, ok = npoint_fundamental(x1, x2)
    return F[..., None, :, :], ok[..., None]
