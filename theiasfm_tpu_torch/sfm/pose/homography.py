"""4-point (minimal) and weighted N-point homography by normalized DLT
(port of theiasfm_tpu/sfm/pose/homography.py).

ref: src/theia/sfm/pose/four_point_homography.{h,cc}. The same
eigh-based nullspace as eight_point.py; x2 ~ H x1. Batched over
leading dims.
"""
from __future__ import annotations

import torch

from ...utils import linalg
from .eight_point import _normalize_points


def _homography_rows(x1, x2):
    """(..., N, 2, 9) DLT rows for x2 ~ H x1."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([z, z, z, u1, v1, o, -v2 * u1, -v2 * v1, -v2], dim=-1)
    return torch.stack([r1, r2], dim=-2)


def npoint_homography(x1, x2, weights=None):
    """Weighted N >= 4 point homography. Returns (H (..., 3, 3), ok)."""
    x1n, T1 = _normalize_points(x1, weights)
    x2n, T2 = _normalize_points(x2, weights)
    rows = _homography_rows(x1n, x2n)
    if weights is not None:
        rows = rows * weights[..., None, None]
    A = rows.reshape(rows.shape[:-3] + (-1, 9))
    AtA = A.transpose(-1, -2) @ A
    _, vecs = linalg.eigh(AtA)
    H = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 3))
    # denormalize: H = T2^-1 Hn T1
    H = linalg.inv(T2) @ H @ T1
    ok = linalg.det3(H).abs() > 1e-12
    h22 = H[..., 2:3, 2:3]
    H = H / torch.where(h22.abs() < 1e-12, torch.ones_like(h22), h22)
    return H, ok


def four_point_homography(x1, x2):
    """Engine-format minimal solver: x1/x2 (..., 4, 2) ->
    (H (..., 1, 3, 3), valid (..., 1))."""
    H, ok = npoint_homography(x1, x2)
    return H[..., None, :, :], ok[..., None]


def homography_transfer_error_sq(H, x1, x2):
    """Squared forward transfer error |x2 - H x1|^2 (ref homography
    error of estimate_homography.cc). H (..., 3, 3), x (..., N, 2)."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    Hx = x1h @ H.transpose(-1, -2)
    w = Hx[..., 2]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    proj = Hx[..., :2] / w[..., None]
    return torch.sum((proj - x2) ** 2, dim=-1)
