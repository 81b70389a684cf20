"""Minimal solver with a known rotation (port of
theiasfm_tpu/sfm/pose/known_rotation.py).

ref: src/theia/sfm/pose/relative_pose_from_two_points_with_known_rotation.{h,cc}
(translation from 2 correspondences given R — a linear epipolar
system). Batched over leading dims.
"""
from __future__ import annotations

import torch


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def relative_pose_from_two_points_with_known_rotation(x1, x2, R):
    """Translation t (unit, up to sign fixed by cheirality) s.t.
    x2h^T [t]_x R x1h = 0 for both correspondences.

    x1/x2 (..., 2, 2) normalized coords; R (..., 3, 3) with
    p2 = R p1 + t. Returns (t (..., 3), valid (...)).
    """
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Rx1 = x1h @ R.transpose(-1, -2)                    # (..., 2, 3)
    # constraint: t . (x2h x Rx1) = 0 -> t ∝ cross of the two normals
    n = _cross(x2h, Rx1)
    t = _cross(n[..., 0, :], n[..., 1, :])
    norm = torch.linalg.norm(t, dim=-1)
    valid = norm > 1e-12
    t = t / torch.where(valid, norm, torch.ones_like(norm))[..., None]
    # cheirality: pick the sign putting point 1 in front of both views
    f1 = x1h[..., 0, :] / torch.linalg.norm(x1h[..., 0, :], dim=-1,
                                            keepdim=True)
    f2 = x2h[..., 0, :] / torch.linalg.norm(x2h[..., 0, :], dim=-1,
                                            keepdim=True)
    Rf1 = (R @ f1[..., None])[..., 0]
    a11 = torch.sum(Rf1 * Rf1, dim=-1)
    a12 = -torch.sum(Rf1 * f2, dim=-1)
    a22 = torch.sum(f2 * f2, dim=-1)
    b1 = -torch.sum(Rf1 * t, dim=-1)
    b2 = torch.sum(f2 * t, dim=-1)
    det = a11 * a22 - a12 * a12
    s1 = (b1 * a22 - a12 * b2) / torch.where(
        det.abs() < 1e-15, torch.full_like(det, 1e-15), det)
    t = torch.where((s1 < 0)[..., None], -t, t)
    return t, valid
