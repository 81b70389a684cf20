"""Focal length extraction from a fundamental matrix (port of
theiasfm_tpu/sfm/pose/focal_from_fundamental.py).

ref: src/theia/sfm/pose/fundamental_matrix_util.{h,cc}
(FocalLengthsFromFundamentalMatrix — Bougnoux formula) used by the
uncalibrated relative pose estimator
(estimate_uncalibrated_relative_pose.cc). Batched over leading dims.

The JAX module takes each epipole as the smallest eigenvector of
F^T F; for the rank-2 F the estimators produce, the null vector is the
cross product of two rows of F, which the port takes (the pair with the
largest product). In float32 the eigh route loses the epipole at pixel
scale, where F's entries span some six decades (F^T F twelve); the
cross product keeps it.
"""
from __future__ import annotations

import torch

from ...math import rotation as rot


def _null_vec(M):
    """Unit right null vector of rank-2 (..., 3, 3) M: the largest cross
    product of two of its rows."""
    c = torch.stack([torch.linalg.cross(M[..., a, :], M[..., b, :], dim=-1)
                     for a, b in ((0, 1), (0, 2), (1, 2))], dim=-2)
    best = torch.linalg.norm(c, dim=-1).argmax(dim=-1)
    v = torch.gather(c, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _vm(a, M):
    """Row vector (..., 3) times (..., 3, 3)."""
    return (a[..., None, :] @ M)[..., 0, :]


def focal_lengths_from_fundamental(F, pp1, pp2):
    """Bougnoux closed form. F (..., 3, 3) with x2^T F x1 = 0; principal
    points pp1/pp2 (..., 2). Returns (f1, f2, valid), each (...)."""
    p1 = torch.cat([pp1, torch.ones_like(pp1[..., :1])], dim=-1)
    p2 = torch.cat([pp2, torch.ones_like(pp2[..., :1])], dim=-1)
    Ft = F.transpose(-1, -2)
    # epipoles: e1 in image 1 (right null), e2 (left null)
    e1 = _null_vec(F)
    e2 = _null_vec(Ft)
    I2 = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=F.dtype,
                                 device=F.device))

    def f2_sq(F_, e_, pa, pb):
        # Bougnoux, the symmetric expression
        exIF = rot.skew(e_) @ I2 @ F_
        num = -torch.sum(_vm(pb, exIF) * pa, dim=-1) * \
            torch.sum(_vm(pb, F_) * pa, dim=-1)
        den = torch.sum(_vm(pb, exIF @ I2 @ F_.transpose(-1, -2)) * pb,
                        dim=-1)
        return num / torch.where(den.abs() < 1e-20,
                                 torch.full_like(den, 1e-20), den)

    # the pairing for the x2^T F x1 = 0 convention: fa belongs to image
    # 1, fb to image 2
    f1s = f2_sq(F, e2, p1, p2)
    f2s = f2_sq(Ft, e1, p2, p1)
    valid = (f1s > 0) & (f2s > 0)
    f1 = torch.sqrt(torch.clamp(f1s, min=1e-12))
    f2 = torch.sqrt(torch.clamp(f2s, min=1e-12))
    return f1, f2, valid
