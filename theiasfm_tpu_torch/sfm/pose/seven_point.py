"""7-point fundamental matrix, up to 3 solutions (port of
theiasfm_tpu/sfm/pose/seven_point.py).

ref: src/theia/sfm/pose/seven_point_fundamental_matrix.{h,cc}.
F = F1 + lam * F2 over the 2-dim nullspace of the 7x9 epipolar system;
det(F) = 0 gives a cubic in lam solved with the batched Aberth finder.
Batched over leading dims.

The JAX module takes the nullspace from eigh of A^T A; here it is the
last two columns of the complete QR's Q of A^T (five_point's Householder
routine), which keeps float32 accuracy (eigh of the normal matrix
squares A's condition number) and runs the same arithmetic on every
device. Any basis of the nullspace gives the same solutions F.
"""
from __future__ import annotations

import torch

from ...math import polynomial as poly
from .eight_point import _epipolar_rows, _normalize_points
from .five_point import _householder_nullspace


def _det3_poly(F1, F2):
    """Coefficients (highest first, degree 3) of det(F1 + lam F2)."""
    def det_mix(A, B, C):
        # sum over permutations with columns from A, B, C respectively
        return (A[..., 0, 0] * (B[..., 1, 1] * C[..., 2, 2] -
                                B[..., 2, 1] * C[..., 1, 2])
                - A[..., 1, 0] * (B[..., 0, 1] * C[..., 2, 2] -
                                  B[..., 2, 1] * C[..., 0, 2])
                + A[..., 2, 0] * (B[..., 0, 1] * C[..., 1, 2] -
                                  B[..., 1, 1] * C[..., 0, 2]))

    c3 = det_mix(F2, F2, F2)
    c2 = det_mix(F1, F2, F2) + det_mix(F2, F1, F2) + det_mix(F2, F2, F1)
    c1 = det_mix(F1, F1, F2) + det_mix(F1, F2, F1) + det_mix(F2, F1, F1)
    c0 = det_mix(F1, F1, F1)
    return torch.stack([c3, c2, c1, c0], dim=-1)


def seven_point_fundamental(x1, x2):
    """x1/x2 (..., 7, 2) -> (F (..., 3, 3, 3), valid (..., 3)).
    Engine-format minimal solver with max_models=3; invalid slots
    masked."""
    x1n, T1 = _normalize_points(x1)
    x2n, T2 = _normalize_points(x2)
    A = _epipolar_rows(x1n, x2n)                          # (..., 7, 9)
    null = _householder_nullspace(A.transpose(-1, -2))    # (..., 9, 2)
    F1 = null[..., :, 0].unflatten(-1, (3, 3))
    F2 = null[..., :, 1].unflatten(-1, (3, 3))
    roots = poly.poly_roots(_det3_poly(F1, F2), iters=60)
    real = poly.real_roots_mask(roots, rel_tol=1e-4, abs_tol=1e-7)
    lam = roots.real[..., None, None]                      # (..., 3, 1, 1)
    Fs = F1[..., None, :, :] + lam * F2[..., None, :, :]
    Fs = T2.transpose(-1, -2)[..., None, :, :] @ Fs @ T1[..., None, :, :]
    norm = torch.linalg.norm(Fs.flatten(-2), dim=-1)
    Fs = Fs / torch.clamp(norm[..., None, None], min=1e-12)
    return Fs, real & (norm > 1e-12)
