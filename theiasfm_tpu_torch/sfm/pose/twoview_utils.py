"""Shared two-view geometry utilities, batched (port of
theiasfm_tpu/sfm/pose/twoview_utils.py).

ref: src/theia/sfm/pose/util.h, essential_matrix_utils.h,
fundamental_matrix_util.h — Sampson/epipolar distances, essential
matrix composition/decomposition, cheirality-based pose selection.
Convention throughout: x2^T M x1 = 0 with M mapping image 1 -> image 2,
and the relative pose (R, t) maps camera-1 coordinates to camera-2:
p2 = R p1 + t. E = [t]_x R. Leading dims broadcast: a (B, C, 3, 3)
stack of models against (B, 1, N, 2) points gives (B, C, N).
"""
from __future__ import annotations

import torch

from ...math import rotation as rot
from ...utils import linalg


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epipolar_terms(F, x1, x2):
    """F [x1;1], F^T [x2;1] (..., N, 3) and x2h^T F x1h (..., N)."""
    x1h, x2h = _homog(x1), _homog(x2)
    Fx1 = x1h @ F.transpose(-1, -2)
    Ftx2 = x2h @ F
    c = torch.sum(x2h * Fx1, dim=-1)
    return Fx1, Ftx2, c


def sampson_distance_sq(F, x1, x2):
    """Squared Sampson distance. F (..., 3, 3); x1/x2 (..., N, 2).

    ref: sfm/pose/util.cc SquaredSampsonDistance."""
    Fx1, Ftx2, c = _epipolar_terms(F, x1, x2)
    denom = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 +
             Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return c * c / torch.clamp(denom, min=1e-15)


def epipolar_distance_sq(F, x1, x2):
    """Squared symmetric epipolar (point-to-line) distance."""
    Fx1, Ftx2, c = _epipolar_terms(F, x1, x2)
    d1 = c * c / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2,
                             min=1e-15)
    d2 = c * c / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2,
                             min=1e-15)
    return 0.5 * (d1 + d2)


def essential_from_rt(R, t):
    """E = [t]_x R, normalized so ||t|| = 1 (..., 3, 3)."""
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                        min=1e-15)
    return rot.skew(t) @ R


def decompose_essential(E):
    """E -> (R1, R2, t) candidate factors via SVD (ref
    essential_matrix_utils.cc DecomposeEssentialMatrix). Four pose
    candidates: (R1, t), (R1, -t), (R2, t), (R2, -t)."""
    U, _, Vt = linalg.svd(E)
    # det(U), det(V) = +1 for proper rotations
    U = U * torch.sign(linalg.det3(U))[..., None, None]
    Vt = Vt * torch.sign(linalg.det3(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0], [1, 0, 0], [0, 0, 1]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return R1, R2, t


def _depths_two_view(R, t, x1, x2):
    """Two-view depths (s1, s2) per correspondence: for rays f1 (cam 1)
    and f2 (cam 2), with p2 = R p1 + t, the least-squares solution of
    [R f1, -f2] [s1, s2]^T = -t in closed form. R (..., 3, 3), t
    (..., 3), x1/x2 normalized (..., N, 2)."""
    f1 = _homog(x1)
    f2 = _homog(x2)
    Rf1 = f1 @ R.transpose(-1, -2)
    a11 = torch.sum(Rf1 * Rf1, dim=-1)
    a12 = -torch.sum(Rf1 * f2, dim=-1)
    a22 = torch.sum(f2 * f2, dim=-1)
    b1 = -torch.sum(Rf1 * t[..., None, :], dim=-1)
    b2 = torch.sum(f2 * t[..., None, :], dim=-1)
    det = a11 * a22 - a12 * a12
    det = torch.where(det.abs() < 1e-15, torch.full_like(det, 1e-15), det)
    s1 = (b1 * a22 - a12 * b2) / det
    s2 = (a11 * b2 - a12 * b1) / det
    return s1, s2


def relative_pose_from_essential(E, x1, x2, mask=None):
    """Select the (R, t) among the four essential decompositions with
    the most points passing cheirality (ref
    GetBestPoseFromEssentialMatrix); the first on a tie.

    E (..., 3, 3); x1/x2 normalized (..., N, 2); mask (..., N).
    Returns (R (..., 3, 3), t (..., 3), num_in_front (...,)).
    """
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)        # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)          # (..., 4, 3)
    s1, s2 = _depths_two_view(Rs, ts, x1[..., None, :, :],
                              x2[..., None, :, :])    # (..., 4, N)
    ok = (s1 > 0) & (s2 > 0)
    if mask is not None:
        ok = ok & mask[..., None, :]
    counts = ok.sum(dim=-1)
    best = torch.argmax(counts, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    t_best = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    n = torch.gather(counts, -1, best[..., None])[..., 0]
    return R, t_best, n


def fundamental_from_projections(P1, P2):
    """F from two (3, 4) projection matrices (ref
    fundamental_matrix_util.cc FundamentalMatrixFromProjectionMatrices):
    F_ij = (-1)^(i+j) det [P1 minus row j; P2 minus row i]."""
    rows = [0, 1, 2]
    F = []
    for i in rows:
        for j in rows:
            X = torch.stack([P1[..., k, :] for k in rows if k != j] +
                            [P2[..., k, :] for k in rows if k != i], dim=-2)
            F.append(((-1.0) ** (i + j)) * torch.linalg.det(X))
    return torch.stack(F, dim=-1).reshape(P1.shape[:-2] + (3, 3))


def _kinv(f, pp, like):
    """Inverse pinhole calibration (..., 3, 3) for focal f (...) and
    principal point pp (..., 2) (zeros when None)."""
    f = torch.as_tensor(f, dtype=like.dtype, device=like.device)
    if pp is None:
        pp = torch.zeros(f.shape + (2,), dtype=like.dtype,
                         device=like.device)
    pp = torch.as_tensor(pp, dtype=like.dtype, device=like.device)
    inv = 1.0 / f
    z, o = torch.zeros_like(inv), torch.ones_like(inv)
    return torch.stack([inv, z, -pp[..., 0] / f,
                        z, inv, -pp[..., 1] / f,
                        z, z, o], dim=-1).reshape(f.shape + (3, 3))


def fundamental_from_essential(E, f1, f2, pp1=None, pp2=None):
    """F = K2^-T E K1^-1 for simple pinhole K (focal f, principal pp);
    f (...) and pp (..., 2) batch with E (..., 3, 3)."""
    return _kinv(f2, pp2, E).transpose(-1, -2) @ E @ _kinv(f1, pp1, E)
