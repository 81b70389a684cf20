"""Similarity transforms and reconstruction alignment (port of
theiasfm_tpu/sfm/transformation.py).

ref: src/theia/sfm/transformation/align_point_clouds.{h,cc} (Umeyama),
align_reconstructions.{h,cc} (robust similarity alignment of camera
positions), align_rotations.{h,cc}, transform_reconstruction.cc.

`align_point_clouds` and `align_reconstructions_robust` are numpy
float64 on the host, as in the JAX module (a handful of camera
positions; the same `np.random.default_rng(seed)` draws, so the same
answer). `align_rotations` runs its float64 Gauss-Newton on `device`
with a closed-form jacobian.
"""
from __future__ import annotations

import numpy as np
import torch

from ..math import rotation as rot
from ..utils.device import resolve_device


def align_point_clouds(src, dst, with_scale: bool = True):
    """Umeyama least-squares similarity: dst ~ s R src + t.

    Returns (s, R (3,3), t (3,)). ref: AlignPointCloudsUmeyama. Host
    numpy in float64 (the reference's Eigen runs in double)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.array([1.0, 1.0, d])
    R = (U * D[None, :]) @ Vt
    var_s = np.mean(np.sum(sc * sc, axis=-1))
    s = float(np.sum(S * D) / max(var_s, 1e-15)) if with_scale else 1.0
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def align_reconstructions_robust(src_pos, dst_pos, n_trials: int = 200,
                                 inlier_thresh_factor: float = 3.0,
                                 seed: int = 0):
    """RANSAC-robust similarity alignment of matched camera positions
    (ref: AlignReconstructions, align_reconstructions.cc — robust to
    gross outliers in either reconstruction). Returns (s, R, t)."""
    rng = np.random.default_rng(seed)
    src = np.asarray(src_pos)
    dst = np.asarray(dst_pos)
    n = len(src)
    if n < 3:
        return align_point_clouds(src, dst)
    best_inl, best = -1, None
    scale0 = np.median(np.linalg.norm(dst - np.median(dst, 0), axis=1))
    thresh = inlier_thresh_factor * max(scale0, 1e-9) * 0.1
    for _ in range(n_trials):
        idx = rng.choice(n, 3, replace=False)
        try:
            s, R, t = align_point_clouds(src[idx], dst[idx])
        except Exception:
            continue
        pred = s * src @ R.T + t
        err = np.linalg.norm(pred - dst, axis=1)
        inl = err < thresh
        if inl.sum() > best_inl:
            best_inl, best = inl.sum(), inl
    if best is None or best_inl < 3:
        return align_point_clouds(src, dst)
    s, R, t = align_point_clouds(src[best], dst[best])
    # final refit on inliers of the refit
    pred = s * src @ R.T + t
    err = np.linalg.norm(pred - dst, axis=1)
    inl = err < thresh
    if inl.sum() >= 3:
        s, R, t = align_point_clouds(src[inl], dst[inl])
    return s, R, t


def _aa_jacobian_right(aa):
    """d aa(R(aa) exp([dx]_x)) / d dx at dx = 0: the inverse of the
    right jacobian of SO(3), J_r^{-1}(aa) = I + 0.5 [aa]_x +
    (1/th^2 - (1 + cos th) / (2 th sin th)) [aa]_x^2 (batched, Taylor
    branch 1/12 below 1e-4 rad)."""
    th2 = (aa * aa).sum(-1)
    th = torch.sqrt(th2)
    small = th < 1e-4
    ths = torch.where(small, torch.ones_like(th), th)
    c = torch.where(small, torch.full_like(th, 1.0 / 12.0),
                    1.0 / (ths * ths) -
                    (1.0 + torch.cos(ths)) / (2.0 * ths * torch.sin(ths)))
    K = rot.skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + 0.5 * K + c[..., None, None] * (K @ K)


def align_rotations(gt_rotations, rotations, iters: int = 20,
                    device="cuda"):
    """Find the single rotation R* minimizing
    sum_i || aa(R_i @ R*) - aa(gt_i) ||^2 and return the aligned
    rotations (angle-axis, (N, 3), numpy).

    ref: src/theia/sfm/transformation/align_rotations.{h,cc} — Ceres
    autodiff LM over the 3-parameter alignment; here a float64
    Gauss-Newton on `device` (the card by default; it raises without
    one) on the same residual as the JAX module's, seeded by the
    chordal-L2 closed form (SVD of sum_i R_i^T gt_i). The JAX module
    differentiates the residual with jax.jacfwd; here the jacobian is
    closed form: R(a_i(x)) = R_i R(x), so d a_i / d x =
    J_r^{-1}(a_i) J_r(x) with J_r the right jacobian of SO(3), held to
    jacfwd at 1e-10 by the tests."""
    device = resolve_device(device)
    gt = torch.as_tensor(np.asarray(gt_rotations, np.float64),
                         device=device)
    aa = torch.as_tensor(np.asarray(rotations, np.float64), device=device)
    R_un = rot.angle_axis_to_rotation_matrix(aa)
    R_gt = rot.angle_axis_to_rotation_matrix(gt)
    # closed-form chordal seed: argmax_R sum tr((R_un_i R)^T R_gt_i)
    M = torch.einsum("nji,njk->ik", R_un, R_gt)
    U, _, Vt = torch.linalg.svd(M)
    eye = torch.eye(3, dtype=torch.float64, device=device)
    D = eye.clone()
    D[2, 2] = torch.sign(torch.linalg.det(U @ Vt))
    x = rot.rotation_matrix_to_angle_axis(U @ D @ Vt)
    for _ in range(iters):
        a = rot.rotation_matrix_to_angle_axis(
            R_un @ rot.angle_axis_to_rotation_matrix(x))
        r = (a - gt).reshape(-1)
        J = (_aa_jacobian_right(a) @ _right_jacobian(x)).reshape(-1, 3)
        H = J.T @ J + 1e-12 * eye
        x = x - torch.linalg.solve(H, J.T @ r)
    aligned = R_un @ rot.angle_axis_to_rotation_matrix(x)
    return rot.rotation_matrix_to_angle_axis(aligned).cpu().numpy()


def _right_jacobian(x):
    """The right jacobian of SO(3) at x: R(x + dx) = R(x) exp([J_r dx]_x)
    to first order; J_r = I - (1 - cos th)/th^2 [x]_x +
    (th - sin th)/th^3 [x]_x^2 (Taylor branch below 1e-4 rad)."""
    th2 = (x * x).sum(-1)
    th = torch.sqrt(th2)
    small = th < 1e-4
    ths = torch.where(small, torch.ones_like(th), th)
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(ths)) / (ths * ths))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (ths - torch.sin(ths)) / (ths ** 3))
    K = rot.skew(x)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    return eye - b[..., None, None] * K + c[..., None, None] * (K @ K)


def transform_reconstruction(recon, s: float, R: np.ndarray,
                             t: np.ndarray):
    """Apply dst = s R src + t to all cameras and points in place (host
    float64; the rotations through math/rotation.py on the CPU).
    ref: TransformReconstruction."""
    R = np.asarray(R)
    for v in recon.views.values():
        if not v.is_estimated:
            continue
        c = v.camera.extrinsics[:3]
        aa = torch.as_tensor(np.asarray(v.camera.extrinsics[3:6],
                                        np.float64))
        v.camera.extrinsics[:3] = s * R @ c + t
        R_cam = rot.angle_axis_to_rotation_matrix(aa).numpy()
        R_new = torch.as_tensor(R_cam @ R.T)
        v.camera.extrinsics[3:6] = rot.rotation_matrix_to_angle_axis(
            R_new).numpy()
    for tr in recon.tracks.values():
        if tr.is_estimated:
            xyz = tr.xyz()
            tr.point = np.append(s * R @ xyz + t, 1.0)
