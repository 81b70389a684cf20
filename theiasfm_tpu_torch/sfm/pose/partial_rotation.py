"""Partial-rotation (gravity-aware) minimal pose solvers (port of
theiasfm_tpu/sfm/pose/partial_rotation.py).

The reference's "known vertical / known axis" solver family (Sweeney et
al., ISMAR 2015 & CVPR 2015):

- ``two_point_pose_partial_rotation``
  ref: src/theia/sfm/pose/two_point_pose_partial_rotation.{h,cc}
- ``three_point_relative_pose_partial_rotation``
  ref: src/theia/sfm/pose/three_point_relative_pose_partial_rotation.{h,cc}
- ``four_point_relative_pose_partial_rotation`` (generalized cameras)
  ref: src/theia/sfm/pose/four_point_relative_pose_partial_rotation.{h,cc}
- ``sim_transform_partial_rotation`` (similarity, generalized cameras)
  ref: src/theia/sfm/pose/sim_transform_partial_rotation.{h,cc}

All share one structure: the rotation about the known unit axis ``v``
is parameterized by the unnormalized-quaternion scalar ``s``,

    R(s) ~ s^2 I + 2 s [v]x + (2 v v^T - I)        (up to scale),

which turns each (generalized) epipolar constraint row into a quadratic
in ``s`` — a quadratic eigenvalue problem (s^2 M + s C + K) x = 0. As
in the JAX module it is solved without a nonsymmetric eigensolver: the
linearization A = [[-M^-1 C, -M^-1 K], [I, 0]], its characteristic
polynomial by Faddeev-LeVerrier (math/polynomial.char_poly), all roots
at once by the batched Aberth iteration, and each eigenvector as the
smallest eigenvector of Q(s)^T Q(s) from `eigh`. Every solver is
batched over leading dims and returns fixed-size solution sets with a
validity mask (invalid slots are garbage — mask them).
"""
from __future__ import annotations

import torch

from ...math import polynomial as poly
from ...math import rotation as rot
from ...utils import linalg

__all__ = [
    "two_point_pose_partial_rotation",
    "three_point_relative_pose_partial_rotation",
    "four_point_relative_pose_partial_rotation",
    "sim_transform_partial_rotation",
]


def _unit_axis(axis):
    """The math assumes |axis| = 1 (the reference CHECKs this,
    e.g. two_point_pose_partial_rotation.cc:179); normalizing here is
    the branchless equivalent."""
    return axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=1e-30)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _rot_about_axis_from_s(axis, s):
    """R from the unnormalized quaternion (s, axis): axis (..., 3) unit,
    s (..., k) -> (..., k, 3, 3)."""
    ax = axis[..., None, :].expand(s.shape + (3,))
    return rot.quaternion_to_rotation_matrix(
        torch.cat([s[..., None], ax], dim=-1))  # normalizes internally


def _solve_qep(M, C, K, root_iters: int = 100):
    """Solve (s^2 M + s C + K) x = 0 for (..., n, n) QEPs.

    Returns (s (..., 2n), x (..., 2n, n) unit rows, real_mask (..., 2n),
    m_ok (...)). ``m_ok`` is False when M is numerically singular (the
    zero-rotation degenerate case in the reference, which falls back to
    null(M)).
    """
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    detM = torch.linalg.det(M)
    scale = torch.clamp(M.abs().amax(dim=(-2, -1)), min=1e-30)
    m_ok = detM.abs() > 1e-12 * scale ** n
    M_safe = torch.where(m_ok[..., None, None], M, eye)
    Minv = linalg.inv(M_safe)
    A = torch.cat([torch.cat([-Minv @ C, -Minv @ K], dim=-1),
                   torch.cat([eye.expand(M.shape), torch.zeros_like(M)],
                             dim=-1)], dim=-2)
    roots = poly.poly_roots(poly.char_poly(A), iters=root_iters)
    real_mask = poly.real_roots_mask(roots, rel_tol=1e-4, abs_tol=1e-7)
    s = roots.real                                       # (..., 2n)
    si = s[..., None, None]
    Q = si * si * M[..., None, :, :] + si * C[..., None, :, :] + \
        K[..., None, :, :]
    _, vecs = linalg.eigh(Q.transpose(-1, -2) @ Q)
    return s, vecs[..., :, 0], real_mask, m_ok


def two_point_pose_partial_rotation(axis, model_points, image_rays):
    """Absolute pose with known rotation axis from 2 3D-point/ray pairs.

    Solves image_point = R(angle about `axis`) * model_point + t.
    axis (..., 3); model_points (..., 2, 3); image_rays (..., 2, 3) unit
    norm. Returns (R (..., 2, 3, 3), t (..., 2, 3), valid (..., 2)) — at
    most 2 solutions.

    ref: src/theia/sfm/pose/two_point_pose_partial_rotation.cc:90-151
    (ray-length quadratic), :54-89 (angle recovery in the axis-orthogonal
    plane). The reference swaps the points when ray1 is orthogonal to the
    axis (divide-by-zero guard); here the better-conditioned ordering is
    always picked, branchlessly.
    """
    axis = _unit_axis(axis)
    mp, ir = model_points, image_rays
    # ordering so |ray_a . axis| is maximal (conditioning)
    dots = _dot(ir, axis[..., None, :]).abs()
    swap = (dots[..., 0] < dots[..., 1])[..., None, None]
    mp = torch.where(swap, mp.flip(-2), mp)
    ir = torch.where(swap, ir.flip(-2), ir)

    r1, r2 = ir[..., 0, :], ir[..., 1, :]
    p1, p2 = mp[..., 0, :], mp[..., 1, :]
    r1_ax = _dot(r1, axis)
    feasible = r1_ax.abs() > 1e-9
    safe = torch.where(feasible, r1_ax, torch.ones_like(r1_ax))
    # projections along the axis are rotation-invariant:
    #   y*(r1.axis) - x*(r2.axis) = (p1 - p2).axis  =>  x = m + n*y
    m = _dot(p1 - p2, axis) / safe
    n_ = _dot(r2, axis) / safe
    # rigid distance preservation |y r1 - x r2| = |p1 - p2| gives a
    # quadratic in the length of image_ray_2 (the reference's roots);
    # m + n*root is the length of image_ray_1
    rdp = _dot(r1, r2)
    a = n_ * (n_ - 2.0 * rdp) + 1.0
    b = 2.0 * m * (n_ - rdp)
    c = m * m - _dot(p1 - p2, p1 - p2)
    roots = poly.solve_quadratic(a, b, c)                # (..., 2)
    real = roots.imag.abs() <= 1e-9 * (1.0 + roots.real.abs())
    len2 = roots.real
    len1 = m[..., None] + n_[..., None] * len2
    valid = real & (len1 > 0) & (len2 > 0) & feasible[..., None]

    q1 = len1[..., None] * r1[..., None, :]              # (..., 2, 3)
    q2 = len2[..., None] * r2[..., None, :]
    dq = q1 - q2
    dp = p1 - p2
    # angle about the axis aligning the in-plane component of dp to dq
    b2 = _cross(axis, dp)
    b2 = b2 / torch.clamp(torch.linalg.norm(b2, dim=-1, keepdim=True),
                          min=1e-30)
    b1 = _cross(b2, axis)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True),
                          min=1e-30)
    angle = torch.atan2(_dot(b2[..., None, :], dq),
                        _dot(b1[..., None, :], dq))
    R = rot.angle_axis_to_rotation_matrix(angle[..., None] *
                                          axis[..., None, :])
    t = q1 - (R @ p1[..., None, :, None])[..., 0]
    return R, t, valid


def three_point_relative_pose_partial_rotation(axis, rays1, rays2):
    """Relative pose (R about `axis`, unit t) from 3 ray correspondences
    with ray2 ~ R * ray1 + t (epipolar sense).

    axis (..., 3); rays1/rays2 (..., 3, 3). Returns (R (..., 14, 3, 3),
    t (..., 14, 3) unit, valid (..., 14)): 6 QEP roots x (+-t), plus 2
    zero-rotation fallback slots used when the QEP is degenerate.

    ref: src/theia/sfm/pose/three_point_relative_pose_partial_rotation.cc:146-259.
    """
    axis = _unit_axis(axis)
    q1, q2 = rays1, rays2
    ax = axis[..., None, :]
    # constraint rows: t . (q2 x R(s) q1) = 0 with the quadratic R(s)
    M = _cross(q2, q1)                                   # s^2 terms
    C = 2.0 * _cross(q2, _cross(ax, q1))
    K = 2.0 * _dot(q1, ax)[..., None] * _cross(q2, ax) - _cross(q2, q1)

    s, x, real_mask, m_ok = _solve_qep(M, C, K)
    R = _rot_about_axis_from_s(axis, s)                  # (..., 6, 3, 3)
    t = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                        min=1e-30)
    qep_valid = real_mask & m_ok[..., None]

    # zero-rotation fallback: null vector of M (both signs)
    _, vecs = linalg.eigh(M.transpose(-1, -2) @ M)
    t0 = vecs[..., :, 0]
    eyeR = torch.eye(3, dtype=R.dtype, device=R.device).expand(
        R.shape[:-3] + (2, 3, 3))
    R_all = torch.cat([R, R, eyeR], dim=-3)              # (..., 14, 3, 3)
    t_all = torch.cat([t, -t, torch.stack([t0, -t0], dim=-2)], dim=-2)
    fb = (~m_ok)[..., None].expand(m_ok.shape + (2,))
    valid = torch.cat([qep_valid, qep_valid, fb], dim=-1)
    return R_all, t_all, valid


def _plucker_qep(axis, dirs1, origins1, dirs2, origins2):
    """Rows of the generalized epipolar constraint as quadratics in s.

    Rays are (origin, direction) in each camera frame; moments
    p = origin x direction (Plucker). Returns per-row coefficient
    matrices (M, C, K) each (..., n, 4):
    [-(q2 x R q1), q2 . R p1 + q1 . R^T p2] expanded in s.
    """
    q1, q2 = dirs1, dirs2
    p1 = _cross(origins1, dirs1)
    p2 = _cross(origins2, dirs2)
    ax = axis[..., None, :].expand(q1.shape)

    M3 = -_cross(q2, q1)
    M4 = _dot(q2, p1) + _dot(q1, p2)
    C3 = -2.0 * _cross(q2, _cross(ax, q1))
    C4 = -2.0 * (_dot(q1, _cross(ax, p2)) - _dot(q2, _cross(ax, p1)))
    K3 = -(2.0 * _dot(q1, ax)[..., None] * _cross(q2, ax) - _cross(q2, q1))
    K4 = (-_dot(q2, p1) - _dot(q1, p2)
          + 2.0 * (_dot(q2, ax) * _dot(p1, ax) + _dot(q1, ax) * _dot(p2, ax)))
    M = torch.cat([M3, M4[..., None]], dim=-1)
    C = torch.cat([C3, C4[..., None]], dim=-1)
    K = torch.cat([K3, K4[..., None]], dim=-1)
    return M, C, K


def four_point_relative_pose_partial_rotation(
        axis, dirs1, origins1, dirs2, origins2):
    """Relative pose (R about `axis`, metric t) between two generalized
    cameras from 4 ray correspondences (directions + origins per frame,
    each (..., 4, 3)).

    Returns (R (..., 8, 3, 3), t (..., 8, 3), valid (..., 8)).

    ref: src/theia/sfm/pose/four_point_relative_pose_partial_rotation.cc:144-259
    (generalized epipolar constraint in Plucker coordinates; metric
    translation from the homogeneous QEP eigenvector).
    """
    axis = _unit_axis(axis)
    M, C, K = _plucker_qep(axis, dirs1, origins1, dirs2, origins2)
    s, x, real_mask, m_ok = _solve_qep(M, C, K)
    R = _rot_about_axis_from_s(axis, s)
    w = x[..., 3]
    w_ok = w.abs() > 1e-7
    t = x[..., :3] / torch.where(w_ok, w, torch.ones_like(w))[..., None]
    return R, t, real_mask & m_ok[..., None] & w_ok


def sim_transform_partial_rotation(axis, dirs1, origins1, dirs2, origins2):
    """Similarity transform (R about `axis`, t, scale) between two
    generalized cameras from 5 ray correspondences (each (..., 5, 3)),
    such that rays of camera two, mapped by X = scale * R * X2 + t,
    intersect the corresponding rays of camera one.

    Returns (R (..., 12, 3, 3), t (..., 12, 3), scale (..., 12), valid
    (..., 12)): 10 QEP slots + 2 zero-rotation fallback slots.

    ref: src/theia/sfm/pose/sim_transform_partial_rotation.cc:139-283
    (scale enters as an extra homogeneous column; solutions with
    non-positive scale are rejected).
    """
    axis = _unit_axis(axis)
    f1, f2, o1, o2 = dirs1, dirs2, origins1, origins2
    eye = torch.eye(3, dtype=f1.dtype, device=f1.device)
    rot_s2 = eye.expand(axis.shape[:-1] + (3, 3))
    rot_s1 = 2.0 * rot.skew(axis)
    rot_c = 2.0 * axis[..., :, None] * axis[..., None, :] - eye

    def rows(Rpart):
        Rt = Rpart.transpose(-1, -2)
        Rf2 = f2 @ Rt                                    # (..., n, 3)
        c3 = _cross(f1, Rf2)
        c4 = -_dot(f1, _cross(o2, f2) @ Rt)
        c5 = -_dot(_cross(o1, f1), Rf2)
        return torch.cat([c3, c4[..., None], c5[..., None]], dim=-1)

    M, C, K = rows(rot_s2), rows(rot_s1), rows(rot_c)
    s, x, real_mask, m_ok = _solve_qep(M, C, K)
    R = _rot_about_axis_from_s(axis, s)                  # (..., 10, 3, 3)
    w = x[..., 4]
    w_ok = w.abs() > 1e-12
    wsafe = torch.where(w_ok, w, torch.ones_like(w))
    t = x[..., :3] / wsafe[..., None]
    scale = x[..., 3] / wsafe
    valid = real_mask & m_ok[..., None] & w_ok & (scale > 0)

    # zero-rotation fallback: null vector of M
    _, vecs = linalg.eigh(M.transpose(-1, -2) @ M)
    k = vecs[..., :, 0]
    kw_ok = k[..., 4].abs() > 1e-12
    ksafe = torch.where(kw_ok, k[..., 4], torch.ones_like(k[..., 4]))
    t0 = k[..., :3] / ksafe[..., None]
    s0 = k[..., 3] / ksafe
    fb_valid = torch.stack([~m_ok & kw_ok & (s0 > 0),
                            torch.zeros_like(m_ok)], dim=-1)
    R_all = torch.cat([R, eye.expand(R.shape[:-3] + (2, 3, 3))], dim=-3)
    t_all = torch.cat([t, torch.stack([t0, t0], dim=-2)], dim=-2)
    s_all = torch.cat([scale, torch.stack([s0, s0], dim=-1)], dim=-1)
    return R_all, t_all, s_all, torch.cat([valid, fb_valid], dim=-1)
