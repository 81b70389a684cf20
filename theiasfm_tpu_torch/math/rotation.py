"""Rotation algebra: angle-axis <-> matrix <-> quaternion, batched and
autodiff-safe (port of theiasfm_tpu/math/rotation.py).

Extrinsics use a world->camera rotation stored as a 3-vector
angle-axis. Every function broadcasts over leading batch dims, has no
data-dependent Python control flow (so it runs under torch.func.vmap
and jacrev), and is safe at the theta -> 0 limit (Taylor branches
selected with torch.where, both branches guarded).
"""
from __future__ import annotations

import torch

from ..utils import linalg

_EPS = 1e-12


def _theta(aa):
    """Rotation angle with a grad-safe sqrt at zero."""
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    return torch.sqrt(torch.clamp(sq, min=_EPS))


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [zero, -z, y, z, zero, -x, -y, x, zero], dim=-1
    ).reshape(v.shape[:-1] + (3, 3))


def angle_axis_to_rotation_matrix(aa):
    """angle-axis (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta = _theta(aa)[..., 0]
    small = theta < 1e-6
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    axis = aa / safe_theta[..., None]
    c = torch.cos(theta)
    s = torch.sin(theta)
    one_c = 1.0 - c
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    R = torch.stack(
        [
            c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s,
            y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s,
            z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c,
        ],
        dim=-1,
    ).reshape(aa.shape[:-1] + (3, 3))
    # small angle: R ~ I + skew(aa) (first-order Rodrigues)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(R.shape)
    R_small = eye + skew(aa)
    return torch.where(small[..., None, None], R_small, R)


def angle_axis_rotate_point(aa, pt):
    """Rotate points (..., 3) by angle-axis (..., 3) without forming R
    (Ceres AngleAxisRotatePoint semantics)."""
    theta = _theta(aa)[..., 0]
    small = theta < 1e-6
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    axis = aa / safe_theta[..., None]
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    axis_cross_pt = torch.linalg.cross(axis, pt, dim=-1)
    axis_dot_pt = torch.sum(axis * pt, dim=-1, keepdim=True)
    rotated = pt * c + axis_cross_pt * s + axis * axis_dot_pt * (1.0 - c)
    # small angle: p + aa x p
    rotated_small = pt + torch.linalg.cross(aa, pt, dim=-1)
    return torch.where(small[..., None], rotated_small, rotated)


def angle_axis_rotate_point_jacobian(aa, pt):
    """`angle_axis_rotate_point` and its jacobian in closed form:
    (rotated (..., 3), d rotated / d aa (..., 3, 3)).

    d(R v)/d aa = -R [v]x J_r(aa) with the right jacobian of SO(3),
    J_r = I - (1 - cos t)/t^2 [aa]x + (t - sin t)/t^3 [aa]x^2; below the
    small-angle threshold the first-order branch p + aa x p has the
    jacobian -[p]x. The same numbers as autodiff through
    `angle_axis_rotate_point`, without it."""
    aa, pt = torch.broadcast_tensors(aa, pt)
    theta = _theta(aa)[..., 0]
    small = theta < 1e-6
    t = torch.where(small, torch.ones_like(theta), theta)
    a = ((1.0 - torch.cos(t)) / (t * t))[..., None, None]
    b = ((t - torch.sin(t)) / (t * t * t))[..., None, None]
    W = skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    Jr = eye - a * W + b * (W @ W)
    R = angle_axis_to_rotation_matrix(aa)
    P = skew(pt)
    J = torch.where(small[..., None, None], -P, -(R @ P) @ Jr)
    return angle_axis_rotate_point(aa, pt), J


def rotation_matrix_to_quaternion(R):
    """(..., 3, 3) -> unit quaternion (..., 4) [w, x, y, z], w >= 0.

    Branch-free Shepperd method: all four candidate quaternions are
    formed and the best-conditioned one (largest pivot) is selected.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(p, a, b, c, d):
        s = torch.sqrt(torch.clamp(p, min=_EPS)) * 2.0
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1)

    q_w = cand(1.0 + tr, 1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    q_x = cand(1.0 + m00 - m11 - m22, m21 - m12, 1.0 + m00 - m11 - m22,
               m01 + m10, m02 + m20)
    q_y = cand(1.0 - m00 + m11 - m22, m02 - m20, m01 + m10,
               1.0 - m00 + m11 - m22, m12 + m21)
    q_z = cand(1.0 - m00 - m11 + m22, m10 - m01, m02 + m20, m12 + m21,
               1.0 - m00 - m11 + m22)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # (..., 4cand, 4)
    q = torch.gather(
        cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_to_angle_axis(q):
    """Unit quaternion (..., 4) [w, x, y, z] -> angle-axis (..., 3)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=_EPS))
    theta = 2.0 * torch.atan2(sin_half, w)
    small = sin_half < 1e-7
    scale = torch.where(small, torch.full_like(theta, 2.0),
                        theta / torch.where(small, torch.ones_like(sin_half),
                                            sin_half))
    return v * scale[..., None]


def rotation_matrix_to_angle_axis(R):
    """rotation matrix (..., 3, 3) -> angle-axis (..., 3), via the
    quaternion for stability near theta = 0 and theta = pi."""
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))


def quaternion_to_rotation_matrix(q):
    """Unit quaternion (..., 4) [w, x, y, z] -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    ).reshape(q.shape[:-1] + (3, 3))


def angle_axis_to_quaternion(aa):
    theta = _theta(aa)[..., 0]
    half = 0.5 * theta
    small = theta < 1e-6
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    k = torch.where(small, torch.full_like(theta, 0.5),
                    torch.sin(half) / safe_theta)
    w = torch.cos(half)
    return torch.cat([w[..., None], aa * k[..., None]], dim=-1)


def quaternion_multiply(q1, q2):
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v1, v2 = torch.broadcast_tensors(v1, v2)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([w.expand(v.shape[:-1] + (1,)), v], dim=-1)


def multiply_rotations(aa1, aa2):
    """Compose angle-axis rotations: result = R(aa1) @ R(aa2), in aa form."""
    q1 = angle_axis_to_quaternion(aa1)
    q2 = angle_axis_to_quaternion(aa2)
    return quaternion_to_angle_axis(quaternion_multiply(q1, q2))


def relative_rotation(aa_1, aa_2):
    """Angle-axis of R_2 @ R_1^T (rotation from frame 1 to frame 2)."""
    R1 = angle_axis_to_rotation_matrix(aa_1)
    R2 = angle_axis_to_rotation_matrix(aa_2)
    return rotation_matrix_to_angle_axis(R2 @ R1.transpose(-1, -2))


def rotation_angle_deg(aa):
    return torch.rad2deg(_theta(aa)[..., 0])


def rotation_error_deg(aa_a, aa_b):
    """Angular distance in degrees between two angle-axis rotations."""
    Ra = angle_axis_to_rotation_matrix(aa_a)
    Rb = angle_axis_to_rotation_matrix(aa_b)
    rel = Ra @ Rb.transpose(-1, -2)
    tr = torch.diagonal(rel, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def project_to_rotation_matrix(M):
    """Nearest rotation matrix to (..., 3, 3) M via SVD (det +1
    enforced)."""
    U, _, Vt = linalg.svd(M)
    D = torch.ones(M.shape[:-2] + (3,), dtype=M.dtype, device=M.device)
    D[..., 2] = linalg.det3(U @ Vt)
    return (U * D[..., None, :]) @ Vt
