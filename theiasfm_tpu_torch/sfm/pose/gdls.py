"""gDLS: generalized pose-and-scale, the similarity transform from rays
(port of theiasfm_tpu/sfm/pose/gdls.py).

ref: src/theia/sfm/transformation/gdls_similarity_transform.{h,cc} —
"gDLS: A Scalable Solution to the Generalized Pose and Scale Problem"
(Sweeney et al., ECCV 2014). Given image rays (origin + direction) in
one frame and corresponding 3D points in another, find (R, t, s) such
that depth_i * d_i + s * o_i ~= R X_i + t
(gdls_similarity_transform.h:44-60), by minimizing the depth-eliminated
object-space cost

    J(R, t, s) = sum_i || (I - d_i d_i^T) (R X_i + t - s o_i) ||^2 .

As in the JAX module, (t, s) is eliminated analytically (it is linear
given R) and R found by upnp's lockstep multistart on unit quaternions;
t and s are linear in vec(R), so every residual is affine in vec(R)
(the form `multistart_refine_quat` takes).
"""
from __future__ import annotations

import torch

from ...math import rotation as rot
from ...utils import linalg
from .upnp import (_kron_rows, _projectors, multistart_refine_quat,
                   so3_covering_quats)

__all__ = ["gdls_similarity_transform", "gdls_cost_matrix"]


def gdls_cost_matrix(ray_origins, ray_dirs, world_points):
    """Eliminate depths, translation, and scale from the gDLS cost.

    Returns (ts_of_R, cost_of_R, B, Q): given R, ``ts_of_R(R) -> (t, s)``
    is the exact least-squares optimum of the linear subproblem, and
    ``cost_of_R(R) -> (cost, t, s)`` the resulting cost; B (..., n, 3,
    10) and Q (..., n, 3, 3) give each residual affine in vec(R).
    """
    o, d, p = ray_origins, ray_dirs, world_points
    Q = _projectors(d)                                  # (.., n, 3, 3)
    # Normal equations for z = [t; s] (4 unknowns), residual
    # r_i = Q_i (R p_i + t - s o_i):
    #   [ sum Q_i        -sum Q_i o_i      ] [t]   [-sum Q_i R p_i      ]
    #   [ -sum o_i^T Q_i  sum o_i^T Q_i o_i] [s] = [ sum o_i^T Q_i R p_i]
    Qsum = Q.sum(dim=-3)
    Qo_i = (Q @ o[..., None])[..., 0]                   # (.., n, 3)
    Qo = Qo_i.sum(dim=-2)
    oQo = torch.sum(o * Qo_i, dim=(-2, -1))
    A = torch.cat([torch.cat([Qsum, -Qo[..., :, None]], -1),
                   torch.cat([-Qo, oQo[..., None]], -1)[..., None, :]],
                  dim=-2)
    A = A + 1e-12 * torch.eye(4, dtype=p.dtype, device=p.device)

    def ts_of_R(R):
        y = p @ R.transpose(-1, -2)                     # R p_i
        Qy_i = (Q @ y[..., None])[..., 0]
        b = torch.cat([-Qy_i.sum(-2), torch.sum(o * Qy_i, dim=(-2, -1))[
            ..., None]], dim=-1)
        z = linalg.solve(A, b[..., None])[..., 0]
        return z[..., :3], z[..., 3]

    def cost_of_R(R):
        t, s = ts_of_R(R)
        r = p @ R.transpose(-1, -2) + t[..., None, :] - \
            s[..., None, None] * o
        Qr = (Q @ r[..., None])[..., 0]
        return torch.sum(Qr * r, dim=(-2, -1)), t, s

    # b = Bb vec(R), z = A^-1 Bb vec(R): r_i = (P_i + Zt - o_i zs) vec(R)
    P = _kron_rows(p)                                   # (.., n, 3, 9)
    QP = Q @ P
    Bb = torch.cat([-QP.sum(dim=-3),
                    (o[..., None, :] @ QP).sum(dim=-3)], dim=-2)  # (.., 4, 9)
    Z = linalg.solve(A, Bb)
    lin = P + Z[..., None, :3, :] - o[..., :, None] * Z[..., None, 3:4, :]
    B = torch.cat([lin, torch.zeros_like(lin[..., :1])], dim=-1)
    return ts_of_R, cost_of_R, B, Q


def gdls_similarity_transform(ray_origins, ray_dirs, world_points,
                              gn_iters: int = 12):
    """Generalized pose-and-scale: similarity aligning 3D points onto
    multi-camera image rays.

    ray_origins (..., n, 3): camera centers (un-scaled, in the query
    frame); ray_dirs (..., n, 3): unit ray directions; world_points
    (..., n, 3). Solves depth_i d_i + s o_i ~= R X_i + t in least
    squares (ref: gdls_similarity_transform.h:44-75). n >= 4.

    Returns (R (..., 3, 3), t (..., 3), s (...), cost (...)).
    """
    _, cost_of_R, B, Q = gdls_cost_matrix(ray_origins, ray_dirs,
                                          world_points)
    qb = multistart_refine_quat(B, Q, torch.as_tensor(so3_covering_quats()),
                                gn_iters)
    R = rot.quaternion_to_rotation_matrix(qb)
    cost, t, s = cost_of_R(R)
    return R, t, s, cost
