"""UPnP / DLS-PnP: nonminimal absolute pose for central and
generalized (non-central) cameras (port of
theiasfm_tpu/sfm/pose/upnp.py).

ref: src/theia/sfm/pose/upnp.{h,cc} — "UPnP: An Optimal O(n) Solution
to the Absolute Pose Problem with Universal Applicability" (Kneip et
al., ECCV 2014), cost J(R, t) = sum_i ||depth_i v_i + c_i - R p_i - t||^2
(upnp.h:49-56);
ref: src/theia/sfm/pose/dls_pnp.{h,cc} — "A Direct Least-Squares (DLS)
Method for PnP" (Hesch & Roumeliotis, ICCV 2011), the central-camera
special case of the same object-space cost.

The reference's Groebner-basis template matrices are replaced, as in
the JAX module, by the analytic elimination of depths and translation
and a lockstep multistart damped Newton over unit quaternions from a
fixed SO(3) covering. Eliminating t leaves every residual AFFINE in
vec(R): r_i = B_i [vec(R); 1], and the cost sum_i r_i^T Q_i r_i. That
form gives the gradient and Hessian of the cost in the 3-D tangent
space in closed form (no autodiff), so the multistart runs as one
batched program over (problems x starts x damping ladder).
"""
from __future__ import annotations

import numpy as np
import torch

from ...math import rotation as rot
from ...utils import linalg

__all__ = ["upnp", "dls_pnp", "upnp_cost_matrix", "multistart_refine_quat",
           "so3_covering_quats"]


def _so3_covering_quats():
    """Fixed 24-start covering of SO(3): the chiral-octahedral rotations
    (quaternions on the half-sphere; the vertex and edge families of
    the JAX module dedupe to 24). Deterministic — no RNG."""
    quats = []
    axes = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    for ax in axes:
        for k in range(4):
            angle = k * np.pi / 2.0
            w = np.cos(angle / 2.0)
            s = np.sin(angle / 2.0)
            quats.append((w, s * ax[0], s * ax[1], s * ax[2]))
    for ax in [(1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1),
               (0, 1, 1), (0, 1, -1)]:
        n = np.sqrt(2.0)
        quats.append((0.0, ax[0] / n, ax[1] / n, ax[2] / n))
    for ax in [(1, 1, 1), (1, 1, -1), (1, -1, 1), (-1, 1, 1)]:
        n = np.sqrt(3.0)
        for angle in (2 * np.pi / 3, 4 * np.pi / 3):
            w = np.cos(angle / 2.0)
            s = np.sin(angle / 2.0)
            quats.append((w, s * ax[0] / n, s * ax[1] / n, s * ax[2] / n))
    out = []
    for q in quats:
        q = np.asarray(q, np.float64)
        if q[0] < 0:
            q = -q
        if not any(np.allclose(q, o, atol=1e-9) for o in out):
            out.append(q)
    return np.stack(out)  # (24, 4)


_COVERING = _so3_covering_quats()


def so3_covering_quats():
    """The fixed deterministic SO(3) multistart covering (S, 4)."""
    return _COVERING


def _kron_rows(p):
    """(..., n, 3) points -> (..., n, 3, 9) with (R p)_a = [.] vec(R),
    vec row-major."""
    z = torch.zeros_like(p)
    return torch.stack([torch.cat([p, z, z], -1),
                        torch.cat([z, p, z], -1),
                        torch.cat([z, z, p], -1)], dim=-2)


def _projectors(v):
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye - v[..., :, None] * v[..., None, :]


# the generators [e_k]x and the symmetric second derivatives
# 1/2 ([e_k]x [e_l]x + [e_l]x [e_k]x) of R exp([d]x) at d = 0
def _generators(dtype, device):
    E = rot.skew(torch.eye(3, dtype=dtype, device=device))     # (3, 3, 3)
    EE = E[:, None] @ E[None, :]
    return E, 0.5 * (EE + EE.transpose(0, 1))                  # (3, 3, 3, 3)


def _cost_grad_hess(B, Q, R, with_derivatives=True):
    """Cost sum_i r_i^T Q_i r_i with r_i = B_i [vec R; 1], and its
    gradient (..., 3) and Hessian (..., 3, 3) in the tangent space
    R exp([d]x), d = 0: B (..., n, 3, 10), Q (..., n, 3, 3) and R (...,
    3, 3) with the same leading dims (...)."""
    x = torch.cat([R.flatten(-2), torch.ones_like(R[..., :1, 0])], dim=-1)
    r = (B @ x[..., None, :, None])[..., 0]                    # (.., n, 3)
    Qr = (Q @ r[..., None])[..., 0]
    cost = torch.sum(Qr * r, dim=(-2, -1))
    if not with_derivatives:
        return cost, None, None
    E, EE = _generators(R.dtype, R.device)
    G = (R[..., None, :, :] @ E).flatten(-2)                    # (.., 3, 9)
    B9 = B[..., :9]
    gR = 2.0 * torch.sum(B9.transpose(-1, -2) @ Qr[..., None],
                         dim=-3)[..., 0]                        # (.., 9)
    BG = B9 @ G[..., None, :, :].transpose(-1, -2)              # (.., n, 3, 3)
    H1 = 2.0 * torch.sum(BG.transpose(-1, -2) @ Q @ BG, dim=-3)
    D2 = (R[..., None, None, :, :] @ EE).flatten(-2)            # (.., 3, 3, 9)
    H2 = torch.sum(D2 * gR[..., None, None, :], dim=-1)
    grad = torch.sum(G * gR[..., None, :], dim=-1)
    return cost, grad, H1 + H2


def _apply_delta(q, delta):
    dq = torch.cat([torch.ones_like(delta[..., :1]), 0.5 * delta], dim=-1)
    qn = rot.quaternion_multiply(q, dq)
    return qn / torch.linalg.norm(qn, dim=-1, keepdim=True)


def _finite_or_inf(c):
    return torch.where(torch.isfinite(c), c, torch.full_like(c, np.inf))


def multistart_refine_quat(B, Q, starts, gn_iters: int = 12):
    """Minimize cost(R) = sum_i r_i^T Q_i r_i, r_i = B_i [vec(R); 1]
    (B (..., n, 3, 10), Q (..., n, 3, 3), vec row-major) over SO(3) by
    lockstep multistart damped Newton on unit quaternions — the shared
    engine behind upnp/dls_pnp/gdls. Where the JAX module takes a
    differentiable cost_q, the port takes the affine form every caller's
    cost has, and evaluates the same cost, gradient and Hessian in
    closed form. starts (S, 4). Returns the best quaternion (..., 4)
    over all starts."""
    dtype, dev = B.dtype, B.device
    batch = B.shape[:-3]
    S = starts.shape[0]
    q = starts.to(dtype=dtype, device=dev).expand(batch + (S, 4))
    Bs, Qs = B[..., None, :, :, :], Q[..., None, :, :, :]       # start axis
    Bl, Ql = Bs[..., None, :, :, :], Qs[..., None, :, :, :]     # ladder axis
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    ladder = torch.tensor([0.0, 1e-4, 1e-2, 1e-1, 1.0, 10.0], dtype=dtype,
                          device=dev)
    for _ in range(gn_iters):
        # Riemannian damped Newton on S^3, 3-DoF tangent steps: the cost
        # is nonconvex, so each iteration evaluates a fixed ladder of
        # dampings plus a pure gradient step and keeps the best
        R = rot.quaternion_to_rotation_matrix(q)
        c0, g, H = _cost_grad_hess(Bs, Qs, R)
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1).abs() + 1e-12
        lams = ladder * tr[..., None] + 1e-15                   # (.., S, 6)
        Hl = H[..., None, :, :] + lams[..., None, None] * eye3
        deltas = -linalg.solve(Hl, g[..., None, :, None].expand(
            Hl.shape[:-1] + (1,)))[..., 0]                      # (.., S, 6, 3)
        gstep = -0.3 * g / (torch.linalg.norm(g, dim=-1, keepdim=True) +
                            1e-12)
        deltas = torch.cat([deltas, gstep[..., None, :]], dim=-2)
        qns = _apply_delta(q[..., None, :], deltas)            # (.., S, 7, 4)
        costs, _, _ = _cost_grad_hess(
            Bl, Ql, rot.quaternion_to_rotation_matrix(qns), False)
        costs = _finite_or_inf(costs)
        best = torch.argmin(costs, dim=-1)
        cbest = torch.gather(costs, -1, best[..., None])[..., 0]
        qbest = torch.gather(qns, -2, best[..., None, None].expand(
            best.shape + (1, 4)))[..., 0, :]
        q = torch.where((cbest < c0)[..., None], qbest, q)
    costs, _, _ = _cost_grad_hess(Bs, Qs, rot.quaternion_to_rotation_matrix(q),
                                  False)
    best = torch.argmin(_finite_or_inf(costs), dim=-1)
    return torch.gather(q, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]


def upnp_cost_matrix(ray_origins, ray_dirs, world_points):
    """Eliminate depths and translation from the UPnP cost.

    Returns (t_of_R, cost_of_R, B, Q): given R (..., 3, 3), ``t_of_R(R)``
    is the optimal translation and ``cost_of_R(R)`` -> (cost, t) the
    object-space cost sum_i || (I - v_i v_i^T)(R p_i + t - c_i) ||^2
    (depths solved in closed form: depth_i = v_i . (R p_i + t - c_i),
    matching upnp.h:49-56 with the sign convention R p + t on the ray).
    B (..., n, 3, 10) and Q (..., n, 3, 3) give each residual affine in
    vec(R), the form `multistart_refine_quat` takes.
    """
    c, v, p = ray_origins, ray_dirs, world_points
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    Q = _projectors(v)                                  # (.., n, 3, 3)
    Qsum = Q.sum(dim=-3)
    # Guard: Qsum is rank-deficient only if all rays are parallel.
    Qsum_inv = linalg.inv(Qsum + 1e-12 * eye)
    Qc = (Q @ c[..., None])[..., 0].sum(dim=-2)         # (.., 3)

    def t_of_R(R):
        QRp = (Q @ (p @ R.transpose(-1, -2))[..., None])[..., 0].sum(-2)
        return (Qsum_inv @ (Qc - QRp)[..., None])[..., 0]

    def cost_of_R(R):
        t = t_of_R(R)
        r = p @ R.transpose(-1, -2) + t[..., None, :] - c
        Qr = (Q @ r[..., None])[..., 0]
        return torch.sum(Qr * r, dim=(-2, -1)), t

    # t = t0 - T vec(R); r_i = (P_i - T) vec(R) + (t0 - c_i)
    P = _kron_rows(p)                                   # (.., n, 3, 9)
    T = Qsum_inv @ (Q @ P).sum(dim=-3)                  # (.., 3, 9)
    t0 = (Qsum_inv @ Qc[..., None])[..., 0]
    B = torch.cat([P - T[..., None, :, :],
                   (t0[..., None, :] - c)[..., None]], dim=-1)
    return t_of_R, cost_of_R, B, Q


def upnp(ray_origins, ray_dirs, world_points, gn_iters: int = 12):
    """Universal PnP: absolute pose of a central or generalized camera.

    ray_origins (..., n, 3) camera-frame ray origins (zeros for a
    central camera), ray_dirs (..., n, 3) unit directions, world_points
    (..., n, 3). Solves R p_i + t = c_i + depth_i v_i in least squares.

    Returns (R (..., 3, 3), t (..., 3), cost (...)) — the best solution
    over the SO(3)-covering multistart.
    """
    _, cost_of_R, B, Q = upnp_cost_matrix(ray_origins, ray_dirs,
                                          world_points)
    starts = torch.as_tensor(_COVERING)
    qb = multistart_refine_quat(B, Q, starts, gn_iters)
    R = rot.quaternion_to_rotation_matrix(qb)
    cost, t = cost_of_R(R)
    return R, t, cost


def dls_pnp(feature_positions, world_points, gn_iters: int = 12):
    """DLS-PnP (central camera): pose from n >= 3 2D-3D matches.

    feature_positions (..., n, 2) normalized image coords; world_points
    (..., n, 3). Returns (R, t, cost) minimizing the object-space error —
    the central-camera case of `upnp`
    (ref: src/theia/sfm/pose/dls_pnp.h:45-57).
    """
    f = feature_positions
    rays = torch.cat([f, torch.ones_like(f[..., :1])], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    return upnp(torch.zeros_like(rays), rays, world_points,
                gn_iters=gn_iters)
