"""Global rotation averaging: MST init + robust L1/IRLS refinement (port
of theiasfm_tpu/sfm/global_pose/rotation_averaging.py).

ref: src/theia/sfm/global_pose_estimation/robust_rotation_estimator.{h,cc}
(Chatterjee-Govindu L1-IRLS: an ADMM L1 stage then IRLS with a robust
kernel over a sparse Cholesky solve) and
src/theia/sfm/view_graph/orientations_from_maximum_spanning_tree.{h,cc}.

The sparse linear system is never formed. Each outer iteration computes
per-edge so(3) discrepancies r_e = log(R_j^T R_ij R_i) in one batched
op, then solves the weighted normal equations (A^T W A) x = A^T W r
matrix-free with Jacobi-preconditioned CG, where A has +I/-I blocks per
edge: the matvec is two gathers and two segment sums (index_add_). The
L1 stage is IRLS with w = 1/max(||r||, eps), followed by IRLS with the
Geman-McClure-style weights the reference uses.

Where JAX runs the whole schedule as one jitted fori_loop, this runs it
as eager loops on `device` (the card unless the caller passes "cpu") in
`dtype` (float32 by default) with no host sync inside: 5 L1 + 10 IRLS
steps of 50 CG iterations each. index_add_ sums with atomics on CUDA,
so the card's bits may change from run to run. With `axis_name` the
edges are sharded over a mesh axis (parallel/edge_sharded.py) and every
edge-to-view reduction is all-reduced over it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...math import rotation as rot
from ...math.graph import minimum_spanning_tree
from ...utils import collectives
from ...utils.device import full_f32, resolve_device


@dataclasses.dataclass(frozen=True)
class RobustRotationOptions:
    """ref: robust_rotation_estimator.h Options."""
    l1_iterations: int = 5
    irls_iterations: int = 10
    cg_iterations: int = 50
    sigma_degrees: float = 5.0  # IRLS kernel width


def _host_rotations(aa) -> np.ndarray:
    """(..., 3) angle-axis -> (..., 3, 3) rotation matrices, float64 on
    the host."""
    return rot.angle_axis_to_rotation_matrix(torch.from_numpy(
        np.asarray(aa, np.float64))).numpy()


def _host_angle_axis(R) -> np.ndarray:
    return rot.rotation_matrix_to_angle_axis(torch.from_numpy(
        np.asarray(R, np.float64))).numpy()


def orientations_from_mst(num_views: int, edges: np.ndarray,
                          rel_rotations: np.ndarray,
                          weights: np.ndarray,
                          root: int = 0) -> np.ndarray:
    """Initialize global orientations by chaining relative rotations over
    the maximum-weight spanning tree (ref
    orientations_from_maximum_spanning_tree.cc). edges (E, 2) [i, j] with
    R_j = R_ij R_i; rel_rotations (E, 3) angle-axis; weights (E,) higher
    = better. Returns (num_views, 3) angle-axis world->camera. Host
    only, in float64."""
    mst = minimum_spanning_tree(num_views, edges, -np.asarray(weights))
    adj = {}
    for e in mst:
        i, j = int(edges[e, 0]), int(edges[e, 1])
        adj.setdefault(i, []).append((j, e, False))
        adj.setdefault(j, []).append((i, e, True))
    R_rel = _host_rotations(rel_rotations)
    R = np.zeros((num_views, 3, 3))
    R[root] = np.eye(3)
    visited = {root}
    stack = [root]
    while stack:
        i = stack.pop()
        for (j, e, reverse) in adj.get(i, ()):
            if j in visited:
                continue
            visited.add(j)
            if reverse:
                R[j] = R_rel[e].T @ R[i]
            else:
                R[j] = R_rel[e] @ R[i]
            stack.append(j)
    return _host_angle_axis(R)


def _segment_sum(u, index, num_segments):
    """jax.ops.segment_sum over the leading axis."""
    out = u.new_zeros((num_segments,) + tuple(u.shape[1:]))
    return out.index_add_(0, index, u)


def _cg(matvec, b, M_inv, iters, x0=None):
    """Jacobi-preconditioned CG from x0 (default 0), a fixed number of
    iterations and no host sync (JAX's fori_loop body)."""
    if x0 is None:
        x, res = torch.zeros_like(b), b
    else:
        x, res = x0, b - matvec(x0)
    p = res * M_inv
    rz = torch.sum(res * p)
    tiny = torch.full((), 1e-30, dtype=b.dtype, device=b.device)
    for _ in range(iters):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-30, tiny, pAp)
        x = x + alpha * p
        res = res - alpha * Ap
        z = res * M_inv
        rz_new = torch.sum(res * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-30, tiny, rz)
        p = z + beta * p
        rz = rz_new
    return x


def _rotation_averaging_device(orient_aa, edge_i, edge_j, rel_aa,
                               edge_mask, opts: RobustRotationOptions,
                               num_views: int, axis_name=None):
    """The full L1 -> IRLS schedule on the tensors' device.

    axis_name: the edges are this rank's shard of a mesh axis (the
    orientation state is replicated) and every edge->view reduction is
    all-reduced over it, so a CG iteration moves O(V * 3) values whatever
    the edge count."""
    _psum = collectives.psum_over(axis_name)
    dtype = orient_aa.dtype
    sigma = float(np.radians(opts.sigma_degrees))
    free = (torch.arange(num_views, device=orient_aa.device) != 0)[:, None]
    R_rel = rot.angle_axis_to_rotation_matrix(rel_aa)

    def _reduce(u):
        return _psum(_segment_sum(u, edge_j, num_views) -
                     _segment_sum(u, edge_i, num_views))

    def _reduce_sym(u):
        return _psum(_segment_sum(u, edge_j, num_views) +
                     _segment_sum(u, edge_i, num_views))

    def edge_residuals(aa):
        R = rot.angle_axis_to_rotation_matrix(aa)            # (V, 3, 3)
        E = R[edge_j].transpose(-1, -2) @ R_rel @ R[edge_i]  # R_j^T R_ij R_i
        return rot.rotation_matrix_to_angle_axis(E)          # (E, 3)

    def solve_step(aa, weight_fn):
        r = edge_residuals(aa)
        w = weight_fn(r) * edge_mask
        # solve (A^T W A) x = A^T W r with A x = x_j - x_i, gauge x_0 = 0

        def matvec(x):
            u = (x[edge_j] - x[edge_i]) * w[:, None]
            return _reduce(u) * free

        b = _reduce(r * w[:, None]) * free
        # Jacobi preconditioner: degree * weight sum per view
        M_inv = (1.0 / torch.clamp(_reduce_sym(w), min=1e-10))[:, None]
        x = _cg(matvec, b, M_inv, opts.cg_iterations)
        # update: R_v <- R_v exp(x_v)
        return rot.multiply_rotations(aa, x)

    def l1_weight(r):
        return 1.0 / torch.clamp(torch.linalg.norm(r, dim=-1), min=1e-5)

    def irls_weight(r):
        s2 = torch.sum(r * r, dim=-1)
        return (sigma ** 2 / (s2 + sigma ** 2)) ** 2

    aa = orient_aa.to(dtype)
    for _ in range(opts.l1_iterations):
        aa = solve_step(aa, l1_weight)
    for _ in range(opts.irls_iterations):
        aa = solve_step(aa, irls_weight)
    return aa


@full_f32()
def robust_rotation_averaging(init_orientations: np.ndarray,
                              edges: np.ndarray,
                              rel_rotations: np.ndarray,
                              opts: RobustRotationOptions =
                              RobustRotationOptions(),
                              dtype=torch.float32, device="cuda"):
    """Refine global orientations from pairwise relative rotations.

    init_orientations (V, 3) angle-axis world->camera (e.g. from MST);
    edges (E, 2) int [i, j]; rel_rotations (E, 3) with R_j = R_ij R_i.
    Returns (V, 3) refined angle-axis (float64 numpy).
    """
    dev = resolve_device(device)
    V = init_orientations.shape[0]

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt)

    out = _rotation_averaging_device(
        t(init_orientations), t(edges[:, 0], torch.int64),
        t(edges[:, 1], torch.int64), t(rel_rotations),
        torch.ones(edges.shape[0], dtype=dtype, device=dev), opts, V)
    return out.cpu().numpy().astype(np.float64)
