"""Global position estimation from pairwise relative translations (port
of theiasfm_tpu/sfm/global_pose/position_estimation.py).

ref: src/theia/sfm/global_pose_estimation/
nonlinear_position_estimator.{h,cc} (Ceres LS over
PairwiseTranslationError) and
least_unsquared_deviation_position_estimator.{h,cc} (1DSfM-style LUD
convex program via ConstrainedL1Solver).

Both finish with the same matrix-free IRLS Gauss-Newton on the chordal
pairwise-direction residual
    r_e = t_hat_ij_world - (c_j - c_i) / ||c_j - c_i||
with weights 1 (nonlinear / soft-L1) or 1/||r|| (LUD), solved with
Jacobi-preconditioned CG whose matvec is gathers + segment sums
(index_add_) over edges. Gauge: c_0 = 0 pinned; scale pinned by
renormalizing the mean baseline each iteration. That polish runs on
`device` (the card unless the caller passes "cpu") in `dtype` (float32
by default) as eager loops without a host sync: up to 300 steps of 40
CG iterations, where JAX runs one jitted fori_loop. The LUD's convex
stage (block coordinate descent with a sparse Cholesky per step) and
the spanning-tree start stay on the host in numpy/scipy, as in JAX.
With `axis_name` the polish's edges are sharded over a mesh axis
(parallel/edge_sharded.py) and every edge reduction is all-reduced.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...utils import collectives
from ...utils.device import full_f32, resolve_device
from .rotation_averaging import _cg, _host_rotations, _segment_sum


@dataclasses.dataclass(frozen=True)
class PositionEstimatorOptions:
    """ref: NonlinearPositionEstimator::Options /
    LeastUnsquaredDeviationPositionEstimator::Options."""
    max_iterations: int = 300
    cg_iterations: int = 40
    robust_loss_width: float = 0.1  # huber width on chordal residual
    seed: int = 0


def _direction_jacobian(d, inv_norm):
    """d/dc of -(c_j - c_i)/||c_j - c_i|| wrt c_j is -(I - u u^T)/||.||;
    returns (E, 3, 3) for the c_j block (negate for c_i)."""
    u = d * inv_norm[:, None]
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    return -(eye[None] - u[:, None, :] * u[:, :, None]) * \
        inv_norm[:, None, None]


def _solve_positions(init_pos, edge_i, edge_j, t_world, edge_w,
                     opts: PositionEstimatorOptions, num_views: int,
                     mode: str, axis_name=None):
    """The chordal GN on the tensors' device. axis_name: the edges are
    this rank's shard of a mesh axis (the positions are replicated) and
    every edge->view reduction and edge-sum scalar is all-reduced over
    it (JAX's psums)."""
    _psum = collectives.psum_over(axis_name)
    free = (torch.arange(num_views, device=init_pos.device) != 0)[:, None]
    valid = (edge_w > 0).to(init_pos.dtype)
    n_valid = torch.clamp(_psum(torch.sum(valid)), min=1.0)

    def residuals(c):
        d = c[edge_j] - c[edge_i]
        n = torch.linalg.norm(d, dim=-1)
        inv_n = 1.0 / torch.clamp(n, min=1e-10)
        return t_world - d * inv_n[:, None], d, inv_n

    def reduce(g):
        return _psum(_segment_sum(g, edge_j, num_views) -
                     _segment_sum(g, edge_i, num_views))

    def cost(cc):
        rr, _, _ = residuals(cc)
        rrn = torch.linalg.norm(rr, dim=-1)
        if mode == "lud":
            return _psum(torch.sum(edge_w * rrn))
        a = opts.robust_loss_width
        quad = 0.5 * rrn ** 2
        lin = a * (rrn - 0.5 * a)
        return _psum(torch.sum(edge_w * torch.where(rrn <= a, quad, lin)))

    def gn_step(c):
        r, d, inv_n = residuals(c)
        rn = torch.linalg.norm(r, dim=-1)
        if mode == "lud":
            w = edge_w / torch.clamp(rn, min=1e-4)
        else:
            # huber on the chordal norm
            a = opts.robust_loss_width
            w = edge_w * torch.where(rn <= a, torch.ones_like(rn),
                                     a / torch.clamp(rn, min=1e-10))
        Jj = _direction_jacobian(d, inv_n)     # (E,3,3) block for c_j
        JjT = Jj.transpose(-1, -2)

        def matvec(x):
            u = (Jj @ (x[edge_j] - x[edge_i])[..., None])[..., 0]
            v = (JjT @ (u * w[:, None])[..., None])[..., 0]
            return reduce(v) * free + 1e-9 * x

        g = (JjT @ (r * w[:, None])[..., None])[..., 0]
        b = -reduce(g) * free
        diagJ = torch.sum(Jj * Jj, dim=-2) * w[:, None]
        deg = _psum(_segment_sum(diagJ, edge_j, num_views) +
                    _segment_sum(diagJ, edge_i, num_views))
        M_inv = 1.0 / torch.clamp(deg, min=1e-10)
        x = _cg(matvec, b, M_inv, opts.cg_iterations)
        c_new = c + x
        # step acceptance on the robustified cost
        c = torch.where(cost(c_new) < cost(c), c_new, c)
        # re-pin scale: mean baseline = 1 (scale gauge); weight-masked
        # so padding edges (w = 0) don't skew the mean
        dsum = _psum(torch.sum(
            torch.linalg.norm(c[edge_j] - c[edge_i], dim=-1) * valid))
        return c / torch.clamp(dsum / n_valid, min=1e-10)

    c = init_pos
    for _ in range(opts.max_iterations):
        c = gn_step(c)
    return c


def _random_init(num_views, edges, t_world, seed):
    """Random-ish init: BFS chain along edges with unit steps (the
    reference seeds Ceres with random positions; a spanning-tree walk of
    the directions converges far faster)."""
    pos = np.zeros((num_views, 3))
    visited = {0}
    adj = {}
    for e, (i, j) in enumerate(edges):
        adj.setdefault(int(i), []).append((int(j), e, 1.0))
        adj.setdefault(int(j), []).append((int(i), e, -1.0))
    stack = [0]
    while stack:
        i = stack.pop()
        for (j, e, sgn) in adj.get(i, ()):
            if j in visited:
                continue
            visited.add(j)
            pos[j] = pos[i] + sgn * t_world[e]
            stack.append(j)
    return pos


def _solve_positions_lud_convex(init_pos, edge_i, edge_j, t_world, edge_w,
                                opts: PositionEstimatorOptions,
                                num_views: int):
    """The convex LUD (Ozyesil-Singer, the 1DSfM formulation) on the
    tensors' device:

        min_{c, d}  sum_e w_e || (c_j - c_i) - d_e t_e ||
        s.t. d_e >= 1,  c_0 = 0,

    by block coordinate descent: d_e given c is the baseline's
    projection on t_e, clipped at 1; c given d and the IRLS weights is a
    linear least squares with constant +/-I blocks, solved by
    Jacobi-preconditioned CG warm-started from c. opts.max_iterations
    steps of opts.cg_iterations CG iterations, no host sync. The
    single-device estimators run the host BCD (_lud_bcd_sparse)
    instead, as in JAX."""
    free = (torch.arange(num_views, device=init_pos.device) != 0)[:, None]

    def reduce(u):
        return (_segment_sum(u, edge_j, num_views) -
                _segment_sum(u, edge_i, num_views))

    c = init_pos * free
    for _ in range(opts.max_iterations):
        base = c[edge_j] - c[edge_i]
        d = torch.clamp(torch.sum(base * t_world, dim=-1), min=1.0)
        r = base - d[:, None] * t_world
        rn = torch.linalg.norm(r, dim=-1)
        w = edge_w / torch.clamp(rn, min=1e-3)   # IRLS for the norm sum

        def matvec(x):
            return reduce((x[edge_j] - x[edge_i]) * w[:, None]) * free + \
                1e-9 * x

        b = reduce(d[:, None] * t_world * w[:, None]) * free
        deg = (_segment_sum(w, edge_j, num_views) +
               _segment_sum(w, edge_i, num_views))
        M_inv = (1.0 / torch.clamp(deg, min=1e-10))[:, None]
        c = _cg(matvec, b, M_inv, opts.cg_iterations, x0=c) * free
    return c


def _world_directions(orientations, edges, rel_positions):
    """t_world = R_i^T t_ij per edge, unit norm (host, float64)."""
    R_i = _host_rotations(orientations)[edges[:, 0]]
    t_world = np.einsum("eji,ej->ei", R_i, np.asarray(rel_positions))
    t_world /= np.maximum(np.linalg.norm(t_world, axis=-1,
                                         keepdims=True), 1e-12)
    return t_world


def _device_solve(init, edges, t_world, w, opts, mode, dtype, dev):
    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt)

    out = _solve_positions(t(init), t(edges[:, 0], torch.int64),
                           t(edges[:, 1], torch.int64), t(t_world), t(w),
                           opts, init.shape[0], mode)
    return out.cpu().numpy().astype(np.float64)


@full_f32()
def estimate_positions_nonlinear(orientations, edges, rel_positions,
                                 edge_weights=None,
                                 opts: PositionEstimatorOptions =
                                 PositionEstimatorOptions(),
                                 dtype=torch.float32, device="cuda"):
    """Nonlinear (robust-LS) position estimation.

    orientations (V, 3) angle-axis world->camera; edges (E, 2) [i, j];
    rel_positions (E, 3): position of camera j in camera i's frame
    (TwoViewInfo.position_2, unit norm). Returns (V, 3) positions with
    c_0 = 0 and unit mean baseline.
    """
    dev = resolve_device(device)
    V = orientations.shape[0]
    E = edges.shape[0]
    t_world = _world_directions(orientations, edges, rel_positions)
    w = np.ones(E) if edge_weights is None else np.asarray(edge_weights)
    init = _random_init(V, edges, t_world, opts.seed)
    # warm start from the CONVEX LUD solve — avoids the folded local
    # minima of the chordal objective on loopy graphs
    init = _lud_bcd_sparse(init, np.asarray(edges), t_world, w,
                           iters=40)
    init /= max(np.mean(np.linalg.norm(
        init[edges[:, 1]] - init[edges[:, 0]], axis=-1)), 1e-10)
    return _device_solve(init, edges, t_world, w, opts, "nonlinear",
                         dtype, dev)


def _lud_bcd_sparse(init, edges, t_world, edge_w, iters: int = 60):
    """Host BCD for the convex LUD with a DIRECT sparse factorization
    per IRLS iteration — the reference's SparseCholeskyLLt pattern
    (least_unsquared_deviation_position_estimator.cc). Exact inner
    solves make the outer loop converge in tens of iterations even on
    ring graphs where Jacobi-CG crawls."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    V = init.shape[0]
    ei = edges[:, 0].astype(np.int64)
    ej = edges[:, 1].astype(np.int64)
    c = np.array(init, float)
    c -= c[0]
    rows = np.concatenate([ei, ej, ei, ej])
    cols = np.concatenate([ei, ej, ej, ei])
    # annealed IRLS smoothing: large eps early (avoids weight blowup
    # locking a premature fixed point), tightened geometrically
    eps = 0.1
    for _ in range(iters):
        base = c[ej] - c[ei]
        d = np.maximum(np.sum(base * t_world, axis=-1), 1.0)
        r = base - d[:, None] * t_world
        rn = np.linalg.norm(r, axis=-1)
        w = edge_w / np.maximum(rn, eps)
        eps = max(1e-2, eps * 0.95)
        # weighted graph Laplacian (same scalar pattern per coordinate)
        vals = np.concatenate([w, w, -w, -w])
        L = sp.csc_matrix((vals, (rows, cols)), shape=(V, V))
        target = d[:, None] * t_world * w[:, None]
        b = np.zeros((V, 3))
        np.add.at(b, ej, target)
        np.add.at(b, ei, -target)
        # pin c_0 = 0 (drop row/col 0)
        solve = spla.factorized(L[1:, 1:].tocsc() +
                                1e-12 * sp.eye(V - 1, format="csc"))
        for k in range(3):
            c[1:, k] = solve(b[1:, k])
        c[0] = 0.0
    return c


@full_f32()
def estimate_positions_lud(orientations, edges, rel_positions,
                           edge_weights=None,
                           opts: PositionEstimatorOptions =
                           PositionEstimatorOptions(),
                           dtype=torch.float32, device="cuda"):
    """Least-unsquared-deviations position estimation — the CONVEX
    1DSfM formulation with per-edge scale variables d_e >= 1 (ref
    least_unsquared_deviation_position_estimator.cc). Solved by block
    coordinate descent with direct sparse factorizations (host), then
    polished by the chordal GN on the device."""
    dev = resolve_device(device)
    V = orientations.shape[0]
    E = edges.shape[0]
    t_world = _world_directions(orientations, edges, rel_positions)
    w = np.ones(E) if edge_weights is None else np.asarray(edge_weights)
    init = _random_init(V, edges, t_world, opts.seed)
    c = _lud_bcd_sparse(init, np.asarray(edges), t_world, w,
                        iters=min(opts.max_iterations, 80))
    # final chordal GN polish (the convex solve fixes the basin; the
    # direction-chordal refinement sharpens to sub-percent accuracy)
    c = c / max(np.mean(np.linalg.norm(
        c[edges[:, 1]] - c[edges[:, 0]], axis=-1)), 1e-10)
    return _device_solve(c, edges, t_world, w, opts, "lud", dtype, dev)
