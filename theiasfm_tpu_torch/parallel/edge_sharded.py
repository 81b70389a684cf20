"""Edge-sharded view-graph solvers (port of
theiasfm_tpu/parallel/edge_sharded.py).

Rotation averaging and the chordal position polish are edge-parallel:
every per-edge term reduces into the replicated (V, 3) state through
segment sums. Each rank takes an equal slice of the edges (padded with
zero-weight edges) and all-reduces only the view-sized reductions, so a
CG iteration moves O(V * 3) values whatever the edge count. Every rank
calls with the same global inputs and returns the same result. The
convex LUD start of the positions stays on the host, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sfm.global_pose.position_estimation import (
    PositionEstimatorOptions, _lud_bcd_sparse, _random_init,
    _solve_positions, _world_directions)
from ..sfm.global_pose.rotation_averaging import (
    RobustRotationOptions, _rotation_averaging_device)
from ..utils.device import full_f32
from .mesh import Mesh

__all__ = ["rotation_averaging_sharded", "estimate_positions_sharded"]


def _pad_edges(n_dev, *arrays, pad_vals):
    """Pad each (E, ...) array to a multiple of n_dev; pad_vals[i] is
    the fill value for arrays[i]. Returns (padded arrays, E_pad)."""
    E = arrays[0].shape[0]
    E_pad = -(-E // n_dev) * n_dev
    out = []
    for a, v in zip(arrays, pad_vals):
        a = np.asarray(a)
        padded = np.empty((E_pad,) + a.shape[1:], a.dtype)
        padded[:E] = a
        padded[E:] = v
        out.append(padded)
    return out, E_pad


def _my_edges(mesh, axis_name, arrays, dtypes):
    """This rank's equal slice of each padded edge array, on its
    device."""
    mesh.check_axes(axis_name)
    n = arrays[0].shape[0] // mesh.size
    lo = mesh.rank * n
    return [torch.as_tensor(a[lo:lo + n], device=mesh.device).to(dt)
            for a, dt in zip(arrays, dtypes)]


@full_f32()
def rotation_averaging_sharded(
        init_orientations, edges, rel_rotations, mesh: Mesh,
        opts: RobustRotationOptions = RobustRotationOptions(),
        axis_name="edges", dtype=torch.float32):
    """robust_rotation_averaging with the edges sharded over `mesh`:
    the same arguments and result ((V, 3) angle-axis, float64 numpy).
    Padding edges (0, min(1, V-1)) join real views with weight 0."""
    V = init_orientations.shape[0]
    pj = min(1, V - 1)
    (ei, ej, ra, m), _ = _pad_edges(
        mesh.size, np.asarray(edges[:, 0], np.int64),
        np.asarray(edges[:, 1], np.int64), np.asarray(rel_rotations),
        np.ones(edges.shape[0]), pad_vals=(0, pj, 0.0, 0.0))
    ei, ej, ra, m = _my_edges(mesh, axis_name, (ei, ej, ra, m),
                              (torch.int64, torch.int64, dtype, dtype))
    init = torch.tensor(np.asarray(init_orientations),
                        device=mesh.device).to(dtype)
    with mesh.bind():
        out = _rotation_averaging_device(init, ei, ej, ra, m, opts, V,
                                         axis_name=axis_name)
    return out.cpu().numpy().astype(np.float64)


@full_f32()
def estimate_positions_sharded(
        orientations, edges, rel_positions, mesh: Mesh,
        edge_weights=None,
        opts: PositionEstimatorOptions = PositionEstimatorOptions(),
        axis_name="edges", mode: str = "lud", dtype=torch.float32):
    """estimate_positions_lud (mode "lud") or _nonlinear's polish
    ("nonlinear") with the chordal GN's edges sharded over `mesh`, from
    the host's convex LUD start. Padding edges have weight 0 and stay
    out of the scale gauge. Returns (V, 3) float64 numpy."""
    V = orientations.shape[0]
    E = edges.shape[0]
    t_world = _world_directions(orientations, edges, rel_positions)
    w = np.ones(E) if edge_weights is None else np.asarray(edge_weights)
    init = _random_init(V, edges, t_world, opts.seed)
    c = _lud_bcd_sparse(init, np.asarray(edges), t_world, w,
                        iters=min(opts.max_iterations, 80))
    c = c / max(np.mean(np.linalg.norm(
        c[edges[:, 1]] - c[edges[:, 0]], axis=-1)), 1e-10)

    pj = min(1, V - 1)
    (ei, ej, tw, ww), _ = _pad_edges(
        mesh.size, np.asarray(edges[:, 0], np.int64),
        np.asarray(edges[:, 1], np.int64), t_world, w,
        pad_vals=(0, pj, np.array([1.0, 0.0, 0.0]), 0.0))
    ei, ej, tw, ww = _my_edges(mesh, axis_name, (ei, ej, tw, ww),
                               (torch.int64, torch.int64, dtype, dtype))
    c0 = torch.as_tensor(c, device=mesh.device).to(dtype)
    with mesh.bind():
        out = _solve_positions(c0, ei, ej, tw, ww, opts, V, mode,
                               axis_name=axis_name)
    return out.cpu().numpy().astype(np.float64)
