"""Maximally parallel rigid subgraph extraction (port of
theiasfm_tpu/sfm/global_pose/rigid_subgraph.py; host numpy, as there).

ref: src/theia/sfm/extract_maximally_parallel_rigid_subgraph.{h,cc} —
before position estimation, keep only the largest subgraph whose
camera positions are well-constrained ("parallel rigid") by the
pairwise translation directions (Ozyesil & Singer, CVPR 2015).

Method (same math as the reference, vectorized): each edge (i, j) with
world-frame translation direction t_ij contributes the constraint
t_ij x (c_j - c_i) = 0. Stack these into A (3E, 3N); the null space of
A^T A describes all position configurations consistent with the
directions. Two nodes are in the same rigid component iff, after
pinning one node's null-space block to zero, their blocks are parallel
(positions then differ only by global scale). The reference finds the
null space with FullPivLU and checks parallelism with doubly-nested
loops; here the normal matrix is accumulated block-sparse, the null
space comes from `eigh`, and the parallelism test is one batched
einsum over all node pairs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .rotation_averaging import _host_rotations

__all__ = ["extract_maximally_parallel_rigid_subgraph",
           "maximal_rigid_component"]

_MAX_COS_DISTANCE = 1e-5
_MAX_NORM = 1e-10


def _cross_matrix(t: np.ndarray) -> np.ndarray:
    """Batched cross-product matrices: (E, 3) -> (E, 3, 3)."""
    z = np.zeros(t.shape[0])
    return np.stack([
        np.stack([z, -t[:, 2], t[:, 1]], axis=-1),
        np.stack([t[:, 2], z, -t[:, 0]], axis=-1),
        np.stack([-t[:, 1], t[:, 0], z], axis=-1),
    ], axis=-2)


def maximal_rigid_component(edges: np.ndarray,
                            directions_world: np.ndarray,
                            num_nodes: int,
                            null_space_tol: float = 1e-9) -> np.ndarray:
    """Indices of the largest parallel-rigid component.

    edges (E, 2) int node indices; directions_world (E, 3) world-frame
    translation directions t_ij (from i toward j, any scale). Returns a
    sorted int array of node indices in the maximal rigid component.
    """
    E = len(edges)
    n = num_nodes
    C = _cross_matrix(np.asarray(directions_world, float))  # (E, 3, 3)
    # Normal matrix M = A^T A accumulated per edge: row block of A is
    # (-C at node i | +C at node j), so M gains C^T C on (i,i) and
    # (j,j) and -C^T C on (i,j), (j,i).
    CtC = np.einsum("eki,ekj->eij", C, C)                  # (E, 3, 3)
    M = np.zeros((3 * n, 3 * n))
    i3 = 3 * edges[:, 0]
    j3 = 3 * edges[:, 1]
    for e in range(E):
        a, b = i3[e], j3[e]
        M[a:a + 3, a:a + 3] += CtC[e]
        M[b:b + 3, b:b + 3] += CtC[e]
        M[a:a + 3, b:b + 3] -= CtC[e]
        M[b:b + 3, a:a + 3] -= CtC[e]

    w, V = np.linalg.eigh(M)
    scale = max(w[-1], 1e-300)
    null_dim = int(np.sum(w < null_space_tol * scale))
    null_dim = max(null_dim, 1)
    null_space = V[:, :null_dim]                           # (3n, k)
    blocks = null_space.reshape(n, 3, -1)                  # (n, 3, k)

    best: np.ndarray = np.zeros(0, int)
    for fixed in range(n):
        mod = blocks - blocks[fixed][None]                 # (n, 3, k)
        norms = np.linalg.norm(mod, axis=-1)               # (n, 3)
        zeroish = (norms < _MAX_NORM).all(axis=-1)         # (n,)
        zeroish[fixed] = True
        rest = np.where(~zeroish)[0]
        members = set(np.where(zeroish)[0].tolist())
        if len(rest) > 1:
            unit = mod[rest] / np.maximum(norms[rest][..., None], 1e-300)
            # cos distance per dimension = 1 - |row_d(i) . row_d(j)|;
            # parallel iff max over the 3 dims < tol (reference
            # ComputeCosineDistance semantics).
            dots = np.abs(np.einsum("idk,jdk->ijd", unit, unit))
            cosd = np.max(1.0 - dots, axis=-1)             # (m, m)
            iu, ju = np.triu_indices(len(rest), k=1)
            par = cosd[iu, ju] < _MAX_COS_DISTANCE
            members.update(rest[iu[par]].tolist())
            members.update(rest[ju[par]].tolist())
        if len(members) > len(best):
            best = np.asarray(sorted(members), int)
    return best


def extract_maximally_parallel_rigid_subgraph(
        orientations: Dict[int, np.ndarray], view_graph) -> int:
    """Remove all views outside the maximal parallel-rigid component.

    orientations: {view_id: angle-axis world-to-camera} as estimated by
    rotation averaging. Mutates view_graph; returns the number of views
    removed (ref ExtractMaximallyParallelRigidSubgraph)."""
    ids = [v for v in sorted(orientations) if view_graph.has_view(v)]
    if len(ids) < 3:
        return 0
    index = {v: k for k, v in enumerate(ids)}
    edges_list = []
    dirs = []
    for (v1, v2), info in view_graph.edges().items():
        if v1 not in index or v2 not in index:
            continue
        R1 = _host_rotations(orientations[v1])
        # rotate t_{1,2} into the global frame (world_to_view1^T @ t)
        dirs.append(R1.T @ np.asarray(info.position_2, float))
        edges_list.append((index[v1], index[v2]))
    if not edges_list:
        return 0
    keep = maximal_rigid_component(np.asarray(edges_list, int),
                                   np.asarray(dirs), len(ids))
    keep_ids = {ids[k] for k in keep.tolist()}
    removed = 0
    for v in ids:
        if v not in keep_ids:
            view_graph.remove_view(v)
            removed += 1
    return removed
