"""View-graph filters for the global pipeline (port of
theiasfm_tpu/sfm/global_pose/filters.py).

ref: src/theia/sfm/filter_view_pairs_from_orientation.{h,cc} (drop
edges whose relative rotation disagrees with the global orientations)
and src/theia/sfm/filter_view_pairs_from_relative_translation.{h,cc}
(the 1DSfM filter: random 1-D projections + minimum-feedback-arc-set
orderings score each edge's consistency).

The orientation check is one batched rotation-error computation and the
1DSfM projections one (E, P) matmul, on `device` (the card unless the
caller passes "cpu"); the greedy MFAS orderings (inherently
sequential) and the random axes (numpy, so the draws are the JAX
module's) stay on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...math import rotation as rot
from ...utils.device import full_f32, resolve_device
from .rotation_averaging import _host_rotations


@full_f32()
def filter_view_pairs_from_orientation(orientations: np.ndarray,
                                       edges: np.ndarray,
                                       rel_rotations: np.ndarray,
                                       max_degrees: float = 5.0,
                                       dtype=torch.float32,
                                       device="cuda"):
    """Boolean keep-mask per edge (ref
    filter_view_pairs_from_orientation.cc: compare R_ij against
    R_j R_i^T)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    R = rot.angle_axis_to_rotation_matrix(t(orientations))
    ei = torch.as_tensor(np.asarray(edges[:, 0]), device=dev).long()
    ej = torch.as_tensor(np.asarray(edges[:, 1]), device=dev).long()
    R_rel = rot.angle_axis_to_rotation_matrix(t(rel_rotations))
    R_err = R_rel @ (R[ej] @ R[ei].transpose(-1, -2)).transpose(-1, -2)
    tr = torch.diagonal(R_err, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1) / 2, -1, 1)
    err_deg = torch.rad2deg(torch.arccos(cos))
    return (err_deg < max_degrees).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class RelativeTranslationFilterOptions:
    """ref: FilterViewPairsFromRelativeTranslationOptions."""
    num_iterations: int = 48
    translation_projection_tolerance: float = 0.08


def _mfas_order(n_nodes: int, arcs_i, arcs_j, arc_w) -> np.ndarray:
    """Greedy minimum-feedback-arc-set ordering (1DSfM's ORDER step):
    repeatedly emit the node maximizing (out - in) weight among the
    remaining, sources (in-weight <= 1e-12) first. Returns
    position-in-order per node.

    The same order as the JAX package's native routine
    (native/host_ops.cc mfas_order): float64 weights summed in arc order,
    score = (out - in) + 1e12 for a source, ties to the lowest node (an
    ascending scan with a strict >, here numpy's first argmax), and the
    emitted node's arcs subtracted from the remaining nodes' weights in
    arc order. One numpy argmax per step."""
    ai = np.asarray(arcs_i, np.int64)
    aj = np.asarray(arcs_j, np.int64)
    aw = np.asarray(arc_w, np.float64)
    out_w = np.zeros(n_nodes)
    in_w = np.zeros(n_nodes)
    np.add.at(out_w, ai, aw)
    np.add.at(in_w, aj, aw)
    # each node's out- and in-arcs, in arc order
    by_src = np.argsort(ai, kind="stable")
    by_dst = np.argsort(aj, kind="stable")
    src_start = np.searchsorted(ai[by_src], np.arange(n_nodes + 1))
    dst_start = np.searchsorted(aj[by_dst], np.arange(n_nodes + 1))
    out_j, out_aw = aj[by_src], aw[by_src]
    in_i, in_aw = ai[by_dst], aw[by_dst]

    remaining = np.ones(n_nodes, bool)
    order = np.zeros(n_nodes, dtype=np.int64)
    for pos in range(n_nodes):
        score = out_w - in_w
        score = np.where(in_w <= 1e-12, score + 1e12, score)
        score[~remaining] = -np.inf
        best = int(np.argmax(score))
        remaining[best] = False
        order[best] = pos
        a, b = src_start[best], src_start[best + 1]
        j, w = out_j[a:b], out_aw[a:b]
        keep = remaining[j]
        np.subtract.at(in_w, j[keep], w[keep])
        a, b = dst_start[best], dst_start[best + 1]
        i, w = in_i[a:b], in_aw[a:b]
        keep = remaining[i]
        np.subtract.at(out_w, i[keep], w[keep])
    return order


@full_f32()
def filter_view_pairs_from_relative_translation(
        orientations: np.ndarray, edges: np.ndarray,
        rel_positions: np.ndarray,
        opts: RelativeTranslationFilterOptions =
        RelativeTranslationFilterOptions(),
        seed: int = 0, dtype=torch.float32, device="cuda"):
    """1DSfM relative-translation filter. Returns keep-mask (E,) bool.

    Projects world-frame pairwise directions onto random 1-D axes; for
    each projection, a greedy MFAS ordering of views is computed and
    every edge inconsistent with the ordering accumulates its projected
    weight; edges with high accumulated inconsistency are dropped
    (ref filter_view_pairs_from_relative_translation.cc:279 runs the
    projections on a thread pool; here the projections are one matmul
    and the orderings host loops).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    E = edges.shape[0]
    V = orientations.shape[0]
    R_i = _host_rotations(orientations)[edges[:, 0]]
    t_world = np.einsum("eji,ej->ei", R_i, np.asarray(rel_positions))
    t_world /= np.maximum(
        np.linalg.norm(t_world, axis=-1, keepdims=True), 1e-12)

    P = opts.num_iterations
    axes = rng.normal(size=(P, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    proj = (torch.as_tensor(t_world, device=dev).to(dtype) @
            torch.as_tensor(axes, device=dev).to(dtype).T
            ).cpu().numpy()  # (E, P)

    bad_weight = np.zeros(E)
    total_weight = np.zeros(E)
    for p in range(P):
        w = proj[:, p]
        # arcs oriented along positive projection
        arcs_i = np.where(w >= 0, edges[:, 0], edges[:, 1])
        arcs_j = np.where(w >= 0, edges[:, 1], edges[:, 0])
        aw = np.abs(w)
        order = _mfas_order(V, arcs_i, arcs_j, aw)
        # edge consistent if order[i] < order[j]
        consistent = order[arcs_i] < order[arcs_j]
        bad_weight += np.where(consistent, 0.0, aw)
        total_weight += aw
    frac = bad_weight / np.maximum(total_weight, 1e-12)
    return frac < opts.translation_projection_tolerance
