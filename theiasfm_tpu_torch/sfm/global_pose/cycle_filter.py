"""Triplet rotation-cycle consistency filter (port of
theiasfm_tpu/sfm/global_pose/cycle_filter.py).

ref: src/theia/sfm/filter_view_graph_cycles_by_rotation.{h,cc} — for
every connected view triplet, compose the loop rotation
R_ca @ R_bc @ R_ab; edges only survive if they participate in at least
one triplet whose loop deviation from identity is below the threshold.
All triplet loop compositions run in one batched computation on
`device` (the card unless the caller passes "cpu"); the triplet
enumeration stays on the host (math/graph.extract_triplets).
"""
from __future__ import annotations

import numpy as np
import torch

from ...math import rotation as rot
from ...math.graph import extract_triplets
from ...utils.device import full_f32, resolve_device
from ..view_graph import ViewGraph


@full_f32()
def filter_view_graph_cycles_by_rotation(
        graph: ViewGraph, max_loop_error_degrees: float = 3.0,
        dtype=torch.float32, device="cuda") -> int:
    """Remove edges not supported by any consistent triplet. Returns the
    number of removed edges."""
    dev = resolve_device(device)
    edges = list(graph.edges().keys())
    if not edges:
        return 0
    triplets = extract_triplets(edges)
    if not triplets:
        return 0

    # relative rotations in dense arrays keyed per ordered edge
    def rel_aa(a, b):
        info = graph.edge(a, b)
        aa = np.asarray(info.rotation_2, float)
        return aa if a < b else -aa  # stored as low->high; invert else

    R_ab, R_bc, R_ca = [], [], []
    for (a, b, c) in triplets:
        R_ab.append(rel_aa(a, b))
        R_bc.append(rel_aa(b, c))
        R_ca.append(rel_aa(c, a))

    def R(x):
        return rot.angle_axis_to_rotation_matrix(
            torch.as_tensor(np.stack(x), device=dev).to(dtype))

    loop = R(R_ca) @ R(R_bc) @ R(R_ab)
    tr = torch.diagonal(loop, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1) / 2, -1.0, 1.0)
    err_deg = torch.rad2deg(torch.arccos(cos)).cpu().numpy()

    supported = set()
    for (a, b, c), e in zip(triplets, err_deg):
        if e <= max_loop_error_degrees:
            supported.add((a, b) if a < b else (b, a))
            supported.add((b, c) if b < c else (c, b))
            supported.add((a, c) if a < c else (c, a))
    removed = 0
    for (a, b) in edges:
        if (a, b) not in supported:
            graph.remove_edge(a, b)
            removed += 1
    return removed
