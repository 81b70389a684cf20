"""ViewGraph: undirected view graph with TwoViewInfo edge payloads (port
of theiasfm_tpu/sfm/view_graph.py).

ref: src/theia/sfm/view_graph/view_graph.h:59-99 and
src/theia/sfm/twoview_info.h. Host bookkeeping in numpy: the swap of an
edge's payload builds its rotation with the port's math/rotation on a
CPU tensor, so no edge costs a device launch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..math import rotation as rot
from ..math.graph import largest_connected_component

@dataclasses.dataclass
class TwoViewInfo:
    """ref: src/theia/sfm/twoview_info.h. rotation_2/position_2 describe
    camera 2 relative to camera 1 (angle-axis; unit baseline)."""
    focal_length_1: float = 0.0
    focal_length_2: float = 0.0
    position_2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    rotation_2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    num_verified_matches: int = 0
    num_homography_inliers: int = 0
    visibility_score: int = 0


def _key(v1: int, v2: int) -> Tuple[int, int]:
    return (v1, v2) if v1 < v2 else (v2, v1)


def swap_two_view_info(info: TwoViewInfo) -> TwoViewInfo:
    """Invert the relative geometry: if info describes camera b w.r.t.
    camera a (R_ab, position of b in a's frame), return the a-w.r.t.-b
    form: R_ba = R_ab^T, position' = -R_ab @ position
    (ref TwoViewInfo::SwapCameras)."""
    R_ab = rot.angle_axis_to_rotation_matrix(torch.from_numpy(
        np.asarray(info.rotation_2, np.float64))).numpy()
    return TwoViewInfo(
        focal_length_1=info.focal_length_2,
        focal_length_2=info.focal_length_1,
        rotation_2=-np.asarray(info.rotation_2, float),
        position_2=-(R_ab @ np.asarray(info.position_2, float)),
        num_verified_matches=info.num_verified_matches,
        num_homography_inliers=info.num_homography_inliers,
        visibility_score=info.visibility_score)


class ViewGraph:
    """ref: ViewGraph (view_graph.h)."""

    def __init__(self):
        self._edges: Dict[Tuple[int, int], TwoViewInfo] = {}
        self._adj: Dict[int, set] = {}

    def num_views(self) -> int:
        return len(self._adj)

    def num_edges(self) -> int:
        return len(self._edges)

    def has_view(self, v: int) -> bool:
        return v in self._adj

    def has_edge(self, v1: int, v2: int) -> bool:
        return _key(v1, v2) in self._edges

    def view_ids(self):
        return sorted(self._adj.keys())

    def add_edge(self, v1: int, v2: int, info: TwoViewInfo):
        """Edges are stored with ordered ids; when the caller passes
        v1 > v2 the TwoViewInfo payload is swapped to keep the
        '2 relative to 1' convention (ref ViewGraph::AddEdge /
        TwoViewInfo::SwapCameras, twoview_info.cc)."""
        if v1 == v2:
            return
        if v1 > v2:
            info = swap_two_view_info(info)
        self._edges[_key(v1, v2)] = info
        self._adj.setdefault(v1, set()).add(v2)
        self._adj.setdefault(v2, set()).add(v1)

    def remove_edge(self, v1: int, v2: int) -> bool:
        info = self._edges.pop(_key(v1, v2), None)
        if info is None:
            return False
        self._adj[v1].discard(v2)
        self._adj[v2].discard(v1)
        for v in (v1, v2):
            if not self._adj[v]:
                del self._adj[v]
        return True

    def remove_view(self, v: int) -> bool:
        if v not in self._adj:
            return False
        for n in list(self._adj[v]):
            self.remove_edge(v, n)
        self._adj.pop(v, None)
        return True

    def neighbors(self, v: int):
        return sorted(self._adj.get(v, ()))

    def edge(self, v1: int, v2: int) -> Optional[TwoViewInfo]:
        return self._edges.get(_key(v1, v2))

    def edges(self) -> Dict[Tuple[int, int], TwoViewInfo]:
        return self._edges

    def remove_disconnected_views(self):
        """Keep only the largest connected component; returns removed ids.
        ref: sfm/view_graph/remove_disconnected_view_pairs.cc."""
        nodes = self.view_ids()
        keep = set(largest_connected_component(nodes,
                                               list(self._edges.keys())))
        removed = [v for v in nodes if v not in keep]
        for v in removed:
            self.remove_view(v)
        return removed
