"""Host-side sparse graph algorithms (a copy of theiasfm_tpu/math/graph.py,
which is numpy only).

ref: src/theia/math/graph/connected_components.h (union-find),
minimum_spanning_tree.h, triplet_extractor.h. These stay on the host:
dynamic sparse graph manipulation has no batched form; the outputs
(component labels, tree edges, triplet lists) feed fixed-shape device
computations.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Tuple

import numpy as np


class UnionFind:
    """Array-based union-find with path halving + union by size.
    ref: ConnectedComponents<T> (math/graph/connected_components.h)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        return True

    def components(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for i in range(len(self.parent)):
            out.setdefault(self.find(i), []).append(i)
        return out


def connected_components(num_nodes: int,
                         edges: Iterable[Tuple[int, int]]) -> np.ndarray:
    """Labels (num_nodes,) of each node's component root."""
    uf = UnionFind(num_nodes)
    for a, b in edges:
        uf.union(a, b)
    return np.asarray([uf.find(i) for i in range(num_nodes)])


def largest_connected_component(nodes: List[Hashable],
                                edges: Iterable[Tuple[Hashable, Hashable]]):
    """Subset of `nodes` in the largest component (ref usage:
    RemoveDisconnectedViewPairs, view_graph.cc)."""
    idx = {n: i for i, n in enumerate(nodes)}
    uf = UnionFind(len(nodes))
    for a, b in edges:
        uf.union(idx[a], idx[b])
    comps: Dict[int, List] = {}
    for n in nodes:
        comps.setdefault(uf.find(idx[n]), []).append(n)
    if not comps:
        return []
    return max(comps.values(), key=len)


def minimum_spanning_tree(num_nodes: int, edges: np.ndarray,
                          weights: np.ndarray) -> List[int]:
    """Kruskal MST. edges (E, 2) int, weights (E,). Returns edge indices.
    ref: math/graph/minimum_spanning_tree.h."""
    order = np.argsort(weights, kind="stable")
    uf = UnionFind(num_nodes)
    out = []
    for e in order:
        a, b = int(edges[e, 0]), int(edges[e, 1])
        if uf.union(a, b):
            out.append(int(e))
    return out


def extract_triplets(edges: Iterable[Tuple[int, int]]):
    """All connected triplets (i, j, k) with all three edges present.
    ref: math/graph/triplet_extractor.h."""
    adj: Dict[int, set] = {}
    eset = set()
    for a, b in edges:
        a, b = (a, b) if a < b else (b, a)
        eset.add((a, b))
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    triplets = []
    for (a, b) in sorted(eset):
        common = adj[a] & adj[b]
        for c in sorted(common):
            if c > b:
                triplets.append((a, b, c))
    return triplets
