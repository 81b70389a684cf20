"""Normalized graph cut (Shi-Malik spectral bipartition); a numpy copy
of theiasfm_tpu/math/normalized_cut.py.

ref: src/theia/math/graph/normalized_graph_cut.h — used for view-graph
clustering. Spectral form: second-smallest eigenvector of the
symmetric-normalized Laplacian, split at the threshold minimizing the
normalized-cut objective.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def normalized_cut(num_nodes: int, edges: np.ndarray,
                   weights: np.ndarray) -> Tuple[np.ndarray, float]:
    """Bipartition nodes. edges (E, 2), weights (E,) > 0.

    Returns (labels (num_nodes,) in {0, 1}, ncut_value)."""
    W = np.zeros((num_nodes, num_nodes))
    for (a, b), w in zip(np.asarray(edges), np.asarray(weights)):
        W[int(a), int(b)] += w
        W[int(b), int(a)] += w
    d = W.sum(1)
    d_safe = np.maximum(d, 1e-12)
    D_isqrt = 1.0 / np.sqrt(d_safe)
    L_sym = np.eye(num_nodes) - (D_isqrt[:, None] * W * D_isqrt[None, :])
    vals, vecs = np.linalg.eigh(L_sym)
    fiedler = D_isqrt * vecs[:, 1]

    # scan thresholds for the best ncut
    order = np.argsort(fiedler)
    best_labels, best_ncut = None, np.inf
    total_assoc = d.sum()
    for k in range(1, num_nodes):
        A = order[:k]
        labels = np.ones(num_nodes, np.int64)
        labels[A] = 0
        cut = W[np.ix_(A, order[k:])].sum()
        assoc_a = d[A].sum()
        assoc_b = total_assoc - assoc_a
        if assoc_a < 1e-12 or assoc_b < 1e-12:
            continue
        ncut = cut / assoc_a + cut / assoc_b
        if ncut < best_ncut:
            best_ncut, best_labels = ncut, labels
    if best_labels is None:
        best_labels = np.zeros(num_nodes, np.int64)
        best_ncut = 0.0
    return best_labels, float(best_ncut)
