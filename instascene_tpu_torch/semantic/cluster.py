"""Clustering on scipy, for the viewer and the spatial track.

The JAX package calls sklearn's DBSCAN (instascene_tpu/viewer/gui.py,
instascene_tpu/semantic/spatial_track.py:178-192) and networkx's
connected components (spatial_track.py:159-175); the GPU machine has
neither, so the port has its own on scipy (cKDTree + csgraph) with the same
results, order included.
"""

from __future__ import annotations

from typing import List

import numpy as np


def dbscan(pts: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN labels with sklearn.cluster.DBSCAN's semantics: neighbours
    within eps inclusive, min_samples counts the point itself, clusters
    numbered in order of their lowest-index core point, a border point
    joins the first cluster that reaches it (the lowest-numbered adjacent
    one), noise is -1. Memory grows with the number of eps-pairs."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    n = len(pts)
    labels = np.full(n, -1, np.int64)
    pairs = cKDTree(np.asarray(pts, np.float64)).query_pairs(
        eps, output_type="ndarray")
    core = np.bincount(pairs.ravel(), minlength=n) + 1 >= min_samples
    if not core.any():
        return labels
    core_idx = np.nonzero(core)[0]
    remap = np.full(n, -1, np.int64)
    remap[core_idx] = np.arange(len(core_idx))
    cc = pairs[core[pairs[:, 0]] & core[pairs[:, 1]]]
    graph = coo_matrix((np.ones(len(cc), np.int8),
                        (remap[cc[:, 0]], remap[cc[:, 1]])),
                       shape=(len(core_idx), len(core_idx)))
    n_comp, comp = connected_components(graph, directed=False)
    _, first = np.unique(comp, return_index=True)
    rank = np.empty(n_comp, np.int64)
    rank[np.argsort(first)] = np.arange(n_comp)
    labels[core_idx] = rank[comp]
    mixed = pairs[core[pairs[:, 0]] != core[pairs[:, 1]]]
    c = np.where(core[mixed[:, 0]], mixed[:, 0], mixed[:, 1])
    b = np.where(core[mixed[:, 0]], mixed[:, 1], mixed[:, 0])
    border = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(border, b, labels[c])
    hit = border != np.iinfo(np.int64).max
    labels[hit] = border[hit]
    return labels


def connected_components(adj: np.ndarray) -> List[List[int]]:
    """Connected components of the undirected graph with boolean adjacency
    adj [n, n], in networkx's order: components by their smallest node,
    each listing its members as networkx's set of them iterates (its BFS
    from that node adds them in breadth-first order, neighbours ascending;
    a set built by the same additions iterates the same way)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order
    from scipy.sparse.csgraph import connected_components as cc

    graph = csr_matrix(np.asarray(adj, bool))
    graph.sort_indices()
    n_comp, comp = cc(graph, directed=False)
    _, first = np.unique(comp, return_index=True)
    out = []
    for source in np.sort(first):
        bfs = breadth_first_order(graph, int(source), directed=False,
                                  return_predecessors=False)
        members = set()
        for v in bfs.tolist():
            members.add(v)
        out.append(list(members))
    return out
