"""Instance export (per-label point clouds, the Garfield-style HDBSCAN
labelling) and feature-map visualisation.

Port of instascene_tpu/semantic/export.py:15-128 (`generate_semantic_colors`,
`voxel_downsample`, `hdbscan_labels`, `export_segment_results`) and
:131-160 (`feature_to_rgb`, `pca_proj_matrix`). Where JAX's
`feature_to_rgb` calls sklearn's PCA, this port calls its own
`pca_fit_transform` (the same components and signs).

The JAX package calls sklearn's HDBSCAN and NearestNeighbors; the GPU
machine has no sklearn, so `hdbscan` here is sklearn's algorithm
(sklearn/cluster/_hdbscan) written out: core distances to the
min_samples-th nearest point (the point itself counted), the
mutual-reachability minimum spanning tree by Prim's on the given torch
device (one row of distances per step, O(n) memory), then in numpy the
single-linkage tree, the condensed tree at min_cluster_size and
excess-of-mass selection with cluster_selection_epsilon and
allow_single_cluster. Nearest-neighbour relabels use scipy's cKDTree.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.ply import write_point_cloud


def generate_semantic_colors(n: int, seed: int = 0) -> np.ndarray:
    """Distinct instance colors (random, seeded)."""
    rng = np.random.default_rng(seed)
    return rng.random((max(n, 1), 3)) * 0.7 + 0.3


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Sorted indices of one representative point per voxel (the first in
    input order)."""
    mins = points.min(axis=0)
    keys = np.floor((points - mins) / max(voxel, 1e-4)).astype(np.int64)
    flat = (keys[:, 0] * 73856093) ^ (keys[:, 1] * 19349663) ^ (keys[:, 2]
                                                                * 83492791)
    _, first_idx = np.unique(flat, return_index=True)
    return np.sort(first_idx)


# ---------------------------------------------------------------- HDBSCAN

def _core_distances(x: torch.Tensor, k: int, block: int = 2048):
    """Distance of each row of x [n, d] (float64) to its k-th nearest row,
    itself included (sklearn's kneighbors(X, k) over X). Candidates come
    from |a|² + |b|² − 2a·b (one matrix product per block of rows), with a
    margin of 8 for its rounding; their distances are then taken exactly."""
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    kk = min(k + 8, n)
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    for s in range(0, n, block):
        xb = x[s:s + block]
        d2 = sq[s:s + block, None] + sq[None, :] - 2.0 * (xb @ x.T)
        cand = torch.topk(d2, kk, dim=1, largest=False).indices
        exact = torch.linalg.vector_norm(xb[:, None, :] - x[cand], dim=2)
        out[s:s + block] = torch.sort(exact, dim=1).values[:, k - 1]
    return out


def _prim_mst(x: torch.Tensor, core: torch.Tensor,
              graph_steps: int = 256) -> np.ndarray:
    """Prim's minimum spanning tree of the mutual-reachability graph
    (max(core_i, core_j, |x_i − x_j|)), grown from node 0 with sklearn's
    tie rules (mst_from_data_matrix): each step adds the outside node of
    least reachability, the lowest index on ties. Returns edges [n−1, 3]
    (tree node, new node, distance) in the order they were added.

    Every step is a fixed sequence of launches on fixed buffers with no
    host read, so on CUDA the steps run as replays of one captured graph
    of `graph_steps` of them (n − 1 sequential steps, a few microseconds of
    launches each, would otherwise be bound by Python)."""
    n = x.shape[0]
    dev = x.device
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=dev)
    reach = torch.full((n,), float("inf"), dtype=x.dtype, device=dev)
    source = torch.zeros(n, dtype=torch.int64, device=dev)
    # +inf once a node is in the tree: its mutual reachability is then
    # never below anyone's reach (no update) and argmin never picks it
    core_out = core.clone()
    penalty = torch.zeros(n, dtype=x.dtype, device=dev)
    order = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.zeros(1, dtype=torch.int64, device=dev)
    ctr = torch.ones(1, dtype=torch.int64, device=dev)

    def step():
        c = core[cur]
        penalty.index_put_((cur,), inf)
        core_out.index_put_((cur,), inf)
        d = torch.linalg.vector_norm(x - x[cur], dim=1)
        mr = torch.clamp(torch.maximum(d, core_out), min=c)
        better = mr < reach
        reach.copy_(torch.where(better, mr, reach))
        source.copy_(torch.where(better, cur, source))
        new = torch.argmin(reach + penalty).reshape(1)
        order.index_put_((ctr,), new)
        ctr.add_(1)
        cur.copy_(new)

    done = 0
    if dev.type == "cuda" and n - 1 > 3 * graph_steps:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):           # warm-up (real steps)
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        done = 3
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(graph_steps):
                step()
        while done + graph_steps <= n - 1:
            graph.replay()
            done += graph_steps
    for _ in range(n - 1 - done):
        step()
    added = order[1:]
    return torch.stack([source[added].to(x.dtype), added.to(x.dtype),
                        reach[added]], dim=1).cpu().numpy()


def _single_linkage(mst: np.ndarray, n: int) -> np.ndarray:
    """scipy-format single-linkage tree [n−1, 4] (left, right, distance,
    size) from MST edges, sorted by distance (union-find, as sklearn's
    make_single_linkage)."""
    order = np.argsort(mst[:, 2])
    parent = np.arange(2 * n - 1)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    out = np.zeros((n - 1, 4))
    for i, e in enumerate(order):
        a, b = find(int(mst[e, 0])), find(int(mst[e, 1]))
        out[i] = (a, b, mst[e, 2], size[a] + size[b])
        parent[a] = parent[b] = n + i
        size[n + i] = size[a] + size[b]
    return out


def _bfs_hierarchy(tree: np.ndarray, root: int, n: int) -> list:
    out, queue = [], [root]
    while queue:
        out.extend(queue)
        queue = [c for x in queue if x >= n
                 for c in (int(tree[x - n, 0]), int(tree[x - n, 1]))]
    return out


def _condense(tree: np.ndarray, n: int, min_cluster_size: int) -> np.ndarray:
    """sklearn's _condense_tree: rows (parent, child, lambda, size)."""
    root = 2 * (n - 1)
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    next_label = n + 1
    ignore = np.zeros(root + 1, bool)
    rows = []
    size = lambda c: int(tree[c - n, 3]) if c >= n else 1
    for node in _bfs_hierarchy(tree, root, n):
        if ignore[node] or node < n:
            continue
        left, right, dist, _ = tree[node - n]
        left, right = int(left), int(right)
        lam = 1.0 / dist if dist > 0.0 else np.inf
        lc, rc = size(left), size(right)
        if lc >= min_cluster_size and rc >= min_cluster_size:
            for child, cnt in ((left, lc), (right, rc)):
                relabel[child] = next_label
                next_label += 1
                rows.append((relabel[node], relabel[child], lam, cnt))
        else:
            keep = [c for c, cnt in ((left, lc), (right, rc))
                    if cnt >= min_cluster_size]
            for child in keep:
                relabel[child] = relabel[node]
            for child in (left, right):
                if child in keep:
                    continue
                for sub in _bfs_hierarchy(tree, child, n):
                    if sub < n:
                        rows.append((relabel[node], sub, lam, 1))
                    ignore[sub] = True
    return np.array(rows, dtype=[("parent", np.int64), ("child", np.int64),
                                 ("value", np.float64),
                                 ("cluster_size", np.int64)])


def _stability(ct: np.ndarray) -> dict:
    smallest = int(ct["parent"].min())
    largest = max(int(ct["child"].max()), smallest)
    births = np.full(largest + 1, np.nan)
    births[ct["child"]] = ct["value"]
    births[smallest] = 0.0
    res = np.zeros(int(ct["parent"].max()) - smallest + 1)
    np.add.at(res, ct["parent"] - smallest,
              (ct["value"] - births[ct["parent"]]) * ct["cluster_size"])
    return {smallest + i: float(v) for i, v in enumerate(res)}


def _bfs_cluster_tree(tree: np.ndarray, root: int) -> list:
    out, queue = [], np.array([root])
    while len(queue):
        out.extend(queue.tolist())
        queue = tree["child"][np.isin(tree["parent"], queue)]
    return out


def _traverse_upwards(tree, eps, leaf, allow_single):
    root = tree["parent"].min()
    parent = tree[tree["child"] == leaf]["parent"][0]
    if parent == root:
        return parent if allow_single else leaf
    if 1 / tree[tree["child"] == parent]["value"][0] > eps:
        return parent
    return _traverse_upwards(tree, eps, parent, allow_single)


def _epsilon_search(leaves, tree, eps, allow_single):
    selected, processed = [], []
    for leaf in leaves:
        if 1 / tree["value"][tree["child"] == leaf][0] < eps:
            if leaf not in processed:
                c = _traverse_upwards(tree, eps, leaf, allow_single)
                selected.append(c)
                processed += [s for s in _bfs_cluster_tree(tree, c)
                              if s != c]
        else:
            selected.append(leaf)
    return set(selected)


def _select_and_label(ct: np.ndarray, allow_single: bool,
                      eps: float) -> np.ndarray:
    """sklearn's _get_clusters (excess of mass) and _do_labelling."""
    stability = _stability(ct)
    nodes = sorted(stability, reverse=True)
    if not allow_single:
        nodes = nodes[:-1]
    tree = ct[ct["cluster_size"] > 1]
    is_cluster = {c: True for c in nodes}
    for node in nodes:
        sub = float(np.sum([stability[c]
                            for c in tree["child"][tree["parent"] == node]]))
        if sub > stability[node]:
            is_cluster[node] = False
            stability[node] = sub
        else:
            for s in _bfs_cluster_tree(tree, node):
                if s != node:
                    is_cluster[s] = False
    if eps != 0.0 and len(tree) > 0:
        eom = [c for c in is_cluster if is_cluster[c]]
        selected = []
        if len(eom) == 1 and eom[0] == tree["parent"].min():
            if allow_single:
                selected = eom
        else:
            selected = _epsilon_search(set(eom), tree, eps, allow_single)
        for c in is_cluster:
            is_cluster[c] = c in selected
    clusters = {c for c in is_cluster if is_cluster[c]}
    label_of = {c: i for i, c in enumerate(sorted(clusters))}

    root = int(ct["parent"].min())
    # union every row whose child is not a selected cluster: a point's
    # root is then the selected cluster above it, or the tree's root
    up = np.arange(int(ct["parent"].max()) + 1)
    for parent, child in zip(ct["parent"].tolist(), ct["child"].tolist()):
        if child not in clusters:
            up[child] = parent
    top = up.copy()
    while True:
        nxt = up[top]
        if np.array_equal(nxt, top):
            break
        top = nxt
    top = top[:root]
    labels = np.full(root, -1, np.int64)
    inner = top != root
    labels[inner] = [label_of[c] for c in top[inner].tolist()]
    if len(clusters) == 1 and allow_single and root in label_of:
        # the root is the one cluster: a point joins it when it left the
        # root at lambda >= 1/eps (or the root's largest lambda)
        lam = np.full(root, -np.inf)
        pts = ct["child"] < root
        lam[ct["child"][pts]] = ct["value"][pts]
        thr = (1 / eps if eps != 0.0
               else ct["value"][ct["parent"] == root].max())
        labels[~inner & (lam >= thr)] = label_of[root]
    return labels


def hdbscan(x: np.ndarray, min_cluster_size: int, min_samples: int,
            cluster_selection_epsilon: float = 0.0,
            allow_single_cluster: bool = False, device=None,
            seconds: Optional[dict] = None) -> np.ndarray:
    """HDBSCAN labels of x [n, d] (noise -1) with sklearn.cluster.HDBSCAN's
    semantics (euclidean, alpha 1, excess of mass). The core distances and
    Prim's tree run on `device` (CUDA unless "cpu" is asked for); ties in
    the tree may break otherwise than sklearn's. seconds, when given,
    receives the host seconds by stage."""
    n = x.shape[0]
    if n < 2:
        return np.full(n, -1, np.int64)
    t = [time.perf_counter()]
    xt = torch.as_tensor(np.asarray(x, np.float64),
                         device=resolve_device(device))
    core = _core_distances(xt, min_samples)
    if xt.device.type == "cuda":
        torch.cuda.synchronize(xt.device)
    t.append(time.perf_counter())
    mst = _prim_mst(xt, core)            # ends in a device-to-host copy
    t.append(time.perf_counter())
    tree = _single_linkage(mst, n)
    ct = _condense(tree, n, min_cluster_size)
    labels = _select_and_label(ct, allow_single_cluster,
                               cluster_selection_epsilon)
    t.append(time.perf_counter())
    if seconds is not None:
        seconds.update({"HDBSCAN core distances": t[1] - t[0],
                        "HDBSCAN spanning tree": t[2] - t[1],
                        "HDBSCAN linkage, condense, select": t[3] - t[2]})
    return labels


def hdbscan_labels(positions: np.ndarray, feats: np.ndarray,
                   downsample_size: float = 0.01,
                   cluster_selection_epsilon: float = 0.1,
                   min_samples: int = 30, min_cluster_size: int = 30,
                   device=None, seconds: Optional[dict] = None
                   ) -> np.ndarray:
    """Garfield-style labelling: voxel downsample → HDBSCAN on the features
    → nearest-neighbour relabel of the dropped and the noise points
    (reference train_semantic.py:248-314)."""
    from scipy.spatial import cKDTree

    n = positions.shape[0]
    ds = downsample_size
    idx = voxel_downsample(positions, ds)
    while len(idx) > 1_000_000:
        ds *= 2
        idx = voxel_downsample(positions, ds)
    feats_ds = feats[idx]
    pos_ds = positions[idx]
    eff_min = max(2, min(min_cluster_size, max(len(idx) // 4, 2)))
    labels_ds = hdbscan(feats_ds, eff_min, min(min_samples, eff_min),
                        cluster_selection_epsilon, True, device=device,
                        seconds=seconds).astype(np.int32)
    labels = -np.ones(n, dtype=np.int32)
    labels[idx] = labels_ds
    rest = np.ones(n, dtype=bool)
    rest[idx] = False
    if rest.any():
        _, ind = cKDTree(pos_ds).query(positions[rest], k=1)
        labels[rest] = labels_ds[ind]
    noise = labels == -1
    if noise.any() and (labels >= 0).any():
        valid = labels >= 0
        _, ind = cKDTree(positions[valid]).query(positions[noise], k=1)
        labels[noise] = labels[valid][ind]
    return labels


def export_segment_results(positions: np.ndarray, feats: np.ndarray,
                           seg3d_masks: np.ndarray, seg3d_labels: np.ndarray,
                           save_dir: str, score_threshold: float = 0.9,
                           use_hdbscan: bool = False, device=None,
                           seconds: Optional[dict] = None
                           ) -> Optional[np.ndarray]:
    """Per-instance point clouds under save_dir/label_pointclouds and all of
    them in point_cloud_labels.ply: the HDBSCAN labelling (its labels also
    in point_cloud_labels.npy, and returned), or the coarse 3D-mask mode
    (mean-feature score ≥ score_threshold). seconds: see hdbscan."""
    os.makedirs(save_dir, exist_ok=True)
    partial_dir = os.path.join(save_dir, "label_pointclouds")
    os.makedirs(partial_dir, exist_ok=True)

    if use_hdbscan:
        labels = hdbscan_labels(positions, feats, device=device,
                                seconds=seconds)
        uniq = np.unique(labels)
        colors = generate_semantic_colors(len(uniq))
        all_pts, all_cols = [], []
        for i, lab in enumerate(uniq):
            pts = positions[labels == lab]
            col = np.broadcast_to(colors[i], pts.shape)
            write_point_cloud(os.path.join(partial_dir, f"{lab}.ply"),
                              pts, col.copy())
            all_pts.append(pts)
            all_cols.append(col)
        write_point_cloud(os.path.join(save_dir, "point_cloud_labels.ply"),
                          np.concatenate(all_pts), np.concatenate(all_cols))
        np.save(os.path.join(save_dir, "point_cloud_labels.npy"), labels)
        return labels

    k = seg3d_masks.shape[1]
    colors = generate_semantic_colors(k)
    all_pts, all_cols = [], []
    n = min(len(positions), seg3d_masks.shape[0])
    for i in range(k):
        member = seg3d_masks[:n, i]
        if member.sum() == 0:
            sel = seg3d_labels[:n] == i
        else:
            mean_feat = feats[:n][member].mean(axis=0)
            sel = feats[:n] @ mean_feat >= score_threshold
            if sel.sum() == 0:
                sel = seg3d_labels[:n] == i
        pts = positions[:n][sel]
        if len(pts) == 0:
            continue
        col = np.broadcast_to(colors[i], pts.shape)
        write_point_cloud(os.path.join(partial_dir, f"{i}.ply"), pts,
                          col.copy())
        all_pts.append(pts)
        all_cols.append(col)
    if all_pts:
        write_point_cloud(os.path.join(save_dir, "point_cloud_labels.ply"),
                          np.concatenate(all_pts), np.concatenate(all_cols))
    return None


def pca_fit_transform(x: np.ndarray, n_components: int = 3) -> np.ndarray:
    """sklearn's PCA(n_components).fit_transform(x) written out, so the
    port needs no sklearn: the centred data on its top components, each
    component's largest-magnitude coefficient made positive (svd_flip
    with u_based_decision=False, sklearn >= 1.5)."""
    c = x - x.mean(axis=0)
    c64 = c.astype(np.float64)
    eigvals, eigvecs = np.linalg.eigh(c64.T @ c64)
    comp = eigvecs[:, np.argsort(-eigvals)[:n_components]].T
    top = np.argmax(np.abs(comp), axis=1)
    comp *= np.sign(comp[np.arange(len(comp)), top])[:, None]
    return (c @ comp.T.astype(x.dtype)).astype(x.dtype)


def feature_to_rgb(featmap: np.ndarray,
                   pca_proj: Optional[np.ndarray] = None) -> np.ndarray:
    """[H,W,E] feature map → uint8 RGB through an [E,3] PCA projection, or
    through the map's own PCA when `pca_proj` is None."""
    h, w, e = featmap.shape
    flat = featmap.reshape(-1, e)
    flat = flat / (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-9)
    low = flat @ pca_proj if pca_proj is not None else pca_fit_transform(flat)
    low = (low.reshape(h, w, 3) * 0.5 + 0.5).clip(0, 1)
    return (low * 255).astype(np.uint8)


def pca_proj_matrix(feats: np.ndarray, n_sample: int = 200_000,
                    seed: int = 0) -> np.ndarray:
    """[E,3] PCA projection from sampled (normalized, centered) features."""
    rng = np.random.default_rng(seed)
    n = feats.shape[0]
    idx = rng.integers(0, n, min(n_sample, n * 4))
    f = feats[idx]
    f = f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-6)
    f = f - f.mean(axis=0)
    cov = f.T @ f / len(f)
    eigvals, eigvecs = np.linalg.eigh(cov)
    order = np.argsort(-eigvals)
    return eigvecs[:, order[:3]].astype(np.float32)
