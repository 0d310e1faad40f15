"""Spatial track: multi-view-consistent instance priors by mask clustering
over the rasterizer's traced gaussian↔mask associations.

Port of instascene_tpu/semantic/spatial_track.py:1-464, carried over in
numpy: host code that runs once per scene, fed by K1's track mode (each
pixel's w > 0.1 contributors, `render(track_contrib=True)`). networkx's
connected components become semantic/cluster.connected_components (scipy
csgraph, the same component and member order), sklearn's DBSCAN becomes
semantic/cluster.dbscan, the progress bars are gone, and label maps are
read and written by utils/image.py (uint16 maps as 16-bit gray PNGs, as
PIL writes them). output_dict.npy and the mask_sorted / mask_filtered maps
equal the JAX package's for the same tracker renders.

Parity map (reference spatial_track/):
  get_segmap_gaussians .......... modules/init_tracker.py:16-47
  construct_tracker ............. modules/init_tracker.py:78-173
  judge_single_mask ............. modules/init_tracker.py:176-233
  observer_num_thresholds ....... modules/init_tracker.py:237-253
  iterative_clustering .......... modules/iterative_cluster.py
  dbscan/filter/merge ........... modules/post_process.py
  remedy_undersegment ........... modules/remedy_undersegment.py
  GausCluster facade + exports .. spatialtrack.py
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..utils.image import read_image, write_png
from .cluster import connected_components, dbscan


def _read_label_map(path: str) -> np.ndarray:
    """A label PNG as PIL's np.array gives it: [H, W] for one band (uint8
    or uint16), [H, W, C] otherwise."""
    arr = read_image(path)
    return arr[..., 0] if arr.shape[2] == 1 else arr


@dataclass
class ClusteringArgs:
    """Thresholds (reference spatialtrack.py:24-30)."""
    mask_visible_threshold: float = 0.7
    undersegment_filter_threshold: float = 0.3
    contained_threshold: float = 0.8
    view_consensus_threshold: float = 0.9
    point_filter_threshold: float = 0.5
    min_gaussians_per_mask: int = 50
    dbscan_eps: float = 0.1
    dbscan_min_points: int = 4
    merge_overlap_ratio: float = 0.8
    remedy_threshold: float = 0.8


@dataclass
class Node:
    mask_list: List[Tuple[int, int]]
    visible_frame: np.ndarray    # [F] bool
    contained_mask: np.ndarray   # [M] bool
    point_ids: Set[int]

    @staticmethod
    def merge(nodes: List["Node"]) -> "Node":
        out = Node(mask_list=[], visible_frame=nodes[0].visible_frame.copy(),
                   contained_mask=nodes[0].contained_mask.copy(),
                   point_ids=set())
        out.visible_frame[:] = False
        out.contained_mask[:] = False
        for n in nodes:
            out.mask_list += n.mask_list
            out.visible_frame |= n.visible_frame
            out.contained_mask |= n.contained_mask
            out.point_ids |= n.point_ids
        return out


def segmap_gaussians_from_tracker(contrib_ids: np.ndarray, segmap: np.ndarray,
                                  min_gaussians: int = 50):
    """mask_id → set(gaussian ids) from the per-pixel top-K contributor buffer
    (parity: init_tracker.py:16-47, which filters masks with <50 gaussians).

    contrib_ids: [H,W,K] int32, -1 empty. segmap: [H,W] int."""
    ids = contrib_ids.reshape(-1, contrib_ids.shape[-1])
    seg = segmap.reshape(-1)
    valid = ids >= 0
    frame_gaussians = set(np.unique(ids[valid]).tolist())
    mask_info = {}
    for mask_id in np.unique(seg):
        if mask_id == 0:
            continue
        rows = seg == mask_id
        g = ids[rows]
        g = np.unique(g[g >= 0])
        if len(g) < min_gaussians:
            continue
        mask_info[int(mask_id)] = set(g.tolist())
    return mask_info, frame_gaussians


def compute_mask_visible_frames(gaussian_in_mask: "np.ndarray",
                                gaussian_in_frame: np.ndarray,
                                threshold: float = 0.0) -> np.ndarray:
    """[M,F] bool: fraction of a mask's gaussians visible in frame > threshold
    (init_tracker.py:50-75)."""
    from scipy.sparse import csr_matrix
    A = csr_matrix(gaussian_in_mask, dtype=np.float32)
    B = csr_matrix(gaussian_in_frame, dtype=np.float32)
    inter = (A.T @ B).tocoo()
    mask_counts = np.asarray(A.sum(axis=0)).ravel() + 1e-6
    keep = (inter.data / mask_counts[inter.row]) > threshold
    out = np.zeros((A.shape[1], B.shape[1]), dtype=bool)
    out[inter.row[keep], inter.col[keep]] = True
    return out


def judge_single_mask(gaussian_in_frame_maskid: np.ndarray,
                      mask_gaussians: Set[int],
                      mask_visible_frame: np.ndarray,
                      frame_mask_index: Dict[Tuple[int, int], int],
                      n_masks: int, n_frames: int,
                      args: ClusteringArgs):
    """Undersegmentation test (init_tracker.py:176-233)."""
    visible_frame = np.zeros(n_frames, dtype=bool)
    contained_mask = np.zeros(n_masks, dtype=bool)
    rows = gaussian_in_frame_maskid[sorted(mask_gaussians), :]
    split_num = 0
    visible_num = 0
    for frame_id in np.nonzero(mask_visible_frame)[0]:
        ids, cnts = np.unique(rows[:, frame_id], return_counts=True)
        order = np.argsort(cnts)[::-1]
        ids, cnts = ids[order], cnts[order]
        if 0 in ids:
            zi = np.nonzero(ids == 0)[0]
            if cnts[zi].sum() / cnts.sum() > args.mask_visible_threshold:
                continue
            keep = ids != 0
            ids, cnts = ids[keep], cnts[keep]
        if len(ids) == 0:
            continue
        visible_num += 1
        if cnts[0] / cnts.sum() > args.contained_threshold:
            key = (frame_id, int(ids[0]))
            if key in frame_mask_index:
                contained_mask[frame_mask_index[key]] = True
                visible_frame[frame_id] = True
        else:
            split_num += 1
    valid = not (visible_num == 0
                 or split_num / visible_num > args.undersegment_filter_threshold)
    return valid, contained_mask, visible_frame


def observer_num_thresholds(visible_frames: np.ndarray) -> List[float]:
    """Percentile ladder 95%→0% step −5 (init_tracker.py:237-253)."""
    vf = visible_frames.astype(np.float32)
    m = vf @ vf.T
    vals = m.flatten()
    vals = vals[vals > 0]
    out = []
    for percentile in range(95, -5, -5):
        v = np.percentile(vals, percentile)
        if v <= 1:
            if percentile < 50:
                break
            v = 1
        out.append(float(v))
    return out


def iterative_clustering(nodes: List[Node], thresholds: List[float],
                         connect_threshold: float) -> List[Node]:
    """View-consensus graph rounds + connected components
    (iterative_cluster.py:15-54)."""
    for thr in thresholds:
        vf = np.stack([n.visible_frame for n in nodes]).astype(np.float32)
        cm = np.stack([n.contained_mask for n in nodes]).astype(np.float32)
        observers = vf @ vf.T
        supporters = cm @ cm.T
        rate = supporters / (observers + 1e-7)
        adj = (rate >= connect_threshold) & (observers >= thr)
        np.fill_diagonal(adj, False)
        nodes = [Node.merge([nodes[i] for i in comp])
                 for comp in connected_components(adj)]
    return nodes


def dbscan_split(points: np.ndarray, point_ids: np.ndarray,
                 eps: float = 0.1, min_points: int = 4):
    """Split a node's points into spatial components (post_process.py:123-142;
    a DBSCAN of sklearn's semantics replaces open3d cluster_dbscan; noise
    label -1 → bin 0)."""
    if len(points) == 0:
        return []
    labels = dbscan(points, eps, min_points) + 1
    out = []
    for lab in range(labels.max() + 1):
        idx = np.nonzero(labels == lab)[0]
        if len(idx) == 0:
            continue
        out.append((points[idx], point_ids[idx]))
    return out


def filter_points_by_detection_ratio(
        node: Node, components, gaussian_in_frame: np.ndarray,
        mask_gaussian_pclds: Dict[str, Set[int]], args: ClusteringArgs):
    """OVIR-3D detection-ratio filter + per-object mask assignment
    (post_process.py:49-120)."""
    frame_ids = np.nonzero(node.visible_frame)[0]
    results = []
    per_obj_masks = [[] for _ in components]
    appear_in_node = [np.zeros((len(pids), len(frame_ids)), dtype=bool)
                      for _, pids in components]
    appear_in_video = [gaussian_in_frame[pids][:, frame_ids].sum(axis=1)
                       for _, pids in components]

    frame_pos = {f: i for i, f in enumerate(frame_ids)}
    for frame_id, mask_id in node.mask_list:
        if frame_id not in frame_pos:
            continue
        fi = frame_pos[frame_id]
        mask_pts = list(mask_gaussian_pclds[f"{frame_id}_{mask_id}"])
        best_obj, best_n, coverage = -1, 0, 0.0
        for i, (_, pids) in enumerate(components):
            within = np.nonzero(np.isin(pids, mask_pts))[0]
            appear_in_node[i][within, fi] = True
            if len(within) > best_n:
                best_obj, best_n = i, len(within)
                coverage = len(within) / len(pids)
        if best_n > 0:
            per_obj_masks[best_obj].append((frame_id, mask_id, coverage))

    for i, (pts, pids) in enumerate(components):
        ratio = appear_in_node[i].sum(axis=1) / (appear_in_video[i] + 1e-6)
        valid = np.nonzero(ratio > args.point_filter_threshold)[0]
        if len(valid) == 0 or len(per_obj_masks[i]) < 2:
            continue
        bbox = (pts.min(axis=0), pts.max(axis=0))
        results.append((pids[valid], bbox, per_obj_masks[i]))
    return results


def merge_overlapping_objects(objects, overlap_ratio: float = 0.8):
    """Drop objects ≥80% contained in another (post_process.py:16-46)."""
    n = len(objects)
    invalid = np.zeros(n, dtype=bool)

    def boxes_overlap(b1, b2):
        return all(b1[0][i] <= b2[1][i] and b2[0][i] <= b1[1][i]
                   for i in range(3))

    sets = [set(o[0].tolist()) for o in objects]
    for i in range(n):
        if invalid[i]:
            continue
        for j in range(i + 1, n):
            if invalid[j]:
                continue
            if boxes_overlap(objects[i][1], objects[j][1]):
                inter = len(sets[i] & sets[j])
                if inter / max(len(sets[i]), 1) > overlap_ratio:
                    invalid[i] = True
                elif inter / max(len(sets[j]), 1) > overlap_ratio:
                    invalid[j] = True
    return [o for i, o in enumerate(objects) if not invalid[i]], invalid


def remedy_undersegment(mask_assoc: dict, args: ClusteringArgs) -> dict:
    """Re-assign undersegment masks ≥80% covered by one instance
    (remedy_undersegment.py:10-48)."""
    gm = mask_assoc["global_frame_mask_list"]
    under = [gm[i] for i in mask_assoc["undersegment_mask_ids"]]
    instance_sets = [set(p.tolist())
                     for p in mask_assoc["total_point_ids_list"]]
    gif = mask_assoc["gaussian_in_frame_matrix"]
    frames_gaussian = [set(np.nonzero(gif[:, f])[0].tolist())
                       for f in range(gif.shape[1])]
    still_under = []
    fixed = {}
    for frame_id, mask_id in under:
        mask_g = mask_assoc["mask_gaussian_pclds"][f"{frame_id}_{mask_id}"]
        fg = frames_gaussian[frame_id]
        inter = np.array([len(mask_g & (s & fg)) for s in instance_sets])
        if len(inter) == 0:
            still_under.append(gm.index((frame_id, mask_id)))
            continue
        best = int(np.argmax(inter))
        if inter[best] / max(len(mask_g), 1) > args.remedy_threshold:
            fixed[(frame_id, mask_id)] = best
        else:
            still_under.append(gm.index((frame_id, mask_id)))
    mask_assoc["undersegment_mask_ids"] = still_under
    for fm, inst in fixed.items():
        mask_assoc["total_mask_list"][inst].append(fm)
    return mask_assoc


class GausCluster:
    """Facade (spatialtrack.py:18-128). `trace_fn(view_idx)` must return
    (contrib_ids [H,W,K], segmap [H,W]) for that training view."""

    def __init__(self, n_gaussians: int, xyz: np.ndarray,
                 view_names: List[str], trace_fn,
                 args: Optional[ClusteringArgs] = None):
        self.n = n_gaussians
        self.xyz = xyz
        self.view_names = view_names
        self.trace_fn = trace_fn
        self.args = args or ClusteringArgs()

    def construct_tracker(self, cache_dir: Optional[str] = None) -> dict:
        n_frames = len(self.view_names)
        gaussian_in_frame_maskid = np.zeros((self.n, n_frames), dtype=np.uint16)
        gaussian_in_frame = np.zeros((self.n, n_frames), dtype=bool)
        global_frame_mask_list: List[Tuple[int, int]] = []
        mask_gaussian_pclds: Dict[str, Set[int]] = {}

        for fi in range(n_frames):
            cached = None
            if cache_dir:
                os.makedirs(os.path.join(cache_dir, "tracker"), exist_ok=True)
                tp = os.path.join(cache_dir, "tracker",
                                  self.view_names[fi].split(".")[0] + ".npy")
                if os.path.exists(tp):
                    cached = np.load(tp, allow_pickle=True).item()
            if cached is None:
                contrib_ids, segmap = self.trace_fn(fi)
                mask_dict, frame_g = segmap_gaussians_from_tracker(
                    contrib_ids, segmap, self.args.min_gaussians_per_mask)
                if cache_dir:
                    np.save(tp, {"mask_dict": mask_dict,
                                 "frame_gaussian_ids": list(frame_g)},
                            allow_pickle=True)
            else:
                mask_dict = cached["mask_dict"]
                frame_g = set(cached["frame_gaussian_ids"])
            gaussian_in_frame[list(frame_g), fi] = True
            for mask_id, pts in mask_dict.items():
                mask_gaussian_pclds[f"{fi}_{mask_id}"] = pts
                gaussian_in_frame_maskid[list(pts), fi] = mask_id
                global_frame_mask_list.append((fi, int(mask_id)))

        m = len(global_frame_mask_list)
        gaussian_in_mask = np.zeros((self.n, m), dtype=bool)
        for mi, (fi, mask_id) in enumerate(global_frame_mask_list):
            gaussian_in_mask[list(mask_gaussian_pclds[f"{fi}_{mask_id}"]),
                             mi] = True

        mask_visible = compute_mask_visible_frames(gaussian_in_mask,
                                                   gaussian_in_frame)
        frame_mask_index = {fm: i for i, fm in
                            enumerate(global_frame_mask_list)}
        contained = np.zeros((m, m), dtype=bool)
        visible = np.zeros((m, n_frames), dtype=bool)
        under_ids = []
        for mi, (fi, mask_id) in enumerate(global_frame_mask_list):
            valid, cmask, vframe = judge_single_mask(
                gaussian_in_frame_maskid,
                mask_gaussian_pclds[f"{fi}_{mask_id}"], mask_visible[mi],
                frame_mask_index, m, n_frames, self.args)
            contained[mi] = cmask
            visible[mi] = vframe
            if not valid:
                under_ids.append(mi)
        for mi in under_ids:  # remove undersegment influence (:151-156)
            fi, _ = global_frame_mask_list[mi]
            proj = np.nonzero(contained[:, mi])[0]
            contained[:, mi] = False
            visible[proj, fi] = False

        thresholds = observer_num_thresholds(visible)
        nodes = [Node(mask_list=[global_frame_mask_list[mi]],
                      visible_frame=visible[mi].copy(),
                      contained_mask=contained[mi].copy(),
                      point_ids=mask_gaussian_pclds[
                          f"{global_frame_mask_list[mi][0]}"
                          f"_{global_frame_mask_list[mi][1]}"])
                 for mi in range(m) if mi not in set(under_ids)]
        return {"nodes": nodes, "observer_num_thresholds": thresholds,
                "mask_gaussian_pclds": mask_gaussian_pclds,
                "global_frame_mask_list": global_frame_mask_list,
                "gaussian_in_frame_matrix": gaussian_in_frame,
                "undersegment_mask_ids": under_ids}

    def maskclustering(self, save_dir: str) -> dict:
        assoc = self.construct_tracker(cache_dir=save_dir)
        assoc["nodes"] = iterative_clustering(
            assoc["nodes"], assoc["observer_num_thresholds"],
            self.args.view_consensus_threshold)

        total_point_ids, total_bboxes, total_masks = [], [], []
        for node in assoc["nodes"]:
            if len(node.mask_list) < 2:
                continue
            pid = np.array(sorted(node.point_ids))
            comps = dbscan_split(self.xyz[pid], pid, self.args.dbscan_eps,
                                 self.args.dbscan_min_points)
            for pids_f, bbox, masks in filter_points_by_detection_ratio(
                    node, comps, assoc["gaussian_in_frame_matrix"],
                    assoc["mask_gaussian_pclds"], self.args):
                total_point_ids.append(pids_f)
                total_bboxes.append(bbox)
                total_masks.append(masks)

        objs = list(zip(total_point_ids, total_bboxes, total_masks))
        objs, _ = merge_overlapping_objects(objs, self.args.merge_overlap_ratio)
        assoc["total_point_ids_list"] = [o[0] for o in objs]
        assoc["total_mask_list"] = [o[2] for o in objs]

        assoc = remedy_undersegment(assoc, self.args)
        self.export(assoc, save_dir)
        return assoc

    def export(self, assoc: dict, save_dir: str) -> None:
        """output_dict.npy contract (spatialtrack.py:51-78)."""
        os.makedirs(save_dir, exist_ok=True)
        labels = []
        for pids in assoc["total_point_ids_list"]:
            b = np.zeros(self.n, dtype=bool)
            b[np.asarray(list(pids), dtype=np.int64)] = True
            labels.append(b)
        mask_3d = (np.stack(labels, axis=1) if labels
                   else np.zeros((self.n, 0), bool))
        if assoc["undersegment_mask_ids"]:
            under = np.stack(
                [list(assoc["global_frame_mask_list"][i])
                 for i in assoc["undersegment_mask_ids"]], axis=0)
        else:
            under = []
        out = {"mask_3d_labels": mask_3d, "underseg_mask_ids": under,
               "mask_2d_clusters": assoc["total_mask_list"]}
        np.save(os.path.join(save_dir, "output_dict.npy"), out,
                allow_pickle=True)

    # --- segmap rewriting (spatialtrack.py:80-128) ---

    def rearrange_mask(self, mask_folder: str, mask_clusters) -> None:
        save_dir = os.path.join(os.path.dirname(mask_folder), "mask_sorted")
        os.makedirs(save_dir, exist_ok=True)
        origin = [_read_label_map(os.path.join(mask_folder, n + ".png"))
                  for n in self.view_names]
        new = [np.zeros_like(o, dtype=np.uint16) for o in origin]
        for cid, cluster in enumerate(mask_clusters):
            for fm in cluster:
                fi, mid = fm[:2]
                new[fi][origin[fi] == mid] = cid + 1
        for fi, n in enumerate(self.view_names):
            write_png(os.path.join(save_dir, n + ".png"), new[fi])

    def filter_undersegment_mask(self, mask_folder: str, under_masks) -> None:
        save_dir = os.path.join(os.path.dirname(mask_folder), "mask_filtered")
        under_dir = os.path.join(os.path.dirname(mask_folder),
                                 "mask_undersegment")
        os.makedirs(save_dir, exist_ok=True)
        os.makedirs(under_dir, exist_ok=True)
        origin = [_read_label_map(os.path.join(mask_folder, n + ".png"))
                  for n in self.view_names]
        new = [o.copy() for o in origin]
        under_imgs = [np.zeros_like(o, dtype=np.uint16) for o in origin]
        for fm in under_masks:
            fi, mid = int(fm[0]), int(fm[1])
            new[fi][origin[fi] == mid] = 0
            under_imgs[fi][origin[fi] == mid] = mid
        for fi, n in enumerate(self.view_names):
            write_png(os.path.join(save_dir, n + ".png"), new[fi])
            write_png(os.path.join(under_dir, n + ".png"), under_imgs[fi])
