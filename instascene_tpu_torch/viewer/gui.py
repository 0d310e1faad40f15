"""Interactive instance segmentation: the click-to-segment engine and its
dearpygui window.

Port of instascene_tpu/viewer/gui.py (`OrbitCamera`, `SegmentationEngine`,
`compose_frame`, `RENDER_MODES`, `run_gui`). The engine is headless and
scriptable: orbit, pan and zoom the camera, click prompts (one or many),
clear them, segment, crop by the convex hull, delete, reload, load another
PLY. `run_gui` wires the same engine to a dearpygui window; dearpygui is
imported when the window opens, and its absence raises.

What differs from the JAX package:
  * the JAX engine filters the selected gaussians with sklearn's DBSCAN;
    this port uses its own (semantic/cluster.py::dbscan, on scipy, with
    sklearn's semantics), since the GPU machine has no sklearn;
  * `segment_3d_convexhull` saves the cropped model's gaussians. The JAX
    engine passes the cropped model's `alive` (over the order before the
    crop) as the crop mask of its already compacted copy, which raises an
    IndexError whenever the hull leaves out an alive gaussian (ROADMAP C);
  * `timings` holds the host seconds of the last selection's stages
    (score, DBSCAN, the hull crop, write) and of the last rendered
    frame's copies to the host ("copy", in the span of that name), and
    `d2h_bytes` counts every byte render_view has copied to the host.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..cameras import MiniCam, get_projection_matrix
from ..models import gaussians as gmod
from ..semantic.cluster import dbscan
from ..semantic.export import pca_proj_matrix
from ..utils.profiling import span


class OrbitCamera:
    """Orbit camera around a center point."""

    def __init__(self, width, height, r=2.0, fovy=60.0):
        self.W = width
        self.H = height
        self.radius = r
        self.fovy = np.deg2rad(fovy)
        self.center = np.zeros(3, dtype=np.float32)
        from scipy.spatial.transform import Rotation
        self.rot = Rotation.from_matrix(np.eye(3))
        self.up = np.array([0, 1, 0], dtype=np.float32)

    @property
    def fovx(self):
        return 2 * np.arctan(np.tan(self.fovy / 2) * self.W / self.H)

    @property
    def pose(self):
        """c2w, COLMAP convention (z forward): camera at center − R·(0,0,r),
        looking at the orbit center."""
        res = np.eye(4, dtype=np.float32)
        res[:3, :3] = self.rot.as_matrix()
        res[:3, 3] = self.center - res[:3, :3] @ np.array(
            [0, 0, self.radius], dtype=np.float32)
        return res

    def orbit(self, dx, dy):
        from scipy.spatial.transform import Rotation
        side = self.rot.as_matrix()[:3, 0]
        up = self.rot.as_matrix()[:3, 1]
        rotvec_x = up * np.radians(-0.05 * dx)
        rotvec_y = side * np.radians(-0.05 * dy)
        self.rot = (Rotation.from_rotvec(rotvec_x)
                    * Rotation.from_rotvec(rotvec_y) * self.rot)

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0):
        """Move the orbit centre along the camera's axes (in place, float32
        centre)."""
        self.center += 2e-4 * self.rot.as_matrix()[:3, :3] @ np.array(
            [dx, dy, dz], dtype=np.float32)

    def minicam(self, znear=0.01, zfar=100.0) -> MiniCam:
        c2w = self.pose
        w2v = np.linalg.inv(c2w).astype(np.float32)
        proj = get_projection_matrix(znear, zfar, self.fovx, self.fovy)
        return MiniCam(self.W, self.H, self.fovy, self.fovx, znear, zfar,
                       w2v=w2v, full_proj=(proj @ w2v).astype(np.float32))


@dataclass
class SegmentationEngine:
    """Headless click-to-segment engine on one device (the params')."""
    params: gmod.GaussianModel
    pipe: object
    bg_color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    score_threshold: float = 0.7
    dbscan_eps: float = 0.15
    dbscan_min_points: int = 10

    def __post_init__(self):
        self.proj_mat = pca_proj_matrix(
            self.params.seg_feature.detach().cpu().numpy())
        self.chosen_features: List[np.ndarray] = []
        self.prompt_colors: List[np.ndarray] = []
        self._frame_key = None
        self._frame = None
        self._params_version = 0
        self._initial_params = self.params
        self._color_rng = np.random.default_rng(0)
        self.timings = {}
        # bytes render_view has copied to the host; a cached frame adds 0
        self.d2h_bytes = 0

    def reload(self) -> None:
        """Restore the model loaded at startup."""
        self.params = self._initial_params
        self._params_version += 1

    def load_ply(self, ply_path: str, seg_feat_dim: int = 16) -> None:
        """Swap in another PLY on the same device: recompute the feature
        PCA projection, clear the prompts, re-render on the next frame."""
        self.params = gmod.load_ply(ply_path, max_sh_degree=3,
                                    seg_feat_dim=seg_feat_dim,
                                    load_seg_feat=True,
                                    device=self.params.device)
        if self.params.seg_feature is None:
            raise ValueError(f"{ply_path} has no segfeat_* attributes")
        self._initial_params = self.params
        self.proj_mat = pca_proj_matrix(
            self.params.seg_feature.detach().cpu().numpy())
        self.clear()
        self._params_version += 1

    @torch.no_grad()
    def render_view(self, cam, need_aux: bool = False):
        """rgb + feature maps for `cam` (numpy), plus depth/normal/alpha
        maps when `need_aux` (full blend instead of the viewer fast path).
        Re-renders only when the pose, the gaussian set or the aux
        requirement changed; a re-render's copies to the host go to
        timings["copy"] and d2h_bytes, a cached frame's to neither."""
        key = (np.asarray(cam.w2v, np.float32).tobytes(),
               self._params_version, bool(need_aux))
        if self._frame_key == key:
            return self._frame
        from ..render import render
        pkg = render(cam, self.params, self.pipe, self.bg_color,
                     viewer=not need_aux)
        feat = gmod.normalize_features(pkg["seg_feature"])
        proj = torch.as_tensor(self.proj_mat, device=feat.device)
        feat_rgb = torch.clamp(feat @ proj * 0.5 + 0.5, 0, 1)
        # the frame's kernels finish first, so "copy" holds the copies alone
        if feat.is_cuda:
            torch.cuda.synchronize(feat.device)
        with span("copy"):
            t0 = time.perf_counter()
            frame = {"rgb": pkg["render"].cpu().numpy(),
                     "feat": feat.cpu().numpy(),
                     "feat_rgb": feat_rgb.cpu().numpy()}
            if need_aux:
                frame["depth"] = pkg["surf_depth"][..., 0].cpu().numpy()
                frame["normal"] = pkg["rend_normal"].cpu().numpy()
                frame["alpha"] = pkg["rend_alpha"][..., 0].cpu().numpy()
            self.timings["copy"] = time.perf_counter() - t0
        self.d2h_bytes += sum(a.nbytes for a in frame.values())
        self._frame_key, self._frame = key, frame
        return frame

    def click(self, cam, x: int, y: int, multi: bool = True) -> None:
        """Add a feature prompt at pixel (x, y); with multi=False the new
        prompt replaces the existing ones."""
        if not multi:
            self.clear()
        feat = self.render_view(cam)["feat"]
        h, w = feat.shape[:2]
        self.chosen_features.append(feat[int(y) % h, int(x) % w])
        self.prompt_colors.append(
            self._color_rng.random(3).astype(np.float32) * 0.7 + 0.3)

    def clear(self) -> None:
        self.chosen_features = []
        self.prompt_colors = []

    def score_map(self, feat: np.ndarray) -> np.ndarray:
        """[H,W,P] scores in [0,1] per prompt."""
        prompts = np.stack(self.chosen_features, axis=-1)
        return (feat @ prompts + 1.0) / 2.0

    def gaussian_mask(self) -> np.ndarray:
        """3D mask: gaussians whose feature matches any prompt, filtered to
        the largest DBSCAN group (noise counts as a group, as in the JAX
        engine). Its stages' host seconds go to `timings`: "score" (the
        features' copy to the host and the prompt scores), "dbscan"."""
        t0 = time.perf_counter()
        feats = self.params.seg_feature_normed().detach().cpu().numpy()
        prompts = np.stack(self.chosen_features, axis=-1)
        score = (feats @ prompts + 1.0) / 2.0
        mask = (score > self.score_threshold).sum(axis=1) > 0
        mask = mask & self.params.alive.cpu().numpy()
        t1 = time.perf_counter()
        self.timings.update(score=t1 - t0, dbscan=0.0)
        if mask.sum() == 0:
            return mask
        pts = self.params.xyz.detach().cpu().numpy()[mask]
        labels = dbscan(pts, self.dbscan_eps, self.dbscan_min_points) + 1
        ids, cnts = np.unique(labels, return_counts=True)
        best = ids[np.argmax(cnts)]
        keep_idx = np.nonzero(mask)[0][labels == best]
        out = np.zeros_like(mask)
        out[keep_idx] = True
        self.timings["dbscan"] = time.perf_counter() - t1
        return out

    def _set_params(self, params: gmod.GaussianModel) -> None:
        self.params = params
        self._params_version += 1

    def _keep(self, mask: np.ndarray) -> gmod.GaussianModel:
        """The model with `alive` and-ed with `mask` (over capacity)."""
        return self.params.replace(alive=self.params.alive & torch.as_tensor(
            mask, device=self.params.device))

    def segment_3d(self, save_dir: str, seg_id: int = 0):
        """Crop to the selected instance and save its PLY + mask."""
        mask = self.gaussian_mask()
        t0 = time.perf_counter()
        alive = self.params.alive.cpu().numpy()
        os.makedirs(save_dir, exist_ok=True)
        gmod.save_ply(self.params, os.path.join(save_dir,
                                                f"segment_{seg_id}.ply"),
                      crop_mask=mask[alive])
        np.save(os.path.join(save_dir, f"segment_{seg_id}_mask.npy"), mask)
        self.timings["write"] = time.perf_counter() - t0
        self._set_params(self._keep(mask))
        return mask

    def segment_3d_convexhull(self, save_dir: str, seg_id: int = 0,
                              mode: str = "save"):
        """Crop by the convex hull of the feature-selected gaussians, which
        takes in interior gaussians the feature threshold missed: save the
        instance's PLY and its box (center, extent). The engine then holds
        the compacted crop (mode='save') or the compacted rest
        (mode='delete'). Returns the hull's mask over compacted order."""
        mask = self.gaussian_mask()
        pts = self.params.xyz.detach().cpu().numpy()[mask]
        if len(pts) < 4:   # Delaunay needs a non-degenerate 3D set
            return self.segment_3d(save_dir, seg_id)
        t0 = time.perf_counter()
        cropped, bbox = gmod.crop_pts_with_convexhull(
            self.params, pts, mode="save", return_bbox=True)
        t1 = time.perf_counter()
        os.makedirs(save_dir, exist_ok=True)
        gmod.save_ply(cropped, os.path.join(save_dir,
                                            f"segment_{seg_id}.ply"))
        np.save(os.path.join(save_dir, f"segment_{seg_id}_bbox.npy"),
                np.concatenate([bbox[0], bbox[2]]) if bbox else np.zeros(6))
        self.timings.update(hull=t1 - t0, write=time.perf_counter() - t1)
        inside = cropped.alive.cpu().numpy()
        self._set_params(gmod.crop_mask(self.params, inside, mode="delete")
                         if mode == "delete" else cropped)
        return inside

    def delete_3d(self, save_dir: str, seg_id: int = 0):
        """Save the selected instance's PLY, drop it from the engine's
        model and save what is left as deleted_<id>.ply."""
        mask = self.gaussian_mask()
        alive = self.params.alive.cpu().numpy()
        os.makedirs(save_dir, exist_ok=True)
        gmod.save_ply(self.params, os.path.join(save_dir,
                                                f"segment_{seg_id}.ply"),
                      crop_mask=mask[alive])
        self._set_params(self._keep(~mask))
        gmod.save_ply(self.params, os.path.join(save_dir,
                                                f"deleted_{seg_id}.ply"))
        return mask


def compose_frame(engine: SegmentationEngine, frame: dict, mode: str
                  ) -> np.ndarray:
    """Display buffer for one render mode; in rgb mode each prompt's
    thresholded region is tinted with that prompt's color."""
    if mode == "rgb":
        rgb = frame["rgb"]
        if engine.chosen_features:
            score = engine.score_map(frame["feat"])
            binary = score > engine.score_threshold
            out = rgb.copy()
            for k, color in enumerate(engine.prompt_colors):
                m = binary[..., k]
                out[m] = rgb[m] * 0.3 + color * 0.7
            return np.clip(out, 0, 1)
        return np.clip(rgb, 0, 1)
    if mode == "feature":
        return np.clip(frame["feat_rgb"] * 0.7 + 0.3, 0, 1)
    if mode == "depth":
        d = frame["depth"]
        dmax = float(d.max())
        g = d / dmax if dmax > 0 else d
        return np.repeat(g[..., None], 3, axis=-1).astype(np.float32)
    if mode == "normal":
        return np.clip(frame["normal"] * 0.5 + 0.5, 0, 1)
    if mode == "alpha":
        return np.repeat(np.clip(frame["alpha"], 0, 1)[..., None], 3,
                         axis=-1).astype(np.float32)
    raise ValueError(mode)


RENDER_MODES = ("rgb", "feature", "depth", "normal", "alpha")


def run_gui(engine: SegmentationEngine, width=800, height=600,
            interactive_note: str = "default", train_cameras=None):
    """The dearpygui window over `engine`: render-option cycle (rgb/
    feature/depth/normal/alpha), score-threshold slider, click-mode and
    multi-clickmode checkboxes, clear/segment/delete/reload buttons,
    COLMAP-camera browsing (when `train_cameras` is given), a PLY file
    dialog; left-drag orbits, middle-drag pans, the wheel zooms, a right
    click adds a prompt (in click mode). Segments and deletions are saved
    under interactive_segmentation/<interactive_note>."""
    try:
        import dearpygui.dearpygui as dpg
    except ImportError as e:
        raise RuntimeError(
            "dearpygui is not installed; use SegmentationEngine headlessly "
            "(render_view/click/segment_3d) or install dearpygui") from e

    cam = OrbitCamera(width, height, r=2.0)
    state = {"mode": 0, "seg_id": 0, "clickmode": False, "multi": False,
             "use_colmap": False}

    dpg.create_context()
    with dpg.texture_registry(show=False):
        dpg.add_raw_texture(width, height,
                            np.zeros((height, width, 3), np.float32),
                            format=dpg.mvFormat_Float_rgb, tag="_texture")

    def current_cam():
        if state["use_colmap"] and train_cameras:
            idx = int(dpg.get_value("_colmap_idx")) % len(train_cameras)
            return train_cameras[idx]
        return cam.minicam()

    def refresh():
        mode = RENDER_MODES[state["mode"]]
        frame = engine.render_view(current_cam(),
                                   need_aux=mode in ("depth", "normal",
                                                     "alpha"))
        buf = compose_frame(engine, frame, mode)
        dpg.set_value("_texture", buf.astype(np.float32).reshape(-1))

    out_dir = f"interactive_segmentation/{interactive_note}"

    def do_segment():
        engine.segment_3d(out_dir, state["seg_id"])
        state["seg_id"] += 1
        refresh()

    def do_delete():
        engine.delete_3d(out_dir, state["seg_id"])
        state["seg_id"] += 1
        refresh()

    def do_reload():
        engine.reload()
        refresh()

    def next_mode():
        state["mode"] = (state["mode"] + 1) % len(RENDER_MODES)
        dpg.set_value("_mode_label", RENDER_MODES[state["mode"]])
        refresh()

    def set_threshold(sender, value):
        engine.score_threshold = value
        refresh()

    def toggle_colmap():
        state["use_colmap"] = not state["use_colmap"]
        refresh()

    def file_callback(sender, app_data):
        files = list(app_data.get("selections", {}).values())
        if files:
            engine.load_ply(files[0])
            refresh()

    with dpg.window(tag="_primary", width=width, height=height):
        dpg.add_image("_texture")

    with dpg.window(label="Control", tag="_control", width=400, height=520,
                    pos=[width + 10, 0]):
        dpg.add_text("Mouse position: click anywhere to start.",
                     tag="_pos_item")
        dpg.add_button(label="Render Option", tag="_button_mode",
                       callback=next_mode)
        dpg.add_text("rgb", tag="_mode_label")
        dpg.add_slider_float(label="Score Threshold",
                             default_value=engine.score_threshold,
                             min_value=0.0, max_value=1.0, tag="_ScoreThres",
                             callback=set_threshold)
        dpg.add_checkbox(label="Click Mode", callback=lambda s: state.update(
            clickmode=not state["clickmode"]))
        dpg.add_checkbox(label="multi-clickmode",
                         callback=lambda s: state.update(
                             multi=dpg.get_value(s)))
        dpg.add_separator()
        dpg.add_button(label="clear_edit",
                       callback=lambda: (engine.clear(), refresh()))
        dpg.add_button(label="segment_3d", callback=do_segment)
        dpg.add_button(label="delete_3d", callback=do_delete)
        dpg.add_button(label="reload_data", callback=do_reload)
        if train_cameras:
            dpg.add_separator()
            dpg.add_button(label="Use Colmap Camera", callback=toggle_colmap)
            dpg.add_slider_int(label="Colmap Camera Idx", default_value=0,
                               max_value=len(train_cameras) - 1,
                               tag="_colmap_idx",
                               callback=lambda s, v: refresh())
        with dpg.file_dialog(directory_selector=False, show=False,
                             callback=file_callback, tag="_file_dialog",
                             width=700, height=400):
            dpg.add_file_extension(".*")
            dpg.add_file_extension("Ply files (*.ply){.ply}",
                                   color=(0, 255, 255, 255))
        dpg.add_button(label="Load .ply File",
                       callback=lambda: dpg.show_item("_file_dialog"))

    def on_click(sender, app_data):
        xy = dpg.get_mouse_pos(local=False)
        dpg.set_value("_pos_item", f"Mouse position = ({xy[0]}, {xy[1]})")
        if state["clickmode"] and app_data == 1:     # right click prompts
            engine.click(current_cam(), int(xy[0]), int(xy[1]),
                         multi=state["multi"])
            refresh()

    def on_drag(sender, app_data):
        _, dx, dy = app_data
        cam.orbit(dx, dy)
        refresh()

    def on_pan(sender, app_data):
        _, dx, dy = app_data
        cam.pan(dx * 20, dy * 20)
        refresh()

    def on_wheel(sender, app_data):
        cam.scale(app_data)
        refresh()

    with dpg.handler_registry():
        dpg.add_mouse_click_handler(callback=on_click)
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                   callback=on_drag)
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Middle,
                                   callback=on_pan)
        dpg.add_mouse_wheel_handler(callback=on_wheel)

    dpg.create_viewport(title="instascene-tpu", width=width + 440,
                        height=height + 100)
    dpg.setup_dearpygui()
    refresh()
    dpg.show_viewport()
    dpg.set_primary_window("_primary", True)
    dpg.start_dearpygui()
    dpg.destroy_context()
