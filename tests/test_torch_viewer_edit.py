"""The editing half of click-to-segment and the viewers: the port's crops
and combine, the orbit camera's pan and zoom, the engine's prompts,
convex-hull crop and delete, the dearpygui shell (driven through a stub
module), the COLMAP-camera CLI, the SIBR network viewer and the geometry
CLI's viewer wiring, each against the JAX package on the same numpy
inputs."""

import importlib.util
import inspect
import json
import os
import socket
import struct
import sys
import threading
import types
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax.numpy as jnp

W, H = 96, 64
KW = dict(max_sh_degree=3, seg_feat_dim=16, load_seg_feat=True)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_model(jp, tp):
    """Every field of a JAX GaussianParams equal to the port's model."""
    from instascene_tpu_torch.models.gaussians import FIELDS
    for k in FIELDS:
        a, b = getattr(jp, k), getattr(tp, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a),
                                          err_msg=k)
    assert (tp.active_sh_degree, tp.max_sh_degree) == (
        jp.active_sh_degree, jp.max_sh_degree)


def _to_port(jp):
    from instascene_tpu_torch.models.gaussians import FIELDS, from_numpy
    d = {k: (np.asarray(getattr(jp, k)) if getattr(jp, k) is not None
             else None) for k in FIELDS}
    d.update(active_sh_degree=jp.active_sh_degree,
             max_sh_degree=jp.max_sh_degree)
    return from_numpy(d, device="cpu")


# ------------------------------------------------------ crops and combine

@pytest.mark.parametrize("mode", ["save", "delete"])
def test_crop_mask_and_combine_match_jax(mode):
    """tests/test_model.py::test_crop_and_combine's inputs (10 of 16 slots
    alive, 4 feature channels, the first 4 selected)."""
    from instascene_tpu.models import gaussians as jg
    from instascene_tpu_torch.models import gaussians as tg
    rng = np.random.default_rng(42)
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    cols = rng.random((10, 3)).astype(np.float32)
    d2 = rng.random(10).astype(np.float32) + 0.01
    jp = jg.create_from_pcd(pts, cols, d2, capacity=16, seg_feat_dim=4)
    tp = _to_port(jp)
    mask = np.zeros(10, bool)
    mask[:4] = True
    jc, tc = jg.crop_mask(jp, mask, mode), tg.crop_mask(tp, mask, mode)
    _assert_same_model(jc, tc)
    assert tc.n_alive() == (4 if mode == "save" else 6)
    other = "delete" if mode == "save" else "save"
    jb = jg.combine(jc, jg.crop_mask(jp, mask, other))
    tb = tg.combine(tc, tg.crop_mask(tp, mask, other))
    _assert_same_model(jb, tb)
    assert tb.n_alive() == 10


@pytest.mark.parametrize("mode", ["save", "delete"])
def test_crop_pts_with_convexhull_matches_jax(mode):
    """tests/test_model.py::test_crop_pts_with_convexhull's inputs (200
    uniform points, the unit cube's corners as the hull), features
    added."""
    from instascene_tpu.models import gaussians as jg
    from instascene_tpu_torch.models import gaussians as tg
    rng = np.random.default_rng(0)
    n = 200
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    jp = jg.GaussianParams(
        xyz=jnp.asarray(xyz), features_dc=jnp.zeros((n, 1, 3)),
        features_rest=jnp.zeros((n, 15, 3)), scaling=jnp.zeros((n, 2)),
        rotation=jnp.zeros((n, 4)), opacity=jnp.zeros((n, 1)),
        alive=jnp.asarray(rng.random(n) < 0.9),
        seg_feature=jnp.asarray(rng.random((n, 8)).astype(np.float32)),
        active_sh_degree=0, max_sh_degree=3)
    tp = _to_port(jp)
    cube = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                     for z in (-1, 1)], np.float64)
    ja, jbox = jg.crop_pts_with_convexhull(jp, cube, mode=mode,
                                           return_bbox=True)
    ta, tbox = tg.crop_pts_with_convexhull(tp, cube, mode=mode,
                                           return_bbox=True)
    _assert_same_model(ja, ta)
    for a, b in zip(tbox, jbox):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert 0 < ta.n_alive() < ta.capacity


# ----------------------------------------------------------- orbit camera

def test_orbit_camera_matches_jax():
    """An orbit / zoom / pan sequence gives the same pose, centre and
    matrices."""
    from instascene_tpu.viewer.gui import OrbitCamera as JCam
    from instascene_tpu_torch.viewer.gui import OrbitCamera
    jc, tc = JCam(W, H, r=3.0), OrbitCamera(W, H, r=3.0)
    for op, args in (("orbit", (120.0, -40.0)), ("scale", (2,)),
                     ("pan", (35.0, -12.0)), ("orbit", (-30.0, 75.0)),
                     ("scale", (-3.5,)), ("pan", (-200.0, 60.0, 5.0))):
        getattr(jc, op)(*args)
        getattr(tc, op)(*args)
        np.testing.assert_allclose(tc.pose, jc.pose, atol=1e-6)
        assert tc.center.dtype == jc.center.dtype == np.float32
        np.testing.assert_allclose(tc.center, jc.center, atol=1e-6)
        assert tc.radius == pytest.approx(jc.radius, abs=1e-12)
    np.testing.assert_array_equal(tc.up, jc.up)
    jm, tm = jc.minicam(), tc.minicam()
    np.testing.assert_allclose(tm.w2v, jm.w2v, atol=1e-6)
    np.testing.assert_allclose(tm.full_proj, jm.full_proj, atol=1e-6)


# ----------------------------------------------------------------- engine

def _scene(seed, path):
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy, save_ply
    st, _ = make_bench_scene(n=1500, seed=seed, profile="trained")
    save_ply(from_numpy(st, device="cpu"), path)
    return path


@pytest.fixture(scope="module")
def plys(tmp_path_factory):
    d = tmp_path_factory.mktemp("plys")
    return _scene(1, str(d / "a.ply")), _scene(2, str(d / "b.ply"))


def _engines(ply, **kw):
    from instascene_tpu.config import PipelineParams as JPipe
    from instascene_tpu.models.gaussians import load_ply as jload
    from instascene_tpu.viewer.gui import SegmentationEngine as JEngine
    from instascene_tpu_torch.config import PipelineParams
    from instascene_tpu_torch.models.gaussians import load_ply
    from instascene_tpu_torch.viewer.gui import SegmentationEngine
    return (JEngine(jload(ply, **KW), JPipe(), **kw),
            SegmentationEngine(load_ply(ply, device="cpu", **KW),
                               PipelineParams(), **kw))


def _assert_same_prompts(te, je):
    assert len(te.chosen_features) == len(je.chosen_features)
    for a, b in zip(te.chosen_features, je.chosen_features):
        np.testing.assert_allclose(a, b, atol=5e-4)
    for a, b in zip(te.prompt_colors, je.prompt_colors):
        np.testing.assert_array_equal(a, b)


def _cam(r=4.0):
    from instascene_tpu_torch.viewer.gui import OrbitCamera
    return OrbitCamera(W, H, r=r).minicam()


def test_engine_prompts_and_load_ply_match_jax(plys):
    """click(multi=True/False), clear and load_ply leave the same prompts,
    the same projection and the same frame as the JAX engine."""
    je, te = _engines(plys[0], score_threshold=0.95)
    cam = _cam()
    for multi, xy in ((True, (48, 32)), (True, (30, 20)),
                      (False, (70, 40)), (True, (20, 50))):
        je.click(cam, *xy, multi=multi)
        te.click(cam, *xy, multi=multi)
        _assert_same_prompts(te, je)
    assert len(te.chosen_features) == 2
    je.clear()
    te.clear()
    assert te.chosen_features == [] and te.prompt_colors == []
    v = te._params_version
    je.load_ply(plys[1])
    te.load_ply(plys[1])
    assert te._params_version == v + 1
    assert te.params.device == torch.device("cpu")
    np.testing.assert_allclose(te.proj_mat, je.proj_mat, atol=1e-5)
    fa, fb = te.render_view(cam), je.render_view(cam)
    np.testing.assert_allclose(fa["rgb"], fb["rgb"], atol=3e-4)
    je.click(cam, 48, 32, multi=False)
    te.click(cam, 48, 32, multi=False)
    _assert_same_prompts(te, je)
    te.reload()      # back to b.ply, the model loaded last
    _assert_same_model(je._initial_params, te.params)
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy, save_ply
    st, _ = make_bench_scene(n=50, seed=3, profile="trained")
    nofeat = plys[1].replace("b.ply", "nofeat.ply")
    save_ply(from_numpy({**st, "seg_feature": None}, device="cpu"), nofeat)
    with pytest.raises(ValueError, match="segfeat"):
        te.load_ply(nofeat)


def _jax_convexhull(je, save_dir, seg_id, mode):
    """The JAX engine's segment_3d_convexhull with its PLY write repaired
    (the cropped model's own gaussians; see ROADMAP C)."""
    from instascene_tpu.models import gaussians as jg
    mask = je.gaussian_mask()
    pts = np.asarray(je.params.xyz)[mask]
    cropped, bbox = jg.crop_pts_with_convexhull(je.params, pts, mode="save",
                                                return_bbox=True)
    os.makedirs(save_dir, exist_ok=True)
    jg.save_ply(cropped, os.path.join(save_dir, f"segment_{seg_id}.ply"))
    np.save(os.path.join(save_dir, f"segment_{seg_id}_bbox.npy"),
            np.concatenate([bbox[0], bbox[2]]) if bbox else np.zeros(6))
    je.params = (jg.crop_pts_with_convexhull(je.params, pts, mode="delete")
                 if mode == "delete" else cropped)
    je._params_version += 1
    return np.asarray(cropped.alive)


def _same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("mode", ["save", "delete"])
def test_segment_convexhull_matches_jax(plys, tmp_path, mode):
    """Convex-hull crop of one prompt's instance: the same hull mask, a
    byte-equal PLY and box file, the same model after it and the same
    next frame. The JAX engine's own method raises on this input (its
    write indexes the compacted crop with a mask over the uncropped
    order)."""
    je, te = _engines(plys[0], score_threshold=0.95)
    cam = _cam()
    je.click(cam, 48, 32)
    te.click(cam, 48, 32)
    with pytest.raises(IndexError):
        je.segment_3d_convexhull(str(tmp_path / "jax_raises"), 0, mode)
    n_feat = int(te.gaussian_mask().sum())
    mb = _jax_convexhull(je, str(tmp_path / "j"), 3, mode)
    ma = te.segment_3d_convexhull(str(tmp_path / "t"), 3, mode)
    np.testing.assert_array_equal(ma, mb)
    assert n_feat <= ma.sum() < len(ma)
    _same_files(tmp_path / "t", tmp_path / "j",
                ("segment_3.ply", "segment_3_bbox.npy"))
    _assert_same_model(je.params, te.params)
    assert te.params.n_alive() == (ma.sum() if mode == "save"
                                   else len(ma) - ma.sum())
    assert set(te.timings) == {"copy", "score", "dbscan", "hull", "write"}
    np.testing.assert_allclose(te.render_view(cam)["rgb"],
                               je.render_view(cam)["rgb"], atol=3e-4)


def test_delete_3d_matches_jax(plys, tmp_path):
    """delete_3d: the same mask, byte-equal segment and deleted PLYs, the
    same alive set and the same next frame; reload restores the frame."""
    je, te = _engines(plys[0], score_threshold=0.95)
    cam = _cam()
    before = te.render_view(cam)["rgb"].copy()
    je.click(cam, 48, 32)
    te.click(cam, 48, 32)
    mb = je.delete_3d(str(tmp_path / "j"), 1)
    ma = te.delete_3d(str(tmp_path / "t"), 1)
    np.testing.assert_array_equal(ma, mb)
    assert ma.sum() > 0
    _same_files(tmp_path / "t", tmp_path / "j",
                ("segment_1.ply", "deleted_1.ply"))
    _assert_same_model(je.params, te.params)
    assert te.params.n_alive() == 1500 - ma.sum()
    after = te.render_view(cam)["rgb"]
    np.testing.assert_allclose(after, je.render_view(cam)["rgb"], atol=3e-4)
    assert not np.array_equal(after, before)
    te.reload()
    np.testing.assert_array_equal(te.render_view(cam)["rgb"], before)


# -------------------------------------------------- the dearpygui shell

class FakeDpg:
    """The slice of dearpygui's API that run_gui calls. Items are kept by
    tag (or by an id of their own) with their label, value and callback;
    start_dearpygui returns at once, and `fire` then plays the user's
    part, passing callbacks the arguments dearpygui would."""
    mvFormat_Float_rgb = 0
    mvMouseButton_Left = 0
    mvMouseButton_Middle = 2

    def __init__(self):
        self.items = {}
        self.handlers = []          # (kind, button, callback)
        self.mouse = (0.0, 0.0)
        self.started = False

    def _add(self, kind, tag=None, label=None, callback=None,
             default_value=None, **_):
        iid = tag if tag is not None else f"#{len(self.items)}"
        self.items[iid] = {"kind": kind, "label": label,
                           "value": default_value, "callback": callback}
        return iid

    @contextmanager
    def _scope(self, kind, **kw):
        self._add(kind, **kw)
        yield

    def texture_registry(self, **kw):
        return self._scope("texture_registry")

    def window(self, **kw):
        return self._scope("window", **kw)

    def file_dialog(self, **kw):
        return self._scope("file_dialog", **kw)

    def handler_registry(self):
        return self._scope("handler_registry")

    def add_raw_texture(self, width, height, data, format=None, tag=None):
        return self._add("texture", tag=tag, default_value=data)

    def add_image(self, texture_tag):
        return self._add("image")

    def add_text(self, text, tag=None):
        return self._add("text", tag=tag, default_value=text)

    def add_button(self, **kw):
        return self._add("button", **kw)

    def add_slider_float(self, **kw):
        return self._add("slider_float", **kw)

    def add_slider_int(self, **kw):
        return self._add("slider_int", **kw)

    def add_checkbox(self, **kw):
        return self._add("checkbox", default_value=False, **kw)

    def add_separator(self):
        return self._add("separator")

    def add_file_extension(self, ext, color=None):
        return self._add("file_extension", label=ext)

    def add_mouse_click_handler(self, callback):
        self.handlers.append(("click", None, callback))

    def add_mouse_drag_handler(self, button, callback):
        self.handlers.append(("drag", button, callback))

    def add_mouse_wheel_handler(self, callback):
        self.handlers.append(("wheel", None, callback))

    def get_value(self, iid):
        return self.items[iid]["value"]

    def set_value(self, iid, value):
        self.items[iid]["value"] = value

    def show_item(self, iid):
        self.items[iid]["shown"] = True

    def get_mouse_pos(self, local=True):
        return self.mouse

    def start_dearpygui(self):
        self.started = True

    def create_context(self): pass
    def destroy_context(self): pass
    def create_viewport(self, **kw): pass
    def setup_dearpygui(self): pass
    def show_viewport(self): pass
    def set_primary_window(self, iid, value): pass

    @staticmethod
    def _call(cb, *args):
        n = len(inspect.signature(cb).parameters)
        return cb(*args[:n])

    def fire(self, name, app_data=None):
        """Press, tick or slide the item with this tag or label."""
        iid = next(i for i, it in self.items.items()
                   if i == name or it["label"] == name)
        item = self.items[iid]
        if item["kind"] == "checkbox":
            item["value"] = not item["value"]
        elif app_data is not None:
            item["value"] = app_data
        self._call(item["callback"], iid, app_data, None)

    def mouse_event(self, kind, app_data, button=None):
        for k, b, cb in self.handlers:
            if k == kind and (button is None or b == button):
                self._call(cb, None, app_data, None)

    @property
    def texture(self):
        return np.asarray(self.items["_texture"]["value"])


@pytest.fixture
def fake_dpg(monkeypatch):
    """A fresh FakeDpg installed as dearpygui.dearpygui for each call."""
    made = []

    def install():
        dpg = FakeDpg()
        pkg = types.ModuleType("dearpygui")
        pkg.dearpygui = dpg
        monkeypatch.setitem(sys.modules, "dearpygui", pkg)
        monkeypatch.setitem(sys.modules, "dearpygui.dearpygui", dpg)
        made.append(dpg)
        return dpg
    return install


def test_run_gui_without_dearpygui_raises(plys, monkeypatch):
    from instascene_tpu_torch.viewer.gui import run_gui
    monkeypatch.setitem(sys.modules, "dearpygui", None)
    _, te = _engines(plys[0])
    with pytest.raises(RuntimeError, match="dearpygui is not installed"):
        run_gui(te, W, H)


def test_run_gui_matches_jax(plys, tmp_path, monkeypatch, fake_dpg):
    """The same widgets, and the same events (orbit drag, wheel, pan, the
    render-option cycle, click mode, right clicks, delete, reload,
    segment) set equal textures (atol 3e-3, the aux frames' tolerance)
    and write byte-equal PLYs."""
    from instascene_tpu.viewer.gui import RENDER_MODES as JMODES
    from instascene_tpu.viewer.gui import run_gui as jrun
    from instascene_tpu_torch.viewer.gui import RENDER_MODES, run_gui
    assert RENDER_MODES == JMODES
    je, te = _engines(plys[0], score_threshold=0.95)
    sides = []
    for name, run, eng in (("j", jrun, je), ("t", run_gui, te)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        dpg = fake_dpg()
        run(eng, W, H)
        assert dpg.started
        sides.append((d, dpg))
    (jd, jdpg), (td, tdpg) = sides
    assert ({i: (it["kind"], it["label"]) for i, it in tdpg.items.items()}
            == {i: (it["kind"], it["label"]) for i, it in jdpg.items.items()})
    assert [(k, b) for k, b, _ in tdpg.handlers] == [
        (k, b) for k, b, _ in jdpg.handlers]

    events = [
        ("mouse", "wheel", -5, None), ("mouse", "drag", (0, 150.0, -40.0),
                                      FakeDpg.mvMouseButton_Left),
        ("mouse", "drag", (2, 6.0, -3.0), FakeDpg.mvMouseButton_Middle),
        *[("fire", "_button_mode", None, None)] * 5,   # through every mode
        ("fire", "Click Mode", None, None), ("pos", (48.0, 32.0)),
        ("mouse", "click", 1, None), ("fire", "multi-clickmode", None, None),
        ("pos", (30.0, 20.0)), ("mouse", "click", 1, None),
        ("fire", "_ScoreThres", 0.93, None), ("fire", "delete_3d", None, None),
        ("fire", "reload_data", None, None),
        ("fire", "segment_3d", None, None),
        ("fire", "clear_edit", None, None)]
    for ev in events:
        for d, dpg in sides:
            monkeypatch.chdir(d)
            if ev[0] == "mouse":
                dpg.mouse_event(ev[1], ev[2], ev[3])
            elif ev[0] == "fire":
                dpg.fire(ev[1], ev[2])
            else:
                dpg.mouse = ev[1]
        np.testing.assert_allclose(tdpg.texture, jdpg.texture, atol=3e-3,
                                   err_msg=str(ev))
    assert tdpg.get_value("_pos_item") == jdpg.get_value("_pos_item")
    assert tdpg.get_value("_mode_label") == "rgb"
    assert te.chosen_features == [] == je.chosen_features
    out = os.path.join("interactive_segmentation", "default")
    names = ("segment_0.ply", "deleted_0.ply", "segment_1.ply",
             "segment_1_mask.npy")
    _same_files(td / out, jd / out, names)
    _assert_same_model(je.params, te.params)


# ------------------------------------------------- COLMAP cameras (CLI)

@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The e2e COLMAP scene and a segfeat PLY of its gaussians: one unit
    feature per blob, with a little noise."""
    from scene_builder import build_e2e_scene
    from instascene_tpu.models.gaussians import save_ply as jsave
    d = tmp_path_factory.mktemp("colmap") / "parent" / "scene"
    params, labels, _ = build_e2e_scene(str(d))
    rng = np.random.default_rng(5)
    feat = np.eye(16, dtype=np.float32)[labels] + rng.normal(
        0, 0.05, (len(labels), 16)).astype(np.float32)
    ply = str(d / "segfeat.ply")
    jsave(params.replace(seg_feature=jnp.asarray(feat)), ply)
    return str(d), labels, feat, ply


def _root_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_semantic_gui_colmap_camera_matches_jax(e2e, tmp_path, monkeypatch):
    """--use_colmap_camera --headless: the first training camera's click
    saves the JAX CLI's mask and segment PLY."""
    from instascene_tpu_torch import semantic_gui
    src, labels, _, ply = e2e
    monkeypatch.chdir(tmp_path)
    args = ["-p", ply, "-s", src, "--use_colmap_camera", "--headless",
            "--click", "32,24", "--score_threshold", "0.9"]
    _root_cli("semantic_gui").main(args + ["--out_dir", "j"])
    semantic_gui.main(args + ["--out_dir", "t", "--device", "cpu"])
    mj = np.load(tmp_path / "j" / "default" / "segment_0_mask.npy")
    mt = np.load(tmp_path / "t" / "default" / "segment_0_mask.npy")
    np.testing.assert_array_equal(mt, mj)
    assert mt.sum() > 10
    assert len(np.unique(labels[mt])) == 1
    _same_files(tmp_path / "t" / "default", tmp_path / "j" / "default",
                ("segment_0.ply",))
    with pytest.raises(SystemExit, match="source_path"):
        semantic_gui.main(["-p", ply, "--use_colmap_camera", "--headless",
                           "--device", "cpu"])


def test_semantic_gui_window_through_stub(e2e, tmp_path, monkeypatch,
                                          fake_dpg):
    """Without --headless the CLI opens run_gui with the COLMAP cameras:
    the camera slider browses them."""
    from instascene_tpu_torch import semantic_gui
    from instascene_tpu_torch.render import render
    src, _, _, ply = e2e
    monkeypatch.chdir(tmp_path)
    dpg = fake_dpg()
    eng = semantic_gui.main(["-p", ply, "-s", src, "--use_colmap_camera",
                             "--device", "cpu", "--width", "64",
                             "--height", "48"])
    assert dpg.started and dpg.get_value("_colmap_idx") == 0
    dpg.fire("Use Colmap Camera")
    dpg.fire("_colmap_idx", 3)
    from instascene_tpu_torch.config import ModelParams
    from instascene_tpu_torch.data.dataset import Scene
    cam = Scene(ModelParams(source_path=src),
                load_images=False).get_train_cameras()[3]
    want = render(cam, eng.params, eng.pipe, eng.bg_color,
                  viewer=True)["render"].numpy()
    np.testing.assert_array_equal(
        dpg.texture.reshape(48, 64, 3), np.clip(want, 0, 1))


# ------------------------------------------------------ network viewer

def _viewer_round(gui, tick, msg):
    """A viewer thread connects, takes the render items, sends `msg` and
    reads the reply while `tick` serves it. Returns (render items, image
    bytes, source path, metrics)."""
    from instascene_tpu_torch.viewer.network_gui import recv_exact
    port = gui.listener.getsockname()[1]
    out, connected = {}, threading.Event()

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
            connected.set()
            n = struct.unpack("I", recv_exact(s, 4))[0]
            out["items"] = json.loads(recv_exact(s, n))
            payload = json.dumps(msg).encode()
            s.sendall(len(payload).to_bytes(4, "little") + payload)
            out["image"] = recv_exact(
                s, 3 * msg["resolution_x"] * msg["resolution_y"])
            n = int.from_bytes(recv_exact(s, 4), "little")
            out["verify"] = recv_exact(s, n).decode()
            n = struct.unpack("I", recv_exact(s, 4))[0]
            out["metrics"] = json.loads(recv_exact(s, n))

    th = threading.Thread(target=client, daemon=True)
    th.start()
    assert connected.wait(60)
    tick()
    th.join(120)
    assert not th.is_alive()
    return out["items"], out["image"], out["verify"], out["metrics"]


def test_network_gui_protocol():
    """tests/test_misc.py::test_network_gui_protocol's exchange against the
    port: the render items, then a zero resolution gives five Nones."""
    from instascene_tpu_torch.viewer.network_gui import NetworkGUI
    gui = NetworkGUI("127.0.0.1", 0)
    try:
        port = gui.listener.getsockname()[1]
        client = socket.create_connection(("127.0.0.1", port))
        gui.try_connect(["RGB"])
        assert gui.conn is not None
        n = struct.unpack("I", client.recv(4))[0]
        assert json.loads(client.recv(n)) == ["RGB"]
        msg = json.dumps({"resolution_x": 0, "resolution_y": 0}).encode()
        client.sendall(len(msg).to_bytes(4, "little") + msg)
        assert gui.receive() == (None, None, None, None, None)
        client.close()
    finally:
        gui.close()


def test_network_gui_tick_matches_jax(plys):
    """One camera round through tick: the image bytes within 1 LSB of the
    JAX viewer's, the same source path and metrics; the camera message
    decodes to the camera sent, bit for bit."""
    from instascene_tpu.config import ModelParams as JModel
    from instascene_tpu.config import PipelineParams as JPipe
    from instascene_tpu.models.gaussians import load_ply as jload
    from instascene_tpu.viewer.network_gui import NetworkGUI as JGUI
    from instascene_tpu_torch.config import ModelParams, PipelineParams
    from instascene_tpu_torch.models.gaussians import load_ply
    from instascene_tpu_torch.viewer.gui import OrbitCamera
    from instascene_tpu_torch.viewer.network_gui import (NetworkGUI,
                                                         camera_from_message,
                                                         camera_message)
    orbit = OrbitCamera(W, H, r=4.0)
    orbit.orbit(60.0, 20.0)
    cam = orbit.minicam()
    msg = json.loads(json.dumps(camera_message(cam)))
    back = camera_from_message(msg)
    for k in ("w2v", "full_proj", "camera_center"):
        np.testing.assert_array_equal(getattr(back, k), getattr(cam, k))
    assert (back.width, back.height, back.fovx, back.fovy) == (
        cam.width, cam.height, cam.fovx, cam.fovy)
    ema = {"loss": 0.125}
    results = []
    for gcls, params, bg, pipe, ds in (
            (JGUI, jload(plys[0], **KW), jnp.zeros(3), JPipe(),
             JModel(source_path="/scene/a")),
            (NetworkGUI, load_ply(plys[0], device="cpu", **KW),
             torch.zeros(3), PipelineParams(),
             ModelParams(source_path="/scene/a"))):
        trainer = types.SimpleNamespace(params=params, bg=bg, ema=ema)
        gui = gcls("127.0.0.1", 0)
        try:
            results.append(_viewer_round(
                gui, lambda: gui.tick(trainer, pipe, ds), msg))
        finally:
            gui.listener.close()
            if gui.conn is not None:
                gui.conn.close()
    (ji, jimg, jv, jm), (ti, timg, tv, tm) = results
    assert ti == ji == ModelParams().render_items
    assert (tv, tm) == (jv, jm) == ("/scene/a", {"#": 1500, "loss": 0.125})
    a = np.frombuffer(timg, np.uint8).astype(int)
    b = np.frombuffer(jimg, np.uint8).astype(int)
    assert np.abs(a - b).max() <= 1
    assert a.max() > 0


@pytest.fixture(scope="module")
def geo_scene(tmp_path_factory):
    from scene_builder import build_e2e_scene
    d = tmp_path_factory.mktemp("geo") / "parent" / "scene"
    build_e2e_scene(str(d), with_segmaps=False)
    return str(d)


@pytest.mark.parametrize("port", ["free", "taken"])
def test_train_cli_serves_the_viewer(geo_scene, tmp_path, monkeypatch,
                                     port):
    """Without --disable_viewer the geometry CLI binds the viewer and ticks
    it once per iteration; on an address already in use it trains
    without it, as the root CLI does."""
    from instascene_tpu_torch import train
    from instascene_tpu_torch.viewer import network_gui
    monkeypatch.chdir(tmp_path)
    ticks, bound = [], []
    orig_init, orig_tick = (network_gui.NetworkGUI.__init__,
                            network_gui.NetworkGUI.tick)

    def init(self, host, p):
        orig_init(self, host, p)
        bound.append(self.listener.getsockname())

    def tick(self, trainer, pipe, dataset):
        ticks.append(trainer.params.n_alive())
        return orig_tick(self, trainer, pipe, dataset)

    monkeypatch.setattr(network_gui.NetworkGUI, "__init__", init)
    monkeypatch.setattr(network_gui.NetworkGUI, "tick", tick)
    taken = socket.socket()
    try:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        p = taken.getsockname()[1] if port == "taken" else 0
        tr = train.main(["-s", geo_scene, "--device", "cpu", "--quiet",
                         "--iterations", "3", "--test_iterations", "100",
                         "--ip", "127.0.0.1", "--port", str(p)])
    finally:
        taken.close()
    assert tr.opt_state.count == 3
    if port == "free":
        assert len(bound) == 1 and bound[0][0] == "127.0.0.1"
        assert len(ticks) == 3
    else:
        assert bound == [] and ticks == []
