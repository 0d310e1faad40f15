"""The port's Blender (NeRF-synthetic) reader against the JAX package's on
one small scene (4 train and 2 test RGBA PNGs of 40x30, no points3d.ply so
both readers write their random cloud), the Scene built on it by both, and
the port's training CLI on that scene on the CPU."""

import json
import os
import shutil

import numpy as np
import pytest

from instascene_tpu_torch.data.synthetic import look_at
from instascene_tpu_torch.utils.image import write_png

W, H = 40, 30


def _write_blender_scene(root, rng):
    os.makedirs(root)
    for split, n, first in (("train", 4, 0), ("test", 2, 4)):
        os.makedirs(os.path.join(root, split))
        frames = []
        for i in range(n):
            ang = 2 * np.pi * (first + i) / 6
            pos = np.array([4 * np.cos(ang), 4 * np.sin(ang), 1.0 + 0.2 * i])
            R, t = look_at(pos, np.zeros(3))
            w2c = np.eye(4)
            w2c[:3, :3], w2c[:3, 3] = R, t
            c2w = np.linalg.inv(w2c)
            c2w[:3, 1:3] *= -1                      # COLMAP → OpenGL axes
            name = f"{split}/r_{i}"
            write_png(os.path.join(root, name + ".png"),
                      rng.integers(0, 256, (H, W, 4)).astype(np.uint8))
            frames.append({"file_path": "./" + name,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two copies of one Blender scene: one for each package."""
    base = tmp_path_factory.mktemp("blender")
    jax_root = str(base / "jax" / "lego")
    port_root = str(base / "port" / "lego")
    _write_blender_scene(jax_root, np.random.default_rng(5))
    shutil.copytree(jax_root, port_root)
    return jax_root, port_root


@pytest.mark.parametrize("eval_split", [True, False])
def test_read_blender_scene_matches(scenes, eval_split):
    from instascene_tpu.data.dataset import read_blender_scene as jax_read
    from instascene_tpu_torch.data.dataset import read_blender_scene
    jax_root, port_root = scenes
    a = read_blender_scene(port_root, False, eval_split)
    b = jax_read(jax_root, False, eval_split)
    assert len(a.train_cameras) == (4 if eval_split else 6)
    for ca_list, cb_list in ((a.train_cameras, b.train_cameras),
                             (a.test_cameras, b.test_cameras)):
        assert len(ca_list) == len(cb_list)
        for ca, cb in zip(ca_list, cb_list):
            assert (ca.uid, ca.width, ca.height, ca.image_name) == (
                cb.uid, cb.width, cb.height, cb.image_name)
            assert (ca.width, ca.height) == (W, H)
            assert os.path.relpath(ca.image_path, port_root) == \
                os.path.relpath(cb.image_path, jax_root)
            for k in ("R", "T"):
                np.testing.assert_allclose(getattr(ca, k), getattr(cb, k),
                                           atol=1e-12, rtol=0)
            assert abs(ca.FovX - cb.FovX) <= 1e-12
            assert abs(ca.FovY - cb.FovY) <= 1e-12
    np.testing.assert_allclose(a.nerf_normalization["translate"],
                               b.nerf_normalization["translate"], atol=1e-12,
                               rtol=0)
    assert abs(a.nerf_normalization["radius"]
               - b.nerf_normalization["radius"]) <= 1e-12
    # both wrote numpy default_rng(0)'s 100k-point cloud, byte for byte
    assert len(a.point_cloud.points) == 100_000
    with open(a.ply_path, "rb") as fa, open(b.ply_path, "rb") as fb:
        assert fa.read() == fb.read()
    for k in ("points", "colors", "normals"):
        assert np.array_equal(getattr(a.point_cloud, k),
                              getattr(b.point_cloud, k))


def test_blender_scene_cameras_match(scenes):
    """Scene on both packages: the same cameras, RGB and alpha bands."""
    from instascene_tpu.config import ModelParams as JaxModelParams
    from instascene_tpu.data.dataset import Scene as JaxScene
    from instascene_tpu_torch.config import ModelParams
    from instascene_tpu_torch.data.dataset import Scene
    jax_root, port_root = scenes
    a = Scene(ModelParams(source_path=port_root, model_path="m", eval=True))
    b = JaxScene(JaxModelParams(source_path=jax_root, model_path="m",
                                eval=True))
    assert a.cameras_extent == pytest.approx(b.cameras_extent, abs=1e-12)
    for get in ("get_train_cameras", "get_test_cameras"):
        ca_list, cb_list = getattr(a, get)(), getattr(b, get)()
        assert len(ca_list) == len(cb_list) > 0
        for ca, cb in zip(ca_list, cb_list):
            assert ca.image.shape == (H, W, 3)
            assert np.array_equal(ca.image, cb.image)
            assert ca.gt_alpha_mask is not None
            assert np.array_equal(ca.gt_alpha_mask, cb.gt_alpha_mask)
            np.testing.assert_allclose(ca.full_proj, cb.full_proj, atol=1e-6)


def test_train_cli_on_blender_scene(scenes, tmp_path, monkeypatch):
    """Two iterations of the port's geometry CLI on the Blender scene on the
    CPU, with its cloud cut to its first 500 points (the 100k-point cloud's
    KNN alone takes minutes on the CPU), without a TensorBoard writer
    (tests/test_torch_profiling_tb.py covers it; where TensorFlow is
    installed, its import takes tens of seconds)."""
    from instascene_tpu_torch import train
    from instascene_tpu_torch.data.ply import (read_point_cloud,
                                               write_point_cloud)
    from instascene_tpu_torch.utils import tb
    monkeypatch.setattr(tb, "maybe_summary_writer", lambda log_dir: None)
    root = str(tmp_path / "nerf" / "lego")
    shutil.copytree(scenes[1], root)
    ply = os.path.join(root, "points3d.ply")
    if os.path.exists(ply):
        pts, colors, _ = read_point_cloud(ply)
    else:
        from instascene_tpu_torch.data.dataset import read_blender_scene
        cloud = read_blender_scene(root, False, True).point_cloud
        pts, colors = cloud.points, cloud.colors
    write_point_cloud(ply, pts[:500], colors[:500])
    out = str(tmp_path / "out")
    tr = train.main(["-s", root, "-m", out, "--eval", "--device", "cpu",
                     "--iterations", "2", "--test_iterations", "2",
                     "--disable_viewer", "--quiet"])
    assert tr.params.n_alive() == 500
    assert np.isfinite(tr.reports[2]["test"]["psnr"])
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_2",
                                       "point_cloud.ply"))
