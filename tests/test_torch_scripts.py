"""The port's scripts against the JAX package's scripts/ on the CPU:
align_coords (the rotated PLY and COLMAP model, and the port's render of the
rotated scene from the rotated camera), generate_masks --from_dir (the
written label PNGs), and eval_scene (its results keys, its train PSNR
against a trainer stepped alike, its mIoU against the JAX metric)."""

import os
import shutil

import numpy as np
import pytest
import torch

from scene_builder import build_e2e_scene


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """tests/scene_builder's standard scene at 64x48 and its labels."""
    base = tmp_path_factory.mktemp("scripts")
    src = str(base / "parent" / "scene")
    _, labels, _ = build_e2e_scene(src, width=64, height=48)
    np.save(str(base / "labels.npy"), labels)
    return src, str(base / "labels.npy")


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


# ---------------------------------------------------------- align_coords

R_DEG = (25.0, -40.0, 65.0)


def _rotation():
    from instascene_tpu_torch.utils.sh_rotation import euler_deg_to_rotmat
    R = euler_deg_to_rotmat(R_DEG)
    R4 = np.eye(4)
    R4[:3, :3] = R
    return R, R4


def _blob_ply(path, seg):
    """The blobs of tests/scene_builder with view-dependent colour (and
    16 seg features), written by the port."""
    from scene_builder import make_blob_gaussians
    from instascene_tpu_torch.models.gaussians import from_numpy, save_ply
    params, _ = make_blob_gaussians()
    rng = np.random.default_rng(3)
    n = int(params.xyz.shape[0])
    st = {k: np.asarray(getattr(params, k)) for k in (
        "xyz", "features_dc", "scaling", "rotation", "opacity", "alive")}
    st.update(features_rest=(rng.normal(size=(n, 15, 3)) * 0.3).astype(
        np.float32), seg_feature=(rng.random((n, 16)).astype(np.float32)
                                  if seg else None),
        active_sh_degree=3, max_sh_degree=3)
    save_ply(from_numpy(st, "cpu"), path)


@pytest.mark.parametrize("seg", [True, False])
def test_rotate_gaussians_matches(tmp_path, seg):
    from scripts.align_coords import rotate_gaussians as jax_rotate
    from instascene_tpu_torch.data.ply import read_ply
    from instascene_tpu_torch.scripts.align_coords import rotate_gaussians
    R, _ = _rotation()
    a, b = str(tmp_path / "a" / "m.ply"), str(tmp_path / "b" / "m.ply")
    _blob_ply(a, seg)
    os.makedirs(os.path.dirname(b))
    shutil.copy(a, b)
    out_a, out_b = rotate_gaussians(a, R), jax_rotate(b, R)
    assert out_a.endswith("m_align.ply")
    va, vb = read_ply(out_a)["vertex"], read_ply(out_b)["vertex"]
    assert va.dtype.names == vb.dtype.names
    assert any(n.startswith("segfeat") for n in va.dtype.names) == seg
    for name in va.dtype.names:
        np.testing.assert_allclose(va[name], vb[name], atol=1e-6, rtol=0,
                                   err_msg=name)


def test_rotate_colmap_matches(e2e, tmp_path):
    """The aligned model equals JAX's and holds c2w' = R4 @ c2w, x' = R x
    (tests/test_data_layer.py:442-460)."""
    from scripts.align_coords import rotate_colmap as jax_rotate_colmap
    from instascene_tpu_torch.data.colmap import (qvec2rotmat,
                                                  read_images_binary,
                                                  read_points3D_binary)
    from instascene_tpu_torch.scripts.align_coords import rotate_colmap
    _, R4 = _rotation()
    a = _copy(e2e[0], str(tmp_path / "a"))
    b = _copy(e2e[0], str(tmp_path / "b"))
    out_a, out_b = rotate_colmap(a, R4), jax_rotate_colmap(b, R4)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out_a, name), "rb") as fa, \
                open(os.path.join(out_b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    sparse = os.path.join(a, "sparse", "0")
    ims0 = read_images_binary(os.path.join(sparse, "images.bin"))
    ims1 = read_images_binary(os.path.join(out_a, "images.bin"))
    xyz0 = read_points3D_binary(os.path.join(sparse, "points3D.bin"))[0]
    xyz1 = read_points3D_binary(os.path.join(out_a, "points3D.bin"))[0]
    assert np.abs(xyz1 - xyz0 @ R4[:3, :3].T).max() < 1e-6
    for k in ims0:
        c2w = []
        for im in (ims0[k], ims1[k]):
            w2c = np.eye(4)
            w2c[:3, :3] = qvec2rotmat(im.qvec)
            w2c[:3, 3] = im.tvec
            c2w.append(np.linalg.inv(w2c))
        assert np.abs(c2w[1] - R4 @ c2w[0]).max() < 1e-8


def test_align_render_invariance_on_port(tmp_path):
    """The rotated scene seen from the rotated camera renders as the
    original (tests/test_data_layer.py:380-440's check, on the port's CPU
    render at 64x48, through the script's main)."""
    from instascene_tpu_torch.models.gaussians import load_ply
    from instascene_tpu_torch.ops.rasterize import (CameraMats,
                                                    RasterizeConfig,
                                                    rasterize)
    from instascene_tpu_torch.scripts import align_coords
    from instascene_tpu_torch.viewer.gui import OrbitCamera
    _, R4 = _rotation()
    ply = str(tmp_path / "model.ply")
    _blob_ply(ply, seg=True)
    out = align_coords.main(["--scene_dir", str(tmp_path), "--degrees",
                             ",".join(str(d) for d in R_DEG), "--ply", ply])
    p0 = load_ply(ply, seg_feat_dim=16, load_seg_feat=True, device="cpu")
    p1 = load_ply(out["ply"], seg_feat_dim=16, load_seg_feat=True,
                  device="cpu")
    cam = OrbitCamera(64, 48, r=4.0).minicam()
    w2v = np.asarray(cam.w2v, np.float64)
    proj = np.asarray(cam.full_proj, np.float64) @ np.linalg.inv(w2v)

    def render(p, w2v_np):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        mats = CameraMats(f(w2v_np), f(proj @ w2v_np),
                          f(np.linalg.inv(w2v_np)[:3, 3]))
        with torch.no_grad():
            return rasterize(p.xyz, p.scaling_activated(),
                             p.rotation_normalized(),
                             p.opacity_activated()[:, 0], mats,
                             torch.zeros(3), RasterizeConfig(64, 48),
                             shs=p.features(), sh_degree=3,
                             alive=p.alive).blend

    a, b = render(p0, w2v), render(p1, w2v @ R4.T)
    assert float(a.alpha.max()) > 0.5
    assert float((a.color - b.color).abs().max()) < 5e-3
    assert float((a.alpha - b.alpha).abs().max()) < 5e-3


# -------------------------------------------------------- generate_masks

def test_masks_from_dir_matches(tmp_path):
    """8- and 16-bit gray PNGs, an RGB PNG (its first band) and npy label
    maps convert to the same uint16 PNG pixels as the JAX script writes;
    a missing source is skipped."""
    from PIL import Image
    from scripts.generate_masks import masks_from_dir as jax_masks
    from instascene_tpu_torch.scripts.generate_masks import masks_from_dir
    from instascene_tpu_torch.utils.image import read_image
    rng = np.random.default_rng(4)
    src = tmp_path / "src"
    src.mkdir()
    labels = {"a": rng.integers(0, 9, (12, 16)).astype(np.uint8),
              "b": rng.integers(0, 70_000, (12, 16)).astype(np.uint16),
              "c": rng.integers(0, 300, (12, 16)).astype(np.int64),
              "d": rng.integers(0, 40, (12, 16, 3)).astype(np.uint8)}
    Image.fromarray(labels["a"]).save(src / "a.png")
    Image.fromarray(labels["b"]).save(src / "b.png")
    np.save(src / "c.npy", labels["c"])
    Image.fromarray(labels["d"]).save(src / "d.png")
    images = [f"/images/{n}.jpg" for n in "abcde"]
    for name, fn in (("port", masks_from_dir), ("jax", jax_masks)):
        (tmp_path / name).mkdir()
        fn(images, str(tmp_path / name), str(src))
    for n in "abcd":
        got = np.array(Image.open(tmp_path / "port" / f"{n}.png"))
        want = np.array(Image.open(tmp_path / "jax" / f"{n}.png"))
        assert got.dtype == want.dtype and np.array_equal(got, want), n
        lab = labels[n][..., 0] if n == "d" else labels[n]
        assert np.array_equal(read_image(str(tmp_path / "port" /
                                             f"{n}.png"))[..., 0],
                              lab.astype(np.uint16))
    assert not (tmp_path / "port" / "e.png").exists()


def test_generate_masks_main(e2e, tmp_path):
    """--from_dir lays out <scene>/sam/mask for every training image; the
    --hf_model path exits with its message."""
    from instascene_tpu_torch.scripts import generate_masks
    from instascene_tpu_torch.utils.image import read_image
    scene = _copy(e2e[0], str(tmp_path / "scene"))
    src = tmp_path / "maps"
    src.mkdir()
    names = sorted(os.listdir(os.path.join(scene, "images")))
    for i, name in enumerate(names):
        np.save(src / (name.split(".")[0] + ".npy"),
                np.full((48, 64), i + 1, np.int32))
    shutil.rmtree(os.path.join(scene, "sam"))
    out = generate_masks.main(["-s", scene, "--from_dir", str(src)])
    assert sorted(os.listdir(out)) == names
    for i, name in enumerate(names):
        assert (read_image(os.path.join(out, name)) == i + 1).all()
    with pytest.raises(SystemExit, match="local disk"):
        generate_masks.main(["-s", scene, "--hf_model", "some/model"])


# ------------------------------------------------------------ eval_scene

def _jax_keys(tmp_path, monkeypatch, runs):
    """The results keys JAX's scripts/eval_scene.py writes for `runs`, with
    its trainers replaced by stand-ins (the keys do not depend on them)."""
    import instascene_tpu.data.dataset as jdataset
    import instascene_tpu.pipelines.train as jtrain
    import instascene_tpu.pipelines.train_semantic as jsem
    from scripts import eval_scene

    class Params:
        def n_alive(self):
            return 3

    class Trainer:
        def __init__(self, *a, **k):
            self.params, self.test_cams = Params(), [0]

        def step(self, it):
            pass

        def evaluate(self, split):
            return {"psnr": 20.0}

        def save(self, it):
            path = str(tmp_path / "jax_fake.ply")
            open(path, "w").close()
            return path

    class Seg:
        def __init__(self, *a, **k):
            self.seg3d_masks = np.zeros((4, 2), bool)
            self.seg3d_labels = np.array([1, 1, 2, 2])

        def robust_semantic_priors(self):
            pass

        def train_segfeat(self, **k):
            pass

    monkeypatch.setattr(jdataset, "Scene", lambda *a, **k: None)
    monkeypatch.setattr(jtrain, "GeometryTrainer", Trainer)
    monkeypatch.setattr(jsem, "SegSplatting", Seg)
    src = tmp_path / "jax_scene"
    (src / "sam" / "mask").mkdir(parents=True)
    gt = str(tmp_path / "jax_gt.npy")
    np.save(gt, np.array([1, 1, 2, 2]))
    keys = []
    for flags in runs:
        flags = [gt if f == "GT" else f for f in flags]
        keys.append(list(eval_scene.main(["-s", str(src)] + flags)))
    return keys


def test_eval_scene_matches(e2e, tmp_path, monkeypatch):
    """The geometry half (10 iterations) and the semantic half (5
    iterations, ground-truth labels) of the port's eval_scene on the CPU:
    the results keys of JAX's script, the train PSNR of a trainer stepped
    alike, and the mIoU of JAX's instance_miou on the same labels."""
    from instascene_tpu.semantic.metrics import instance_miou as jax_miou
    from instascene_tpu_torch.config import (ModelParams, OptimizationParams,
                                             PipelineParams)
    from instascene_tpu_torch.data.dataset import Scene
    from instascene_tpu_torch.pipelines.train import GeometryTrainer
    from instascene_tpu_torch.scripts import eval_scene
    from instascene_tpu_torch.semantic import metrics
    monkeypatch.chdir(tmp_path)
    geo_flags = ["--geometry_iters", "10", "--skip_semantic"]
    sem_flags = ["--skip_geometry", "--semantic_iters", "5",
                 "--sample_batchsize", "1024", "--gt_instances", "GT"]
    want_keys = _jax_keys(tmp_path, monkeypatch, [geo_flags, sem_flags])

    src = _copy(e2e[0], str(tmp_path / "geo" / "parent" / "scene"))
    geo = eval_scene.main(["-s", src, "-m", "runA", "--device", "cpu"]
                          + geo_flags)
    assert list(geo) == want_keys[0]
    assert os.path.exists(os.path.join(src, "point_cloud.ply"))
    trainer = GeometryTrainer(
        ModelParams(source_path=src, model_path="again", eval=True),
        OptimizationParams(iterations=10), PipelineParams(),
        Scene(ModelParams(source_path=src, model_path="again", eval=True)),
        device="cpu")
    for it in range(1, 11):
        trainer.step(it)
    assert geo["train_psnr"] == round(trainer.evaluate(split="train")["psnr"],
                                      2)
    assert np.isfinite(geo["test_psnr"])

    seen = {}

    def miou(pred, gt, **kw):
        seen["args"] = (np.array(pred), np.array(gt))
        return metrics_miou(pred, gt, **kw)

    metrics_miou = metrics.instance_miou
    monkeypatch.setattr(metrics, "instance_miou", miou)
    src2 = _copy(e2e[0], str(tmp_path / "sem" / "parent" / "scene"))
    sem = eval_scene.main(["-s", src2, "-m", "runB", "--device", "cpu"]
                          + [e2e[1] if f == "GT" else f for f in sem_flags])
    assert list(sem) == want_keys[1]
    assert sem["n_instances"] >= 2 and sem["semantic_its"] > 0
    assert sem["instance_miou"] == round(jax_miou(*seen["args"]), 3)
