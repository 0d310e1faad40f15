"""Port (instascene_tpu_torch) host layer against the JAX package: cameras,
PLY bytes, the benchmark scene builder, SH colors, PNG output, device
resolution, and the no-JAX import rule."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """The port package (every module, the scripts too) imports neither
    jax nor the JAX package, nor, at import time, sklearn, networkx, tqdm,
    matplotlib, imageio, tensorboard or PIL (optional: the GPU machine
    may lack them; torch itself may load some of them, so only what the
    port adds counts for those)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import numpy, scipy, torch\n"
        "before = set(sys.modules)\n"
        "import instascene_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', "
        "'instascene_tpu') or (k not in before and k.split('.')[0] in "
        "('sklearn', 'networkx', 'tqdm', 'matplotlib', 'imageio', "
        "'tensorboard', 'PIL'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cameras_match():
    from instascene_tpu.cameras import Camera as JCam
    from instascene_tpu.viewer.gui import OrbitCamera as JOrbit
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.data.synthetic import look_at
    from instascene_tpu_torch.viewer.gui import OrbitCamera
    for i, (pos, fov) in enumerate([((0.0, -3.5, 1.0), (0.9, 0.65)),
                                    ((2.0, 1.0, 1.5), (1.2, 0.95))]):
        R_w2c, t = look_at(np.array(pos), np.zeros(3))
        a = Camera(uid=i, colmap_id=i, R=R_w2c.T, T=t, fovx=fov[0],
                   fovy=fov[1], image_name="c", width=64, height=48)
        b = JCam(uid=i, colmap_id=i, R=R_w2c.T, T=t, fovx=fov[0],
                 fovy=fov[1], image_name="c", width=64, height=48)
        for k in ("w2v", "full_proj", "camera_center"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       atol=1e-6, err_msg=k)
        assert a.tanfovx == pytest.approx(b.tanfovx)
    oa, ob = OrbitCamera(96, 64, r=3.0), JOrbit(96, 64, r=3.0)
    oa.orbit(120.0, 30.0)
    ob.orbit(120.0, 30.0)
    ma, mb = oa.minicam(), ob.minicam()
    np.testing.assert_allclose(ma.w2v, mb.w2v, atol=1e-6)
    np.testing.assert_allclose(ma.full_proj, mb.full_proj, atol=1e-6)


def _state(n=50, seed=3, seg=True):
    rng = np.random.default_rng(seed)
    d = dict(xyz=rng.normal(size=(n, 3)).astype(np.float32),
             features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
             features_rest=rng.normal(size=(n, 15, 3)).astype(np.float32),
             scaling=rng.normal(-3, 0.5, (n, 2)).astype(np.float32),
             rotation=rng.normal(size=(n, 4)).astype(np.float32),
             opacity=rng.normal(size=(n, 1)).astype(np.float32),
             alive=rng.random(n) > 0.2,
             seg_feature=(rng.random((n, 16)).astype(np.float32)
                          if seg else None),
             active_sh_degree=3, max_sh_degree=3)
    return d


def _jax_params(d):
    from instascene_tpu.models.gaussians import GaussianParams
    return GaussianParams(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in d.items()})


@pytest.mark.parametrize("seg", [True, False])
def test_ply_bytes_and_load_match(tmp_path, seg):
    from instascene_tpu.models import gaussians as jg
    from instascene_tpu_torch.models import gaussians as tg
    d = _state(seg=seg)
    jp = _jax_params(d)
    tp = tg.from_numpy(d, device="cpu")
    n_alive = int(d["alive"].sum())
    crop = np.arange(n_alive) % 3 != 0
    for name, kw in (("all", {}), ("crop", {"crop_mask": crop})):
        ja, ta = tmp_path / f"j_{name}.ply", tmp_path / f"t_{name}.ply"
        jg.save_ply(jp, str(ja), **kw)
        tg.save_ply(tp, str(ta), **kw)
        assert ja.read_bytes() == ta.read_bytes(), name
    kw = dict(max_sh_degree=3, seg_feat_dim=16, load_seg_feat=True)
    jl = jg.load_ply(str(tmp_path / "j_all.ply"), **kw)
    tl = tg.load_ply(str(tmp_path / "j_all.ply"), device="cpu", **kw)
    for k in tg.FIELDS:
        a, b = getattr(jl, k), getattr(tl, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), k)
    assert tl.active_sh_degree == jl.active_sh_degree == 3


def test_activations_match():
    d = _state()
    jp = _jax_params(d)
    from instascene_tpu_torch.models.gaussians import from_numpy
    tp = from_numpy(d, device="cpu")
    for k in ("scaling_activated", "opacity_activated",
              "rotation_normalized", "features", "seg_feature_normed"):
        np.testing.assert_allclose(getattr(tp, k)().numpy(),
                                   np.asarray(getattr(jp, k)()),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("profile", ["trained", "uniform"])
def test_bench_scene_matches(profile):
    from bench import make_bench_scene as jax_scene
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    st, mk = make_bench_scene(n=2000, seed=5, profile=profile)
    jp, jmk = jax_scene(n=2000, seed=5, profile=profile)
    for k in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "alive", "seg_feature"):
        np.testing.assert_array_equal(st[k], np.asarray(getattr(jp, k)), k)
    a, b = mk(3, 64, 48), jmk(3, 64, 48)
    np.testing.assert_array_equal(a.w2v, b.w2v)
    np.testing.assert_array_equal(a.full_proj, b.full_proj)


def test_sh_colors_match():
    from instascene_tpu.ops.sh import sh_to_color as jsh
    from instascene_tpu_torch.ops.sh import sh_to_color
    rng = np.random.default_rng(1)
    sh = rng.normal(0, 0.5, (200, 16, 3)).astype(np.float32)
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    campos = np.array([0.5, -3.0, 1.0], np.float32)
    for deg in range(4):
        a = sh_to_color(deg, torch.as_tensor(sh), torch.as_tensor(xyz),
                        torch.as_tensor(campos)).numpy()
        b = np.asarray(jsh(deg, jnp.asarray(sh), jnp.asarray(xyz),
                           jnp.asarray(campos)))
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f"deg {deg}")


def test_png_roundtrip(tmp_path):
    from instascene_tpu_torch.utils.image import decode_png, write_png
    rng = np.random.default_rng(0)
    for shape in ((7, 5, 3), (4, 9), (3, 3, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = tmp_path / "x.png"
        write_png(str(path), img)
        back = decode_png(path.read_bytes())
        np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_device_resolution():
    """cuda is the default and there is no silent CPU fallback."""
    from instascene_tpu_torch import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
