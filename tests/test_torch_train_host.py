"""The port's training host layer against the JAX package on the same seeded
numpy inputs: losses, Adam, densification, KNN, the learning-rate schedule,
the point-cloud initialisation, and the data layer (COLMAP readers, Scene,
the PNG decoder against PIL)."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TRAINED = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
           "opacity")


def _state(n=64, seed=3, seg=False):
    rng = np.random.default_rng(seed)
    return dict(xyz=rng.normal(size=(n, 3)).astype(np.float32),
                features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
                features_rest=rng.normal(size=(n, 15, 3)).astype(np.float32),
                scaling=rng.normal(-3, 1.0, (n, 2)).astype(np.float32),
                rotation=rng.normal(size=(n, 4)).astype(np.float32),
                opacity=rng.normal(-1, 2, (n, 1)).astype(np.float32),
                alive=rng.random(n) > 0.3,
                seg_feature=(rng.random((n, 16)).astype(np.float32)
                             if seg else None),
                active_sh_degree=3, max_sh_degree=3)


def _jax_params(d):
    from instascene_tpu.models.gaussians import GaussianParams
    return GaussianParams(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in d.items()})


def _adam_pair(d, seed=4):
    """The same random Adam state for both packages."""
    from instascene_tpu.models.optimizer import AdamState as JAdam
    from instascene_tpu.models.optimizer import init_adam_state
    from instascene_tpu_torch.models.optimizer import AdamState
    rng = np.random.default_rng(seed)
    fields = TRAINED + (("seg_feature",) if d["seg_feature"] is not None
                        else ())
    m = {f: rng.normal(size=d[f].shape).astype(np.float32) * 1e-2
         for f in fields}
    v = {f: rng.random(d[f].shape).astype(np.float32) * 1e-4 for f in fields}
    j0 = init_adam_state(_jax_params(d))
    jopt = JAdam(m=j0.m.replace(**{f: jnp.asarray(a) for f, a in m.items()}),
                 v=j0.v.replace(**{f: jnp.asarray(a) for f, a in v.items()}),
                 count=jnp.asarray(7, jnp.int32))
    t = lambda x: {f: torch.as_tensor(a) for f, a in x.items()}
    return jopt, AdamState(m=t(m), v=t(v), count=7)


def _check_state(tp, jp, topt, jopt, atol):
    for f in TRAINED + ("seg_feature",):
        a, b = getattr(tp, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=0, err_msg=f)
        for mom in ("m", "v"):
            np.testing.assert_allclose(
                getattr(topt, mom)[f].numpy(),
                np.asarray(getattr(getattr(jopt, mom), f)), atol=atol,
                rtol=0, err_msg=f"{mom}.{f}")
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    assert topt.count == int(jopt.count)


def test_losses_match():
    from instascene_tpu import losses as jl
    from instascene_tpu_torch import losses as tl
    rng = np.random.default_rng(0)
    a = rng.random((48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("l1_loss", "ssim", "psnr"):
        np.testing.assert_allclose(float(getattr(tl, name)(ta, tb)),
                                   float(getattr(jl, name)(ja, jb)),
                                   rtol=1e-5, err_msg=name)
    tp, tl1 = tl.photometric_loss(ta, tb, 0.2)
    jp, jl1 = jl.photometric_loss(ja, jb, 0.2)
    np.testing.assert_allclose([float(tp), float(tl1)],
                               [float(jp), float(jl1)], rtol=1e-5)


def test_adam_step_matches():
    """Per-field learning rates, bias correction by one global count, and
    dead rows fixed even where their gradient is not finite."""
    from instascene_tpu.models.optimizer import adam_step as jadam
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.models.optimizer import adam_step
    d = _state(seg=True)
    rng = np.random.default_rng(1)
    grads = {f: rng.normal(size=d[f].shape).astype(np.float32) * 1e-2
             for f in TRAINED}
    dead = ~d["alive"]
    grads["xyz"][dead] = np.nan
    grads["opacity"][dead] = np.inf
    lrs = {"xyz": 3e-4, "features_dc": 2.5e-3, "features_rest": 1.25e-4,
           "opacity": 0.05, "scaling": 5e-3, "rotation": 1e-3,
           "seg_feature": 0.0}
    jopt, topt = _adam_pair(d)
    jp = _jax_params(d)
    jg = jp.replace(**{f: jnp.asarray(g) for f, g in grads.items()},
                    seg_feature=None)
    jp2, jopt2 = jadam(jp, jg, jopt, {k: jnp.float32(v)
                                      for k, v in lrs.items()})
    tp2, topt2 = adam_step(from_numpy(d, "cpu"),
                           {f: torch.as_tensor(g) for f, g in grads.items()},
                           topt, lrs)
    _check_state(tp2, jp2, topt2, jopt2, atol=1e-6)
    for f in TRAINED:
        np.testing.assert_array_equal(getattr(tp2, f).numpy()[dead],
                                      d[f][dead], err_msg=f)


@pytest.mark.parametrize("use_screen_size", [False, True])
def test_densify_and_prune_matches(use_screen_size):
    """Clone, split and prune in one masked pass with JAX's split noise
    handed in: the alive mask exactly, every field and moment within 1e-6,
    the same overflow count; then reset_opacity and grow_capacity."""
    from instascene_tpu.models import densify as jd
    from instascene_tpu_torch.models import densify as td
    from instascene_tpu_torch.models.gaussians import from_numpy
    n = 64
    d = _state(n=n, seg=True)
    d["alive"][:] = True
    d["alive"][-8:] = False         # few dead slots: some children overflow
    rng = np.random.default_rng(8)
    stats = [rng.random(n).astype(np.float32) * 8e-4,
             rng.integers(0, 3, n).astype(np.float32),
             rng.random(n).astype(np.float32) * 30]
    jopt, topt = _adam_pair(d)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (2, n, 3), dtype=jnp.float32))
    args = (2e-4, 0.005, 4.0, 20.0)
    jp2, jopt2, jst2, jover = jd.densify_and_prune(
        _jax_params(d), jopt, jd.DensifyStats(*map(jnp.asarray, stats)), key,
        *args, percent_dense=0.01, use_screen_size=use_screen_size)
    tp2, topt2, tst2, tover = td.densify_and_prune(
        from_numpy(d, "cpu"), topt, td.DensifyStats(*map(torch.as_tensor,
                                                         stats)),
        torch.as_tensor(eps.copy()), *args, percent_dense=0.01,
        use_screen_size=use_screen_size)
    assert tover == int(jover)
    if not use_screen_size:       # (with it, the screen-size prune frees room)
        assert tover > 0 and int(tp2.alive.sum()) == n
    assert int(tp2.alive.sum()) != int(d["alive"].sum())
    _check_state(tp2, jp2, topt2, jopt2, atol=1e-6)
    assert not any(s.any() for s in tst2)

    jp3, jopt3 = jd.reset_opacity(jp2, jopt2)
    tp3, topt3 = td.reset_opacity(tp2, topt2)
    _check_state(tp3, jp3, topt3, jopt3, atol=1e-6)

    jp4, jopt4, jst4 = jd.grow_capacity(jp3, jopt3, jst2, 2 * n)
    tp4, topt4, tst4 = td.grow_capacity(tp3, topt3, tst2, 2 * n)
    assert tp4.capacity == 2 * n
    _check_state(tp4, jp4, topt4, jopt4, atol=1e-6)
    for f in TRAINED + ("alive",):
        a, b = getattr(tp4, f), getattr(tp3, f)
        assert torch.equal(a[:n], b) and not a[n:].any(), f
    for a, b in zip(tst4, jst4):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        td.grow_capacity(tp4, topt4, tst4, n)


def test_knn_matches():
    """Blocked over queries (a block smaller than the cloud here). Both
    use the |q|² + |p|² − 2 q·p form, which cancels: each distance carries
    an absolute error of a few float32 ulps of the squared norms (~1e-6
    here), whatever the order of the sums."""
    from instascene_tpu.ops.knn import mean_dist2_knn3 as jknn
    from instascene_tpu_torch.ops.knn import mean_dist2_knn3
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    got = mean_dist2_knn3(torch.as_tensor(pts), block=256).numpy()
    want = np.asarray(jknn(jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    np.testing.assert_allclose(got, np.sort(d2, 1)[:, :3].mean(1), rtol=1e-5,
                               atol=2e-6)


def test_lr_schedule_and_rotation_match():
    from instascene_tpu.utils import general as jg
    from instascene_tpu_torch.utils import general as tg
    for kw in (dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01,
                    max_steps=30_000),
               dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=100,
                    lr_delay_mult=0.1, max_steps=500),
               dict(lr_init=0.0, lr_final=0.0)):
        a, b = tg.get_expon_lr_func(**kw), jg.get_expon_lr_func(**kw)
        for step in (-1, 0, 1, 50, 250, 499, 500, 10_000, 40_000):
            assert a(step) == pytest.approx(b(step), rel=1e-12, abs=0), (kw,
                                                                         step)
    q = np.random.default_rng(0).normal(size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(tg.build_rotation(torch.as_tensor(q)).numpy(),
                               np.asarray(jg.build_rotation(jnp.asarray(q))),
                               atol=1e-6)


def test_create_from_pcd_matches():
    from instascene_tpu.models.gaussians import create_from_pcd as jcreate
    from instascene_tpu_torch.models.gaussians import create_from_pcd
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    cols = rng.random((100, 3)).astype(np.float32)
    dist2 = rng.random(100).astype(np.float32) * 1e-2
    for kw in (dict(capacity=256, max_sh_degree=3, seed=2),
               dict(max_sh_degree=1, seg_feat_dim=16, seed=5)):
        a = create_from_pcd(pts, cols, dist2, device="cpu", **kw)
        b = jcreate(pts, cols, dist2, **kw)
        for f in TRAINED + ("alive", "seg_feature"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y), f)
        assert (a.capacity, a.n_alive()) == (b.capacity, int(b.n_alive()))
        assert (a.active_sh_degree, a.max_sh_degree) == (
            b.active_sh_degree, b.max_sh_degree)
        up = a.one_up_sh_degree()
        assert up.active_sh_degree == 1
        assert up.one_up_sh_degree().active_sh_degree == min(
            2, kw["max_sh_degree"])


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    from scene_builder import build_e2e_scene
    d = tmp_path_factory.mktemp("data") / "parent" / "scene"
    build_e2e_scene(str(d), with_segmaps=False)
    return str(d)


@pytest.mark.parametrize("eval_split", [False, True])
def test_scene_matches(colmap_scene, tmp_path, eval_split):
    """read_colmap_scene and Scene on the e2e test scene: the same cameras
    (matrices, images, split), extent, point cloud and model_path."""
    from instascene_tpu.config import ModelParams as JModel
    from instascene_tpu.data.dataset import Scene as JScene
    from instascene_tpu_torch.config import ModelParams
    from instascene_tpu_torch.data.dataset import Scene
    ply = os.path.join(colmap_scene, "sparse/0/points3D.ply")
    a = Scene(ModelParams(source_path=colmap_scene, eval=eval_split),
              output_root=str(tmp_path / "t"))
    os.remove(ply)         # the JAX reader writes it anew from points3D.bin
    b = JScene(JModel(source_path=colmap_scene, eval=eval_split),
               output_root=str(tmp_path / "t"))
    assert a.model_path == b.model_path
    assert a.cameras_extent == pytest.approx(b.cameras_extent, rel=1e-12)
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(a.scene_info.point_cloud, k),
                                      getattr(b.scene_info.point_cloud, k))
    for get in ("get_train_cameras", "get_test_cameras"):
        ca, cb = getattr(a, get)(), getattr(b, get)()
        assert len(ca) == len(cb) and (len(ca) > 0 or get == "get_test_cameras")
        for x, y in zip(ca, cb):
            assert x.image_name == y.image_name
            assert (x.width, x.height) == (y.width, y.height)
            for k in ("w2v", "full_proj", "camera_center", "image"):
                np.testing.assert_allclose(getattr(x, k), getattr(y, k),
                                           atol=1e-6, err_msg=k)
    assert len(a.get_test_cameras()) == (1 if eval_split else 0)


def test_colmap_text_readers_match(tmp_path):
    from instascene_tpu.data import colmap as jc
    from instascene_tpu_torch.data import colmap as tc
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 64 48 50.0 51.0 32.0 24.0\n"
        "2 SIMPLE_PINHOLE 32 24 30.0 16.0 12.0\n")
    (tmp_path / "images.txt").write_text(
        "# comment\n"
        "1 0.9 0.1 0.2 0.3 0.5 -0.2 4.0 1 b.png\n"
        "10.0 20.0 -1 30.5 40.5 3\n"
        "2 1.0 0.0 0.0 0.0 0.0 0.0 3.0 2 a.png\n\n")
    (tmp_path / "points3D.txt").write_text(
        "# comment\n1 0.5 -0.5 1.5 255 128 0 0.1 1 0\n"
        "7 -1.0 2.0 0.25 10 20 30 0.2\n")
    for name in ("cameras", "images"):
        a = getattr(tc, f"read_{name}_text")(str(tmp_path / f"{name}.txt"))
        b = getattr(jc, f"read_{name}_text")(str(tmp_path / f"{name}.txt"))
        assert sorted(a) == sorted(b)
        for k in a:
            for f in ("model", "width", "height", "params", "qvec", "tvec",
                      "camera_id", "name", "xys", "point3D_ids"):
                if hasattr(b[k], f):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(a[k], f)),
                        np.asarray(getattr(b[k], f)), err_msg=f)
    for x, y in zip(tc.read_points3D_text(str(tmp_path / "points3D.txt")),
                    jc.read_points3D_text(str(tmp_path / "points3D.txt"))):
        np.testing.assert_array_equal(x, y)


def _png(img, filters):
    """An 8-bit PNG whose row y is filtered with filters[y % len]."""
    h, w, c = img.shape
    a = img.astype(np.int32).reshape(h, w * c)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        up = a[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), a[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) >> 1, paeth][ft]
        rows.append(bytes([ft]) + ((a[y] - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ct = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ct, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_decoder_matches_pil(tmp_path):
    """PIL-written PNGs of every 8-bit colour type, and PNGs using every
    filter type (0-4), decode as PIL decodes them; palette PNGs go through
    PIL in read_image."""
    from PIL import Image

    from instascene_tpu_torch.utils.image import (UnsupportedPNG, decode_png,
                                                  load_image, read_image)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([xx * 4, yy * 6, xx + yy, 255 - xx * 3], -1) % 256
    for mode, c in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        for kind, base in (("noise", rng.integers(0, 256, (37, 53, 4))),
                           ("smooth", smooth)):
            arr = base[..., :c].astype(np.uint8)
            path = str(tmp_path / f"{mode}_{kind}.png")
            Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(path)
            want = np.array(Image.open(path))
            got = decode_png(open(path, "rb").read())
            np.testing.assert_array_equal(got.reshape(want.shape), want,
                                          err_msg=f"{mode} {kind}")
            np.testing.assert_array_equal(
                load_image(path), read_image(path).astype(np.float32) / 255)
        with open(str(tmp_path / "f.png"), "wb") as f:
            f.write(_png(smooth[..., :c].astype(np.uint8), [0, 1, 2, 3, 4]))
        want = np.array(Image.open(str(tmp_path / "f.png")))
        got = decode_png(open(str(tmp_path / "f.png"), "rb").read())
        np.testing.assert_array_equal(got.reshape(want.shape), want,
                                      err_msg=f"{mode} filters 0-4")
    pal = Image.fromarray(smooth[..., :3].astype(np.uint8)).convert(
        "P", palette=Image.ADAPTIVE)
    pal.save(str(tmp_path / "p.png"))
    with pytest.raises(UnsupportedPNG):
        decode_png(open(str(tmp_path / "p.png"), "rb").read())
    np.testing.assert_array_equal(
        read_image(str(tmp_path / "p.png")),
        np.array(Image.open(str(tmp_path / "p.png")).convert("RGB")))
