"""The port's mesh export against the JAX package on the CPU: marching
tetrahedra (faces and vertices equal), the TSDF slab integration, the
fused sphere mesh, post-processing and the PLY writer, GaussianExtractor on
a blob scene (depth maps, bounded and unbounded meshes) and the
extract_mesh CLI on the end-to-end COLMAP scene."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def sphere_field(n=32, r=0.6):
    xs = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    return np.linalg.norm(g, axis=-1) - r, xs


def _march_cases():
    field, xs = sphere_field()
    rng = np.random.default_rng(7)
    return {
        # tests/test_mesh.py's call: a numpy float64 spacing (float64 verts)
        "sphere": (field, 0.0, (-1, -1, -1), xs[1] - xs[0]),
        "sphere_level": (field, 0.1, (0.25, -3.0, 1.5), 0.0625),
        "random": (rng.normal(size=(14, 17, 11)), 0.0, (0, 0, 0), 1.0),
        "random_level": (rng.normal(size=(20, 9, 16)), -0.35,
                         (1.0, 2.0, -0.5), 0.03),
        "empty": (np.ones((8, 8, 8)), 0.0, (0, 0, 0), 1.0),
        "flat": (rng.normal(size=(1, 6, 6)), 0.0, (0, 0, 0), 1.0),
    }


@pytest.mark.parametrize("case", list(_march_cases()))
def test_marching_matches_jax(case):
    from instascene_tpu.mesh.marching import marching_tetrahedra as jmarch
    from instascene_tpu_torch.mesh.marching import marching_tetrahedra
    values, level, origin, spacing = _march_cases()[case]
    jv, jf = jmarch(values, level, origin=origin, spacing=spacing)
    tv, tf = marching_tetrahedra(values, level, origin=origin,
                                 spacing=spacing, device="cpu")
    assert tv.dtype == {np.float32: torch.float32,
                        np.float64: torch.float64}[jv.dtype.type]
    assert tf.dtype == torch.int32
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tv.numpy(), jv)
    if case.startswith("random"):
        assert len(jf) > 3000       # many surfaces through the field
    if case in ("empty", "flat"):
        assert len(jf) == 0


def _sphere_views(n_views=8, H=64, W=64, r_sphere=0.6):
    """tests/test_mesh.py:48-93's fixture: depth maps of a sphere from a
    ring of cameras (numpy); colors drawn from a seed so that the fused
    colors carry information."""
    from instascene_tpu.cameras import Camera
    from instascene_tpu.data.synthetic import look_at
    rng = np.random.default_rng(3)
    depths, rgbs, w2cs, intrs = [], [], [], []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = np.array([2.5 * np.cos(ang), 2.5 * np.sin(ang), 0.8])
        R_w2c, t = look_at(pos, np.zeros(3))
        cam = Camera(uid=i, colmap_id=i, R=R_w2c.T, T=t, fovx=0.8, fovy=0.8,
                     image_name=str(i), width=W, height=H)
        fx, fy = cam.focal_x, cam.focal_y
        cx, cy = W / 2, H / 2
        ys, xs = np.mgrid[0:H, 0:W]
        d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)],
                         -1)
        dirs = d_cam / np.linalg.norm(d_cam, axis=-1, keepdims=True)
        dirs_w = dirs @ cam.c2w[:3, :3].T
        o = cam.camera_center
        b = 2 * dirs_w @ o
        c = o @ o - r_sphere ** 2
        disc = b ** 2 - 4 * c
        hit = disc > 0
        t_hit = (-b - np.sqrt(np.maximum(disc, 0))) / 2
        zv = t_hit * dirs[..., 2]
        depths.append(np.where(hit & (t_hit > 0), zv, 0.0).astype(np.float32))
        rgbs.append(rng.random((H, W, 3)).astype(np.float32))
        w2cs.append(cam.w2c)
        intrs.append(np.array([fx, fy, cx, cy], np.float32))
    return depths, rgbs, w2cs, intrs


def _near_threshold(vox, w2cs, intrs, depths, depth_trunc, sdf_trunc, H, W,
                    eps=1e-5):
    """Voxels for which some camera's `valid` test (z > 0, u and v inside
    the image, 0 < d <= depth_trunc, sdf > -sdf_trunc) lies within eps of
    its threshold, in float64."""
    near = np.zeros(len(vox), bool)
    for w2c, K, dm in zip(w2cs, intrs, depths):
        pv = vox.astype(np.float64) @ w2c[:3, :3].T + w2c[:3, 3]
        z = pv[:, 2]
        zc = np.maximum(z, 1e-8)
        u = pv[:, 0] / zc * K[0] + K[2]
        v = pv[:, 1] / zc * K[1] + K[3]
        u0 = np.clip(np.floor(u), 0, W - 2).astype(int)
        v0 = np.clip(np.floor(v), 0, H - 2).astype(int)
        fu = np.clip(u - u0, 0, 1)
        fv = np.clip(v - v0, 0, 1)
        d = ((1 - fv) * ((1 - fu) * dm[v0, u0] + fu * dm[v0, u0 + 1])
             + fv * ((1 - fu) * dm[v0 + 1, u0] + fu * dm[v0 + 1, u0 + 1]))
        margins = [z, u, W - 1 - u, v, H - 1 - v, d, depth_trunc - d,
                   d - z + sdf_trunc]
        near |= np.min(np.abs(np.stack(margins)), axis=0) < eps
    return near


def test_integrate_slab_matches_jax():
    from instascene_tpu.mesh.tsdf import _integrate_slab
    from instascene_tpu_torch.mesh.tsdf import integrate_slab
    depths, rgbs, w2cs, intrs = _sphere_views()
    H, W = depths[0].shape
    vox = (np.random.default_rng(1).random((40_000, 3)) * 2.4
           - 1.2).astype(np.float32)
    args = (np.stack(w2cs).astype(np.float32), np.stack(intrs),
            np.stack(depths), np.stack(rgbs))
    j = _integrate_slab(jnp.asarray(vox), *map(jnp.asarray, args), 5.0,
                        0.15, H, W)
    t = integrate_slab(torch.as_tensor(vox), *map(torch.as_tensor, args),
                       5.0, 0.15, H, W)
    jt, jw, jc = (np.asarray(x) for x in j)
    tt, tw, tc = (x.numpy() for x in t)
    assert (jw > 0).mean() > 0.1          # the sphere's shell is fused
    np.testing.assert_allclose(tt, jt, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc, jc, atol=1e-5, rtol=0)
    differ = tw != jw
    near = _near_threshold(vox, w2cs, intrs, depths, 5.0, 0.15, H, W)
    assert not (differ & ~near).any()
    assert differ.sum() <= 1e-4 * len(vox)


def _chamfer(a, b):
    from scipy.spatial import cKDTree
    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


def test_tsdf_fusion_mesh_matches_jax(tmp_path):
    from instascene_tpu.mesh.marching import marching_tetrahedra as jmarch
    from instascene_tpu.mesh.tsdf import _integrate_slab
    from instascene_tpu.mesh.tsdf import tsdf_fusion_mesh as jfuse
    from instascene_tpu_torch.mesh.extractor import write_mesh_ply
    from instascene_tpu_torch.mesh.marching import marching_tetrahedra
    from instascene_tpu_torch.mesh.tsdf import tsdf_fusion_mesh
    depths, rgbs, w2cs, intrs = _sphere_views()
    kw = dict(voxel_size=0.05, sdf_trunc=0.15, depth_trunc=5.0)
    jv, jf, jc = jfuse(depths, rgbs, w2cs, intrs, **kw)
    stats = {}
    tv, tf, tc = tsdf_fusion_mesh(depths, rgbs, w2cs, intrs, device="cpu",
                                  stats=stats, **kw)
    # the JAX test's own checks (tests/test_mesh.py:86-93)
    assert len(tv) > 100
    assert abs(np.median(np.linalg.norm(tv, axis=1)) - 0.6) < 0.08
    path = str(tmp_path / "mesh.ply")
    write_mesh_ply(path, tv, tf, tc)
    assert np.fromfile(path, dtype=np.uint8).size > 1000
    assert tv.dtype == np.float32 and tf.dtype == np.int32
    assert tc.shape == tv.shape and tf.max() < len(tv)
    assert set(stats) == {"fusion", "marching", "grid", "voxel"}
    assert stats["voxel"] == kw["voxel_size"]
    assert abs(len(tv) - len(jv)) <= 0.005 * len(jv)
    assert _chamfer(tv, jv) <= 0.1 * kw["voxel_size"]
    # both meshes carry the JAX package's second sheet at the back of the
    # truncation band, sdf_trunc inside the sphere (unobserved voxels read
    # +1: ROADMAP C): about a third of the vertices
    for v in (tv, jv):
        inner = np.linalg.norm(v, axis=1) < 0.6 - kw["sdf_trunc"] / 2
        assert 0.25 < inner.mean() < 0.45
    # identical fields through both marchings give identical meshes
    H, W = depths[0].shape
    g = np.stack(np.meshgrid(*[np.linspace(-0.8, 0.8, 24)] * 3,
                             indexing="ij"), -1).reshape(-1, 3)
    ts, wt, _ = _integrate_slab(
        jnp.asarray(g.astype(np.float32)),
        jnp.asarray(np.stack(w2cs).astype(np.float32)),
        jnp.asarray(np.stack(intrs)), jnp.asarray(np.stack(depths)),
        jnp.asarray(np.stack(rgbs)), 5.0, 0.15, H, W)
    field = np.where(np.asarray(wt) > 0, np.asarray(ts), 1.0).reshape(
        24, 24, 24).astype(np.float64)
    mv, mf = jmarch(field, 0.0, origin=(-0.8, -0.8, -0.8), spacing=0.07)
    pv, pf = marching_tetrahedra(field, 0.0, origin=(-0.8, -0.8, -0.8),
                                 spacing=0.07, device="cpu")
    assert len(mf) > 100
    np.testing.assert_array_equal(pf.numpy(), mf)
    np.testing.assert_array_equal(pv.numpy(), mv)


@pytest.mark.parametrize("colors", [True, False], ids=["colors", "plain"])
def test_post_process_and_ply_match_jax(tmp_path, colors):
    from instascene_tpu.mesh.extractor import post_process_mesh as jpost
    from instascene_tpu.mesh.extractor import write_mesh_ply as jwrite
    from instascene_tpu.mesh.marching import marching_tetrahedra as jmarch
    from instascene_tpu_torch.mesh.extractor import (post_process_mesh,
                                                     write_mesh_ply)
    # a field with many components of many sizes
    rng = np.random.default_rng(11)
    verts, faces = jmarch(rng.normal(size=(16, 16, 16)), 0.8)
    cols = rng.random(verts.shape).astype(np.float32) if colors else None
    for k in (1, 5, 1000):
        j = jpost(verts, faces, cols, k)
        t = post_process_mesh(verts, faces, cols, k)
        for a, b in zip(t, j):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert 0 < len(t[1]) <= len(faces)
        jwrite(str(tmp_path / "j.ply"), *j)
        write_mesh_ply(str(tmp_path / "t.ply"), *t)
        assert ((tmp_path / "t.ply").read_bytes()
                == (tmp_path / "j.ply").read_bytes())
    # the JAX test's two clusters (tests/test_mesh.py:36-45)
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                  [5, 5, 5], [6, 5, 5], [5, 6, 5]], float)
    f = np.array([[0, 1, 2], [1, 3, 2], [4, 5, 6]], np.int32)
    v2, f2, _ = post_process_mesh(v, f, cluster_to_keep=1)
    assert len(f2) == 2 and len(v2) == 4


# ------------------------------------------------------------- extractor
W_, H_ = 64, 48


@pytest.fixture(scope="module")
def blob_views():
    """The blob scene (tests/scene_builder.py) seen by 4 cameras at 64x48:
    JAX render()'s and the port's render()'s depth and color maps."""
    from scene_builder import make_blob_gaussians

    from instascene_tpu.cameras import Camera
    from instascene_tpu.config import PipelineParams as JPipe
    from instascene_tpu.data.synthetic import look_at
    from instascene_tpu.mesh.extractor import GaussianExtractor as JExtractor
    from instascene_tpu_torch.config import PipelineParams
    from instascene_tpu_torch.mesh.extractor import GaussianExtractor
    from instascene_tpu_torch.models.gaussians import from_numpy
    params, _ = make_blob_gaussians(n_per=40)
    st = {f.name: getattr(params, f.name)
          for f in dataclasses.fields(params)}
    st = {k: (np.asarray(v) if hasattr(v, "shape") else v)
          for k, v in st.items()}
    cams = []
    for i in range(4):
        ang = 2 * np.pi * i / 4 + 0.3
        pos = np.array([3.5 * np.cos(ang), 3.5 * np.sin(ang), 1.2])
        R_w2c, t = look_at(pos, np.zeros(3))
        cams.append(Camera(uid=i, colmap_id=i, R=R_w2c.T, T=t, fovx=1.0,
                           fovy=0.8, image_name=str(i), width=W_,
                           height=H_))
    jx = JExtractor(params, JPipe())
    jx.reconstruction(cams)
    tx = GaussianExtractor(from_numpy(st, device="cpu"), PipelineParams(),
                           device="cpu")
    tx.reconstruction(cams)
    return jx, tx


def test_extractor_depth_maps_match_jax(blob_views):
    jx, tx = blob_views
    assert len(tx.depthmaps) == len(jx.depthmaps) == 4
    for jd, td, jr, tr in zip(jx.depthmaps, tx.depthmaps, jx.rgbmaps,
                              tx.rgbmaps):
        assert td.shape == (H_, W_) and tr.shape == (H_, W_, 3)
        assert (td > 0).float().mean() > 0.1
        # tests/test_torch_render.py's surf_depth and render tolerances
        np.testing.assert_allclose(td.numpy(), jd, atol=3e-3, rtol=0)
        np.testing.assert_allclose(tr.numpy(), jr, atol=3e-4, rtol=0)
    np.testing.assert_allclose(tx.center, jx.center, atol=1e-12)
    assert abs(tx.radius - jx.radius) < 1e-12


@pytest.mark.parametrize("bounded", [True, False],
                         ids=["bounded", "unbounded"])
def test_extractor_meshes_match_jax(blob_views, bounded):
    """The port's depth and color maps fed to both extractors give the
    same mesh."""
    jx, tx = blob_views
    jx.depthmaps = [d.numpy() for d in tx.depthmaps]
    jx.rgbmaps = [r.numpy() for r in tx.rgbmaps]
    if bounded:
        kw = dict(voxel_size=0.04, sdf_trunc=0.12, depth_trunc=8.0)
        j = jx.extract_mesh_bounded(**kw)
        stats = {}
        t = tx.extract_mesh_bounded(stats=stats, **kw)
        assert stats["fusion"] > 0 and stats["marching"] > 0
    else:
        j = jx.extract_mesh_unbounded(48)
        t = tx.extract_mesh_unbounded(48)
    assert len(t[1]) > 200
    assert np.isfinite(t[0]).all() and t[1].max() < len(t[0])
    for a, b in zip(t, j):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_extract_mesh_cli_matches_jax(tmp_path):
    """The port's CLI (--device cpu) and the root extract_mesh.py on the
    end-to-end COLMAP scene write meshes of the same counts."""
    from scene_builder import build_e2e_scene

    import extract_mesh as jcli
    from instascene_tpu_torch import extract_mesh
    scene = tmp_path / "data" / "parent" / "scene"
    build_e2e_scene(str(scene), with_segmaps=False)
    common = ["-s", str(scene), "--voxel_size", "0.05", "--sdf_trunc",
              "0.15", "--depth_trunc", "8", "--num_clusters", "3"]
    jcli.main(common + ["-m", str(tmp_path / "jax")])
    out = extract_mesh.main(common + ["-m", str(tmp_path / "port"),
                                      "--device", "cpu"])
    assert out["path"] == str(tmp_path / "port" / "fuse.ply")
    assert set(out["seconds"]) == set(extract_mesh.STAGES)
    assert out["voxel"] == 0.05 and min(out["grid"]) > 10
    j = _ply_counts(str(tmp_path / "jax" / "fuse.ply"))
    t = _ply_counts(out["path"])
    assert t == (out["n_verts"], out["n_faces"])
    assert t[0] > 100 and t[1] > 100
    assert t == j


def _ply_counts(path):
    """(vertices, faces) from a mesh PLY's header; the file's size must be
    the header's plus its records (xyz + rgb, and a 3-index list)."""
    with open(path, "rb") as f:
        data = f.read()
    head = data[:data.index(b"end_header\n") + len(b"end_header\n")]
    lines = head.decode("ascii").split("\n")
    n = {ln.split()[1]: int(ln.split()[2]) for ln in lines
         if ln.startswith("element")}
    rgb = 3 if "property uchar red" in lines else 0
    assert len(data) == len(head) + n["vertex"] * (12 + rgb) + n["face"] * 13
    return n["vertex"], n["face"]


def test_extract_mesh_cli_defaults_to_cuda(monkeypatch, tmp_path):
    """Without --device the CLI runs on CUDA and raises where there is
    none; it does not fall back to the CPU."""
    from instascene_tpu_torch import extract_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_mesh.main(["-s", str(tmp_path), "-m", str(tmp_path / "m")])
