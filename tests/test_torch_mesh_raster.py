"""The port's mesh rasterizer (ops/mesh_raster.py) against the JAX package's
on the CPU: the plane and occlusion fixtures of tests/test_misc.py:15-61, a
marching-sphere mesh seen by a rotated camera at 64x48, and
mesh_normal_prior on tests/test_viewer_extras.py:92-108's plane. The JAX
side gets caps large enough to drop nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

JAX_CAPS = dict(pair_cap=1 << 16, tile_cap=4096)
ATOL = 1e-5


def _plane():
    verts = np.array([[-2, -2, 2], [2, -2, 2], [2, 2, 2], [-2, 2, 2]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, faces, np.eye(4, dtype=np.float32), \
        np.array([20.0, 20.0, 16.0, 12.0], np.float32), 32, 24


def _occlusion():
    verts = np.array([[-3, -3, 4], [3, -3, 4], [0, 3, 4],
                      [-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return verts, faces, np.eye(4, dtype=np.float32), \
        np.array([24.0, 24.0, 16.0, 16.0], np.float32), 32, 32


def _sphere_camera():
    from instascene_tpu.data.synthetic import look_at
    from instascene_tpu_torch.cameras import Camera
    R, t = look_at(np.array([2.0, 1.0, 0.8]), np.zeros(3))
    return Camera(uid=0, colmap_id=0, R=R.T, T=t, fovx=0.9, fovy=0.7,
                  image_name="s", width=64, height=48)


def _sphere():
    from instascene_tpu_torch.mesh.marching import marching_tetrahedra
    xs = np.linspace(-1, 1, 24)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    v, f = marching_tetrahedra(np.linalg.norm(g, axis=-1) - 0.6, 0.0,
                               origin=(-1, -1, -1), spacing=float(xs[1]
                                                                  - xs[0]),
                               device="cpu")
    cam = _sphere_camera()
    intr = np.array([cam.focal_x, cam.focal_y, 32.0, 24.0], np.float32)
    return v.numpy(), f.numpy(), cam.w2c.astype(np.float32), intr, 64, 48


FIXTURES = {"plane": _plane, "occlusion": _occlusion, "sphere": _sphere}


def _both(name):
    from instascene_tpu.ops.mesh_raster import rasterize_mesh as jraster
    from instascene_tpu_torch.ops.mesh_raster import rasterize_mesh
    verts, faces, w2v, intr, W, H = FIXTURES[name]()
    j = jraster(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(w2v),
                jnp.asarray(intr), W, H, **JAX_CAPS)
    t = rasterize_mesh(torch.as_tensor(verts), torch.as_tensor(faces),
                       torch.as_tensor(w2v), torch.as_tensor(intr), W, H)
    j = {k: np.asarray(v) for k, v in j._asdict().items()}
    t = {k: v.numpy() for k, v in t._asdict().items()}
    return verts, faces, w2v, intr, j, t


def _zhit(verts, faces, w2v, intr, f, x, y):
    """The perspective-correct depth of face f at pixel (x, y), float64."""
    pv = verts[faces[f]].astype(np.float64) @ w2v[:3, :3].T.astype(
        np.float64) + w2v[:3, 3]
    u = pv[:, 0] / pv[:, 2] * intr[0] + intr[2]
    v = pv[:, 1] / pv[:, 2] * intr[1] + intr[3]
    area = (u[1] - u[0]) * (v[2] - v[0]) - (v[1] - v[0]) * (u[2] - u[0])
    w0 = ((u[1] - x) * (v[2] - y) - (v[1] - y) * (u[2] - x)) / area
    w1 = ((u[2] - x) * (v[0] - y) - (v[2] - y) * (u[0] - x)) / area
    w2 = 1 - w0 - w1
    return 1 / (w0 / pv[0, 2] + w1 / pv[1, 2] + w2 / pv[2, 2])


@pytest.mark.parametrize("name", list(FIXTURES))
def test_rasterize_mesh_matches_jax(name):
    verts, faces, w2v, intr, j, t = _both(name)
    assert t["depth"].shape == j["depth"].shape
    assert t["face_id"].dtype == np.int32
    hit = t["face_id"] >= 0
    np.testing.assert_array_equal(hit, j["face_id"] >= 0)
    assert hit.mean() > 0.1
    np.testing.assert_allclose(t["depth"], j["depth"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(t["normal"], j["normal"], atol=ATOL, rtol=0)
    # face ids equal but at ties: both faces reach the pixel at one depth
    for y, x in zip(*np.nonzero(t["face_id"] != j["face_id"])):
        za = _zhit(verts, faces, w2v, intr, t["face_id"][y, x], x, y)
        zb = _zhit(verts, faces, w2v, intr, j["face_id"][y, x], x, y)
        assert abs(za - zb) <= 1e-5 * za, (name, y, x)
    if name == "plane":
        # the diagonal's pixels touch both faces at one depth: the JAX
        # package takes the first face of its tile's list, the port the
        # smallest id, and the two agree here
        d = [(y, x) for y in range(24) for x in range(32)
             if abs(_zhit(verts, faces, w2v, intr, 0, x, y)
                    - _zhit(verts, faces, w2v, intr, 1, x, y)) < 1e-9
             and (x - 16) == (y - 12)]
        assert d
        np.testing.assert_array_equal(t["face_id"], j["face_id"])
    if name == "occlusion":
        assert t["face_id"][16, 16] == 1 and (t["face_id"] == 0).any()


@pytest.mark.parametrize("name", list(FIXTURES))
def test_rasterize_mesh_positions(name):
    """Positions equal the JAX package's for its identity cameras; for the
    rotated camera they are the camera centre plus depth times the pixel
    ray in world space, which puts them on the sphere, where the JAX
    package's (its ray rotated by the world-to-camera rotation) are off it
    (ROADMAP C)."""
    verts, faces, w2v, intr, j, t = _both(name)
    hit = t["face_id"] >= 0
    if name != "sphere":
        np.testing.assert_allclose(t["position"], j["position"], atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(t["position"][hit][:, 2],
                                   t["depth"][hit], atol=ATOL)
        return
    c2w = np.linalg.inv(w2v.astype(np.float64))
    H, W = t["depth"].shape
    yy, xx = np.mgrid[0:H, 0:W]
    ray = np.stack([(xx - intr[2]) / intr[0], (yy - intr[3]) / intr[1],
                    np.ones((H, W))], -1) @ c2w[:3, :3].T
    want = c2w[:3, 3] + j["depth"][..., None] * ray
    np.testing.assert_allclose(t["position"][hit], want[hit], atol=1e-4)
    assert np.abs(t["position"][~hit]).max() == 0
    rad = np.linalg.norm(t["position"][hit], axis=-1)
    assert np.abs(rad - 0.6).max() < 0.01          # the mesh's chord error
    assert np.abs(np.linalg.norm(j["position"][hit], axis=-1)
                  - 0.6).max() > 0.5


def test_mesh_normal_prior_matches_jax():
    from instascene_tpu.cameras import Camera as JCamera
    from instascene_tpu.data.synthetic import look_at
    from instascene_tpu.ops.mesh_raster import mesh_normal_prior as jprior
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.ops.mesh_raster import mesh_normal_prior
    R_w2c, t = look_at(np.array([0.0, 0.0, -3.0]), np.zeros(3))
    kw = dict(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=0.9, fovy=0.7,
              image_name="t", width=32, height=24)
    verts = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    jn, jm = jprior(JCamera(**kw), verts, faces)
    tn, tm = mesh_normal_prior(Camera(**kw), verts, faces, device="cpu")
    assert tn.shape == (24, 32, 3) and tm.sum() > 100
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tn, jn, atol=ATOL, rtol=0)
    assert np.allclose(np.abs(tn[tm][:, 2]), 1.0, atol=1e-4)
