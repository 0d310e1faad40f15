"""The port's data parallelism (instascene_tpu_torch/parallel/) on the CPU
over gloo, held against the JAX package's instascene_tpu/parallel/ (its
8 virtual CPU devices) on the same numpy inputs: the tile-slab sharded
render, the sharded KNN, the launch's device check and the trainers'
refusals of mixed batches.

The ranks are spawned processes that import this module: the workers sit
at its top level and every JAX import stays inside the test functions."""

import numpy as np
import pytest
import torch

W, H = 64, 64                 # 64 rows: 4 slabs of one tile row at most
N = 60
E = 4


def _scene(seed=42):
    """tests/test_parallel.py::test_sharded_render_matches_single's scene
    (60 surfels around the origin, SH degree 0 in a degree-3 layout,
    opacity 0.7), with E random features normalised, activated, as numpy:
    (inputs, a camera at (0, -3.5, 1) looking at the origin, W x H)."""
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.data.synthetic import look_at
    rng = np.random.default_rng(seed)
    R_w2c, t = look_at(np.array([0.0, -3.5, 1.0]), np.zeros(3))
    cam = Camera(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=0.9, fovy=0.9,
                 image_name="t", width=W, height=H)
    n = N
    f = lambda a: np.ascontiguousarray(a, np.float32)
    xyz = rng.normal(0, 0.6, (n, 3))
    fdc = rng.normal(0, 0.3, (n, 1, 3))
    rot = rng.normal(size=(n, 4))
    scaling = rng.normal(-1.8, 0.3, (n, 2))
    feat = rng.random((n, E))
    inp = dict(
        xyz=f(xyz), scales=f(np.exp(scaling)),
        rot=f(rot / np.linalg.norm(rot, axis=1, keepdims=True)),
        opac=np.full(n, 0.7, np.float32),
        shs=f(np.concatenate([fdc, np.zeros((n, 15, 3))], 1)),
        extras=f(feat / np.linalg.norm(feat, axis=1, keepdims=True)))
    return inp, cam


def _mats(cam):
    from instascene_tpu_torch.ops.rasterize import CameraMats
    return CameraMats(*(torch.as_tensor(np.asarray(a, np.float32)) for a in
                        (cam.w2v, cam.full_proj, cam.camera_center)))


def _render_worker(rank, world, device, inp, cam):
    """Each rank's whole frame from sharded_render, full and viewer."""
    from instascene_tpu_torch.parallel.render_sharded import sharded_render
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    out = {}
    for viewer in (False, True):
        color, alpha, extra = sharded_render(
            t["xyz"], t["scales"], t["rot"], t["opac"], _mats(cam),
            torch.zeros(3), W, H, shs=t["shs"], sh_degree=3,
            extras=t["extras"], viewer=viewer)
        out[viewer] = tuple(a.numpy() for a in (color, alpha, extra))
    return out


def _whole_frame(inp, cam, viewer=False, height=H, **slab):
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    with torch.no_grad():
        return rasterize(t["xyz"], t["scales"], t["rot"], t["opac"],
                         _mats(cam), torch.zeros(3),
                         RasterizeConfig(W, height, fwd_viewer=viewer),
                         shs=t["shs"], sh_degree=3, extras=t["extras"],
                         **slab).blend


def test_slab_at_origin_is_the_frame():
    """y_offset 0 with full_height H renders the unsharded frame bit for
    bit, in every map."""
    inp, cam = _scene()
    a = _whole_frame(inp, cam)
    b = _whole_frame(inp, cam, y_offset=0, full_height=H)
    for k in ("color", "alpha", "depth", "normal", "median_depth",
              "distortion", "extra", "n_contrib"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_render(world, tmp_path):
    """World 2 and 4 over gloo, in `full` and `viewer`: every rank's frame
    is bit for bit the slabs rendered in one process (rasterize with each
    slab's y_offset), and equals the whole-frame render within 1e-5 (the
    JAX test's tolerance) and JAX's build_sharded_render on a mesh of 2
    within 1e-5."""
    import jax.numpy as jnp

    from instascene_tpu.ops.rasterize import CameraMats as JMats
    from instascene_tpu.parallel.data_parallel import make_mesh
    from instascene_tpu.parallel.render_sharded import build_sharded_render
    from instascene_tpu_torch.parallel.launch import launch
    inp, cam = _scene()
    outs = launch(_render_worker, world, inp, cam, device="cpu",
                  store_dir=str(tmp_path))
    fn = build_sharded_render(make_mesh(2), W, H, pair_cap=16384,
                              n_extra=E)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    jm = JMats(jnp.asarray(cam.w2v), jnp.asarray(cam.full_proj),
               jnp.asarray(cam.camera_center))
    jc, ja, je, nd = fn(j["xyz"], j["scales"], j["rot"], j["opac"], j["shs"],
                        j["extras"], jm.w2v, jm.full_proj, jm.campos,
                        jnp.zeros(3))
    assert int(np.max(np.asarray(nd))) == 0
    for viewer in (False, True):
        want = _whole_frame(inp, cam, viewer)
        got = outs[0][viewer]
        h = H // world
        slabs = [_whole_frame(inp, cam, viewer, height=h, y_offset=r * h,
                              full_height=H) for r in range(world)]
        for r in range(world):
            for a, k in zip(outs[r][viewer], ("color", "alpha", "extra")):
                np.testing.assert_array_equal(a, torch.cat(
                    [getattr(b, k) for b in slabs]).numpy())
        for a, b in zip(got, (want.color, want.alpha, want.extra)):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=0)
        for a, b in zip(got, (jc, ja, je)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
    assert outs[0][False][1].max() > 0.5        # the frame is not empty


def test_sharded_render_refuses_partial_tile_rows(tmp_path):
    """A height that does not split into whole tile rows per rank raises,
    as the JAX package's does."""
    from instascene_tpu_torch.parallel.launch import launch
    with pytest.raises(RuntimeError, match="must be a multiple of 32"):
        launch(_partial_rows_worker, 2, device="cpu",
               store_dir=str(tmp_path))


def _partial_rows_worker(rank, world, device):
    from instascene_tpu_torch.parallel.render_sharded import sharded_render
    inp, cam = _scene()
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    sharded_render(t["xyz"], t["scales"], t["rot"], t["opac"], _mats(cam),
                   torch.zeros(3), W, 48, shs=t["shs"], sh_degree=3)


def _knn_worker(rank, world, device, pts):
    from instascene_tpu_torch.parallel.sharding import sharded_mean_dist2_knn3
    return sharded_mean_dist2_knn3(torch.as_tensor(pts)).numpy()


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_knn(world, tmp_path):
    """Queries split over 2 and 3 ranks (203 points: the last shard is
    short) against the port's mean_dist2_knn3 and JAX's
    sharded_mean_dist2_knn3 on a mesh of the same size, at rtol 1e-4;
    every rank holds the same result."""
    import jax.numpy as jnp

    from instascene_tpu.parallel.data_parallel import make_mesh
    from instascene_tpu.parallel.sharding import sharded_mean_dist2_knn3
    from instascene_tpu_torch.ops.knn import mean_dist2_knn3
    from instascene_tpu_torch.parallel.launch import launch
    pts = np.random.default_rng(world).normal(size=(203, 3)).astype(
        np.float32)
    outs = launch(_knn_worker, world, pts, device="cpu",
                  store_dir=str(tmp_path))
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    want = mean_dist2_knn3(torch.as_tensor(pts)).numpy()
    jwant = np.asarray(sharded_mean_dist2_knn3(jnp.asarray(pts),
                                               make_mesh(world)))
    np.testing.assert_allclose(outs[0], want, rtol=1e-4)
    np.testing.assert_allclose(outs[0], jwant, rtol=1e-4)


def test_launch_checks_devices_and_backends(tmp_path):
    """--dp N on CUDA with fewer than N devices raises and names their
    count (no GPU here), in both CLIs, before any rank starts; NCCL on the
    CPU and two ranks on one GPU over NCCL are refused; a rank's failure
    comes back with its traceback."""
    from instascene_tpu_torch import train, train_semantic
    from instascene_tpu_torch.parallel.launch import launch
    n = torch.cuda.device_count()
    for cli in (train, train_semantic):
        with pytest.raises(ValueError, match=f"--dp 2: {n} CUDA device"):
            cli.main(["-s", str(tmp_path), "--dp", "2", "--device", "cuda"])
    with pytest.raises(ValueError, match="CPU ranks run over gloo"):
        launch(_knn_worker, 2, None, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="need the gloo backend"):
        launch(_knn_worker, 2, None, device="cuda", shared_device=True)
    with pytest.raises(RuntimeError, match="rank"):
        launch(_knn_worker, 2, None, device="cpu", store_dir=str(tmp_path))


def _cameras(sizes, fovs):
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.data.synthetic import look_at
    cams = []
    for i, ((w, h), fov) in enumerate(zip(sizes, fovs)):
        ang = 2 * np.pi * i / len(sizes)
        R_w2c, t = look_at(np.array([4 * np.cos(ang), 4 * np.sin(ang), 1.0]),
                           np.zeros(3))
        cams.append(Camera(uid=i, colmap_id=i, R=R_w2c.T, T=t, fovx=fov,
                           fovy=fov, image_name=str(i), width=w, height=h,
                           image=np.full((h, w, 3), 0.5, np.float32)))
    return cams


class _Scene:
    """The parts of data/dataset.Scene a GeometryTrainer reads."""

    def __init__(self, cams, n=300, seed=0):
        from types import SimpleNamespace
        rng = np.random.default_rng(seed)
        self.scene_info = SimpleNamespace(point_cloud=SimpleNamespace(
            points=rng.normal(0, 0.5, (n, 3)), colors=rng.random((n, 3))))
        self.cameras_extent = 4.0
        self.model_path = ""
        self._cams = cams

    def get_train_cameras(self):
        return self._cams

    def get_test_cameras(self):
        return []


def _trainer(cams, dp, **opt_kw):
    from instascene_tpu_torch.config import (ModelParams, OptimizationParams,
                                             PipelineParams)
    from instascene_tpu_torch.pipelines.train import GeometryTrainer
    return GeometryTrainer(ModelParams(), OptimizationParams(**opt_kw),
                           PipelineParams(), _Scene(cams), device="cpu",
                           dp=dp)


def _mixed_fov_worker(rank, world, device):
    tr = _trainer(_cameras([(32, 32)] * 2, [0.8, 1.0]), dp=world)
    with pytest.raises(ValueError) as e:
        tr.step(1)
    return str(e.value)


def test_refusals(tmp_path):
    """A mixed-resolution training set is refused by both trainers under
    dp, and a batch of mixed fields of view by the geometry step, with the
    JAX package's messages."""
    from instascene_tpu_torch.config import OptimizationParams
    from instascene_tpu_torch.parallel.launch import launch
    from instascene_tpu_torch.pipelines.train_semantic import SegSplatting
    cams = _cameras([(32, 32), (48, 32)], [0.8, 0.8])
    with pytest.raises(ValueError, match="--dp requires a uniform camera "
                       "resolution; got "):
        _trainer(cams, dp=2)
    seg = SegSplatting.__new__(SegSplatting)
    seg.dp, seg.opt, seg.cam_objs = 2, OptimizationParams(), cams
    with pytest.raises(ValueError, match="--dp requires uniform camera "
                       "resolution; got "):
        seg.train_segfeat()
    msgs = launch(_mixed_fov_worker, 2, device="cpu",
                  store_dir=str(tmp_path))
    for m in msgs:
        assert m.startswith("--dp requires uniform camera intrinsics; got "
                            "tanfovs "), m
