"""The data-parallel train steps of the port (parallel/data_parallel.py) on
the CPU over gloo, against the JAX package's build_dp_train_step and
build_dp_semantic_step on a mesh of 2 of its virtual CPU devices, on the
same numpy inputs: each camera of the batch on its own rank, the ranks bit
for bit equal, a world of one bit for bit the single-camera step, and the
GeometryTrainer's replicas equal after densification grew their capacity.

The ranks are spawned processes that import this module: the workers sit
at its top level and every JAX import stays inside the test functions."""

import os
import shutil

import numpy as np
import pytest
import torch

W, H = 64, 48
N = 300
CAMS = (3, 5)
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
RECIPES = {
    # the reference defaults: lambda_dist 0, depth_ratio 1 (kernels no_dist)
    "no_dist": dict(lambda_dist=0.0, depth_ratio=1.0, prior=False),
    # 2DGS bounded scenes (--lambda_dist 100 --depth_ratio 0), with a
    # mono-normal prior (kernels full)
    "full": dict(lambda_dist=100.0, depth_ratio=0.0, prior=True),
}
LRS = {"xyz": 1.6e-4 * 4.4, "features_dc": 2.5e-3,
       "features_rest": 2.5e-3 / 20, "opacity": 0.05, "scaling": 5e-3,
       "rotation": 1e-3, "seg_feature": 0.0}


def _inputs(recipe):
    """tests/test_torch_train_step.py's state (the `trained` profile at N,
    surfels 12x larger, SH 3, the last 10 slots dead), warm Adam moments,
    stats, and two orbit cameras with their own targets (and normal
    priors): (state, [camera kwargs], m, v, count, stats0)."""
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    rc = RECIPES[recipe]
    st, mk = make_bench_scene(n=N, seed=4, profile="trained")
    rng = np.random.default_rng(4)
    st["scaling"] = (st["scaling"] + np.log(12.0)).astype(np.float32)
    st["features_rest"] = rng.normal(0, 0.2, (N, 15, 3)).astype(np.float32)
    st["seg_feature"] = None
    st["alive"] = np.arange(N) < N - 10
    rng = np.random.default_rng(21)
    cams = []
    for i in CAMS:
        c = mk(i, W, H)
        normal = None
        if rc["prior"]:
            normal = rng.normal(size=(H, W, 3)).astype(np.float32)
            normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
            normal[::5] *= 1.5           # pixels outside the prior's mask
        cams.append(dict(uid=i, colmap_id=i, R=c.R, T=c.T, fovx=c.fovx,
                         fovy=c.fovy, image_name=str(i), width=W, height=H,
                         image=rng.random((H, W, 3)).astype(np.float32),
                         normal=normal))
    rng = np.random.default_rng(9)
    m = {f: (rng.normal(size=st[f].shape) * 1e-3).astype(np.float32)
         for f in FIELDS}
    v = {f: ((np.abs(rng.normal(size=st[f].shape)) + 0.5) * 1e-3
             ).astype(np.float32) ** 2 for f in FIELDS}
    stats0 = [np.random.default_rng(5).random(N).astype(np.float32) * s
              for s in (1e-3, 3.0, 5.0)]
    return st, cams, m, v, 100, stats0


def _lam(recipe):
    rc = RECIPES[recipe]
    return (0.2, rc["lambda_dist"], 0.05, 0.1 if rc["prior"] else 0.0)


def _port_state(recipe):
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.models import densify as dens
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.models.optimizer import AdamState
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines.train import camera_tensors
    st, cams, m, v, count, stats0 = _inputs(recipe)
    t = lambda d: {f: torch.as_tensor(a) for f, a in d.items()}
    state = (from_numpy(st, "cpu"), AdamState(m=t(m), v=t(v), count=count),
             dens.DensifyStats(*map(torch.as_tensor, stats0)))
    cts = [camera_tensors(Camera(**kw), "cpu") for kw in cams]
    cfg = RasterizeConfig(W, H, no_depth_dist=recipe == "no_dist")
    return state, cts, cfg


def _host(state, metrics):
    p, o, s = state
    return {"params": {f: getattr(p, f).numpy() for f in FIELDS},
            "m": {f: o.m[f].numpy() for f in FIELDS},
            "v": {f: o.v[f].numpy() for f in FIELDS}, "count": o.count,
            "stats": [a.numpy() for a in s],
            "metrics": {k: float(x) for k, x in metrics.items()}}


def _geometry_worker(rank, world, device, recipes):
    """{recipe: result} of _geometry_step for each recipe."""
    return {r: _geometry_step(rank, world, r) for r in recipes}


def _geometry_step(rank, world, recipe):
    """This rank's camera through dp_train_step; rank 0 also returns the
    single-process reference: with world 2 the mean of both cameras'
    step_gradients (camera 0's depth, the visibility of either, the larger
    radii) through apply_gradients, with world 1 train_step itself."""
    from instascene_tpu_torch.parallel.data_parallel import dp_train_step
    from instascene_tpu_torch.pipelines import train as ttrain
    state, cts, cfg = _port_state(recipe)
    rc = RECIPES[recipe]
    args = (torch.zeros(3), LRS, *_lam(recipe))
    *out, m = dp_train_step(*state, cts[rank], *args, cfg, rc["depth_ratio"])
    res = {"dp": _host(out, m)}
    if rank == 0 and world == 1:
        *ref, rm = ttrain.train_step(*state, cts[0], *args, cfg,
                                     rc["depth_ratio"])
        res["ref"] = _host(ref, rm)
    elif rank == 0:
        sgs = [ttrain.step_gradients(state[0], ct, args[0], *args[2:], cfg,
                                     rc["depth_ratio"]) for ct in cts]
        a, b = sgs
        mean = lambda x, y: (x + y) / 2
        aux = {k: mean(a.aux[k], b.aux[k]) for k in ("ll1", "dist", "normal")}
        aux.update(depth=a.aux["depth"],
                   visible=a.aux["visible"] | b.aux["visible"],
                   radii=torch.maximum(a.aux["radii"], b.aux["radii"]),
                   total_pairs=max(a.aux["total_pairs"],
                                   b.aux["total_pairs"]))
        sg = ttrain.StepGrads(mean(a.loss, b.loss), {
            f: mean(a.grads[f], b.grads[f]) for f in a.grads},
            mean(a.t_grad, b.t_grad), aux)
        *ref, rm = ttrain.apply_gradients(*state, sg, LRS, cfg)
        res["ref"] = _host(ref, rm)
    return res


def _assert_same(a, b):
    for k in ("params", "m", "v"):
        for f in FIELDS:
            np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=(k, f))
    assert a["count"] == b["count"]
    for x, y in zip(a["stats"], b["stats"]):
        np.testing.assert_array_equal(x, y)
    assert a["metrics"] == b["metrics"]


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_dp_train_step_matches_jax(recipe, tmp_path):
    """World 2, one camera per rank: the ranks bit for bit equal, bit for
    bit the mean of the two cameras' gradients through one Adam step, and
    against JAX's build_dp_train_step on a mesh of 2: the loss at rtol
    1e-4, every parameter within 5e-3, visibility counts and radii equal,
    the densification stats (device 0's, as JAX returns them) within 2e-3
    of their largest value."""
    import jax.numpy as jnp

    from instascene_tpu.cameras import Camera as JCamera
    from instascene_tpu.models import densify as jdens
    from instascene_tpu.models.gaussians import GaussianParams
    from instascene_tpu.models.optimizer import AdamState as JAdam
    from instascene_tpu.models.optimizer import init_adam_state as jinit
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.parallel.data_parallel import (build_dp_train_step,
                                                       lrs_vector, make_mesh)
    from instascene_tpu.pipelines import train as jtrain
    from instascene_tpu_torch.parallel.launch import launch
    rc = RECIPES[recipe]
    outs = [o[recipe] for o in launch(_geometry_worker, 2, [recipe],
                                      device="cpu", store_dir=str(tmp_path))]
    _assert_same(outs[0]["dp"], outs[1]["dp"])
    _assert_same(outs[0]["dp"], outs[0]["ref"])

    st, cams, m, v, count, stats0 = _inputs(recipe)
    jp = GaussianParams(**{k: (jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a) for k, a in st.items()})
    jopt = jinit(jp)
    jopt = JAdam(m=jopt.m.replace(**{f: jnp.asarray(a) for f, a in m.items()}),
                 v=jopt.v.replace(**{f: jnp.asarray(a) for f, a in v.items()}),
                 count=jnp.asarray(count, jnp.int32))
    jcts = [jtrain.camera_tensors(JCamera(**kw)) for kw in cams]
    stack = lambda f: jnp.stack([f(ct) for ct in jcts])
    step = build_dp_train_step(
        JCfg(width=W, height=H, chunk=16, pair_cap=65536, tile_cap=256),
        jcts[0].tanfovx, jcts[0].tanfovy, rc["depth_ratio"], make_mesh(2),
        has_normal_prior=rc["prior"])
    prior = ((stack(lambda ct: ct.normal_prior),
              stack(lambda ct: ct.normal_mask)) if rc["prior"]
             else (jnp.zeros((2, 1, 1, 1)), jnp.zeros((2, 1, 1))))
    jp2, jopt2, jst2, jm = step(
        jp, jopt, jdens.DensifyStats(*map(jnp.asarray, stats0)),
        stack(lambda ct: ct.w2v), stack(lambda ct: ct.full_proj),
        stack(lambda ct: ct.campos), stack(lambda ct: ct.c2w_rot),
        stack(lambda ct: ct.gt_image), *prior, jnp.zeros(3),
        lrs_vector(LRS), *map(jnp.float32, _lam(recipe)))

    got = outs[0]["dp"]
    assert got["count"] == count + 1 == int(jopt2.count)
    for k in ("loss", "ll1", "dist", "normal"):
        np.testing.assert_allclose(got["metrics"][k], float(jm[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    for f in FIELDS:
        np.testing.assert_allclose(got["params"][f],
                                   np.asarray(getattr(jp2, f)), atol=5e-3,
                                   rtol=0, err_msg=f)
        moved = got["params"][f] != st[f]
        assert not moved[~st["alive"]].any(), f"{f}: a dead slot moved"
    acc, denom, radii = got["stats"]
    np.testing.assert_array_equal(denom, np.asarray(jst2.denom))
    np.testing.assert_array_equal(radii, np.asarray(jst2.max_radii2d))
    grew = np.asarray(jst2.xyz_gradient_accum) - stats0[0]
    assert grew.max() > 0, "the t_offset tap gave no densification grads"
    np.testing.assert_allclose(acc - stats0[0], grew, atol=2e-3 * grew.max(),
                               rtol=0)


def test_world_of_one_is_train_step(tmp_path):
    """dp_train_step over a world of one (gloo) is train_step bit for bit,
    in both recipes: parameters, Adam state, stats and metrics."""
    from instascene_tpu_torch.parallel.launch import launch
    (outs,) = launch(_geometry_worker, 1, list(RECIPES), device="cpu",
                     store_dir=str(tmp_path))
    for out in outs.values():
        _assert_same(out["dp"], out["ref"])


def _trainer_worker(rank, world, device):
    """A GeometryTrainer rank on 600 random points (capacity 1,024) and
    four 32x32 cameras, 6 steps with densification at the 3rd and the 6th
    at a threshold every seen gaussian passes: the state digests after
    each densification, and the capacity at the end."""
    from test_torch_parallel import _cameras, _Scene

    from instascene_tpu_torch.config import (ModelParams, OptimizationParams,
                                             PipelineParams)
    from instascene_tpu_torch.parallel.data_parallel import (gather_notes,
                                                             state_digest)
    from instascene_tpu_torch.pipelines.train import GeometryTrainer
    cams = _cameras([(32, 32)] * 4, [0.8] * 4)
    rng = np.random.default_rng(1)
    for c in cams:
        c.image = rng.random((32, 32, 3)).astype(np.float32)
    tr = GeometryTrainer(
        ModelParams(), OptimizationParams(
            densify_from_iter=2, densification_interval=3,
            densify_grad_threshold=1e-9, opacity_cull=1e-4),
        PipelineParams(), _Scene(cams, n=600), device="cpu",
        capacity_multiplier=1.0, dp=world)
    digests = []
    for it in range(1, 7):
        tr.step(it)
        if it % 3 == 0:
            digests.append(state_digest(tr.params, tr.opt_state, tr.stats))
    return {"digests": gather_notes(digests), "capacity": tr.params.capacity,
            "n_alive": tr.params.n_alive()}


def test_trainer_replicas_stay_equal(tmp_path):
    """Two GeometryTrainer ranks pop the same cameras, densify alike and
    double their capacity alike: after every densification the ranks'
    parameters, Adam state and stats are bit for bit equal."""
    from instascene_tpu_torch.parallel.launch import launch
    outs = launch(_trainer_worker, 2, device="cpu", store_dir=str(tmp_path))
    a, b = outs[0]["digests"]
    assert a == b and len(a) == 2
    assert outs[0]["capacity"] > 1024, "the capacity never grew"
    assert outs[0]["n_alive"] > 600


# ---- the semantic step


MAX_LABELS = 8
BATCH = 512


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """tests/test_torch_semantic_step.py's scene: the e2e scene with
    sam/mask_sorted = sam/mask, random features and class anchors, the
    blobs' 3D labels."""
    from scene_builder import build_e2e_scene
    d = tmp_path_factory.mktemp("dpstep") / "parent" / "scene"
    _, labels, _ = build_e2e_scene(str(d))
    shutil.copytree(os.path.join(d, "sam", "mask"),
                    os.path.join(d, "sam", "mask_sorted"))
    rng = np.random.default_rng(8)
    feat = rng.random((len(labels), 16)).astype(np.float32)
    cf = rng.random((MAX_LABELS, 16)).astype(np.float32)
    cf /= np.linalg.norm(cf, axis=1, keepdims=True)
    return str(d), labels.astype(np.int32), feat, cf


def _warm_features(n, seed=11):
    rng = np.random.default_rng(seed)
    m = (rng.normal(size=(n, 16)) * 1e-3).astype(np.float32)
    v = ((np.abs(rng.normal(size=(n, 16))) + 0.5) * 1e-3
         ).astype(np.float32) ** 2
    return m, v, 100


def _semantic_worker(rank, world, device, src, labels, feat, cf, draws,
                     out):
    """This rank's camera CAMS[rank] through dp_semantic_step with its
    injected draws, from a warm Adam state: (new features, loss)."""
    from instascene_tpu_torch.config import (ModelParams, OptimizationParams,
                                             PipelineParams)
    from instascene_tpu_torch.models.optimizer import (init_adam_state,
                                                       semantic_lrs)
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.parallel.data_parallel import dp_semantic_step
    from instascene_tpu_torch.pipelines import train_semantic as ts
    seg = ts.SegSplatting(ModelParams(source_path=src, use_seg_feature=True),
                          OptimizationParams(), PipelineParams(),
                          output_root=out, device="cpu")
    seg._load_scene()
    seg.params = seg.params.replace(seg_feature=torch.as_tensor(feat))
    seg.seg3d_labels_padded = torch.as_tensor(labels)
    seg._precompute_binning()
    seg._precompute_sampling()
    cam = seg._camera_bundles()[CAMS[rank]]
    state = init_adam_state(seg.params)
    m, v, count = _warm_features(len(feat))
    state.m["seg_feature"] = torch.as_tensor(m)
    state.v["seg_feature"] = torch.as_tensor(v)
    state.count = count
    hyp = ts.SemanticHypers(
        bg=seg.bg, lrs=semantic_lrs(OptimizationParams()), lam_sv=1.0,
        lam_mv=0.0, lam_3d=0.5, seg3d_labels=torch.as_tensor(labels),
        class_feat=torch.as_tensor(cf))
    scfg = ts.SemanticStepConfig(
        raster=RasterizeConfig(W, H, bwd_extras_only=True), batch=BATCH,
        max_labels=MAX_LABELS, consider_negative=True)
    p, _, loss = dp_semantic_step(seg.params, state, cam, hyp, scfg,
                                  draws=draws[rank])
    return p.seg_feature.numpy(), float(loss)


def test_dp_semantic_step_matches_jax(e2e, tmp_path):
    """World 2, one camera per rank, JAX's per-camera draws (replayed from
    key[b] as build_dp_semantic_step splits it) injected, class anchors
    and consider_negative: the loss at rtol 1e-4 and the feature update
    within 3e-3 of its largest |value| against build_dp_semantic_step on
    a mesh of 2 from the same warm Adam state; the ranks bit for bit
    equal."""
    import jax
    import jax.numpy as jnp

    from instascene_tpu.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from instascene_tpu.models.optimizer import AdamState as JAdam
    from instascene_tpu.models.optimizer import init_adam_state as jinit
    from instascene_tpu.models.optimizer import semantic_lrs as jlrs
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.parallel.data_parallel import (
        build_dp_semantic_step, make_mesh)
    from instascene_tpu.pipelines import train_semantic as jts
    from instascene_tpu.pipelines.train_semantic import SegSplatting
    from instascene_tpu.semantic.contrastive import sample_from_ids
    from instascene_tpu_torch.parallel.launch import launch
    src, labels, feat, cf = e2e
    jseg = SegSplatting(ModelParams(source_path=src, use_seg_feature=True),
                        OptimizationParams(), PipelineParams(),
                        output_root=str(tmp_path / "j"))
    jseg._load_scene()
    jseg.params = jseg.params.replace(seg_feature=jnp.asarray(feat))
    jseg.seg3d_labels_padded = jnp.asarray(labels)
    jseg._precompute_binning()
    jseg._precompute_sampling()
    jb = jseg._camera_bundles()
    cams = [jb[i] for i in CAMS]
    keys = jax.random.split(jax.random.PRNGKey(5), len(CAMS))
    jcf = jnp.asarray(cf)
    draws = []
    for key, cam in zip(keys, cams):
        sv, k3 = jts._draw_sv_pixel_idx(key, cam.segmap, cam.sorted_segmap,
                                        jcf, BATCH, True, True, cam.seg_samp,
                                        cam.sorted_samp)
        _, sub = jax.random.split(k3)
        draws.append({"sv": [np.asarray(d[0]) for d in sv],
                      "d3": np.asarray(sample_from_ids(
                          sub, cam.vis3d_samp, BATCH)[0])})
    outs = launch(_semantic_worker, 2, src, labels, feat, cf, draws,
                  str(tmp_path / "t"), device="cpu", store_dir=str(tmp_path))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]

    m, v, count = _warm_features(len(feat))
    jopt = jinit(jseg.params)
    jopt = JAdam(m=jopt.m.replace(seg_feature=jnp.asarray(m)),
                 v=jopt.v.replace(seg_feature=jnp.asarray(v)),
                 count=jnp.asarray(count, jnp.int32))
    cb_len = len(jseg.binning_cache[0])
    step = build_dp_semantic_step(
        JCfg(width=W, height=H, bwd_extras_only=True, extras_dim=16),
        make_mesh(2), batch=BATCH, max_labels=MAX_LABELS, lam_sv=1.0,
        lam_3d=0.5, consider_negative=True, has_class_feat=True,
        has_sampler=True, has_cached_binning=True, cb_len=cb_len)
    stk = lambda f: jnp.stack([f(c) for c in cams])
    cb = tuple(jnp.stack([jseg.binning_cache[i][f] for i in CAMS])
               for f in range(cb_len))
    jp2, _, jloss = step(
        jseg.params, jopt, keys, stk(lambda c: c.w2v),
        stk(lambda c: c.full_proj), stk(lambda c: c.campos),
        stk(lambda c: c.segmap), stk(lambda c: c.sorted_segmap),
        jnp.asarray(labels), jcf, jseg.bg,
        jnp.float32(jlrs(OptimizationParams())["seg_feature"]), cb,
        stk(lambda c: c.seg_samp), stk(lambda c: c.sorted_samp),
        stk(lambda c: c.vis3d_samp))
    np.testing.assert_allclose(outs[0][1], float(jloss), rtol=1e-4)
    want = np.asarray(jp2.seg_feature) - feat
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs((outs[0][0] - feat) - want).max() <= 3e-3 * scale
