"""The port's bench (instascene_tpu_torch/bench.py) against the root bench.py
and the JAX functions it calls, on the CPU.

Inputs and configs: bench.py's own functions run with their heavy callees
(the steps, rasterize, the binning probes, steady_ms) replaced by recorders,
and so do the port's; each step's camera, segmaps, labels, tiles, window,
target image, learning rates, λ and config flags must be equal. Numbers:
at a small size (--n 2,000 or fewer, --scale 8-16) one step of each
geometry recipe, the 1080p full / viewer / track frames and a frame on
4K's whole tile grid against the JAX functions on the same numpy inputs
(test_torch_bench_semantic.py holds the three semantic variants). Then
main on the CPU: one JSON line with every key, and a path that raises
ends the run with no line."""

import contextlib
import inspect
import io
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jbench
from instascene_tpu_torch import bench as tbench

ATOL, RTOL = 2e-5, 1e-4          # the golden test's own tolerances
CPU = torch.device("cpu")
EXTRA_KEYS = ("semantic_plain_steps_its", "semantic_with_mv_subsampled_its",
              "geometry_train_its", "geometry_train_dist_its",
              "render_1080p_fps", "gui_feature_render_1080p_fps",
              "render_4k_fps", "tracker_view_s", "trained_render_1080p_fps",
              "trained_gui_render_1080p_fps", "trained_geometry_train_its")
PATHS = ("semantic_plain", "semantic_mv", "semantic_mv_sub", "geometry",
         "geometry_dist", "render_1080p", "gui_1080p", "render_4k",
         "tracker", "trained_render_1080p", "trained_gui_1080p",
         "trained_geometry")


def _scenes(n, profile="uniform"):
    """bench.py's scene (JAX) and the port's (numpy state), seed 0."""
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    return (jbench.make_bench_scene(n=n, profile=profile),
            make_bench_scene(n=n, seed=0, profile=profile))


def _jax_params(st):
    from instascene_tpu.models.gaussians import GaussianParams
    return GaussianParams(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in st.items()})


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _args(**kw):
    a = dict(n=300, iters=6, warmup=0, seed=0, scale=1)
    return types.SimpleNamespace(**(a | kw))


@pytest.fixture
def jax_recorders(monkeypatch):
    """bench.py with its steps, rasterize and binning probes recorded, not
    run: steady_ms builds each candidate's run at the base cap and calls
    it six times."""
    from instascene_tpu.ops import rasterize as jr
    from instascene_tpu.pipelines import train as jtrain
    from instascene_tpu.pipelines import train_semantic as jts
    calls = {"semantic": [], "train": [], "raster": [], "iters": {}}

    def steady(make_run, base_cap, iters, extra, name, **kw):
        calls["iters"][name] = iters
        run = make_run(base_cap)
        for _ in range(6):
            run()
        return 1.0

    def sem_step(params, opt_state, key, cam, mv, hyp, scfg):
        calls["semantic"].append((cam, mv, hyp, scfg))
        return params, opt_state, jnp.float32(1.0), None

    def train_step(*a):
        calls["train"].append(a)
        return a[0], a[1], a[2], {"loss": jnp.float32(1.0)}

    def rasterize(*a, **kw):
        # inside bench.py's jitted frame the activations are traced: keep
        # what is concrete (the camera, the config, the features)
        concrete = lambda x: None if isinstance(x, jax.core.Tracer) else x
        calls["raster"].append(([concrete(x) for x in a],
                                {k: concrete(v) for k, v in kw.items()}))
        blend = types.SimpleNamespace(
            color=jnp.zeros((1, 1, 3)), extra=jnp.zeros((1, 1, 16)),
            contrib_ids=jnp.zeros((1, 1, 10), jnp.int32))
        return types.SimpleNamespace(blend=blend)

    monkeypatch.setattr(jbench, "steady_ms", steady)
    monkeypatch.setattr(jbench, "WARMUP_ITERS", 0)
    monkeypatch.setattr(jts, "semantic_train_step", sem_step)
    monkeypatch.setattr(jtrain, "train_step", train_step)
    monkeypatch.setattr(jr, "rasterize", rasterize)
    monkeypatch.setattr(jr, "compute_binning_cache", lambda *a, **kw: (
        jnp.zeros(1), jnp.asarray([1000]), jnp.int32(0)))
    return calls


@pytest.fixture
def port_recorders(monkeypatch):
    """The port's bench with its steps and rasterize recorded, not run."""
    from instascene_tpu_torch.ops import rasterize as tr
    from instascene_tpu_torch.pipelines import train as ttrain
    from instascene_tpu_torch.pipelines import train_semantic as tts
    calls = {"semantic": [], "train": [], "raster": []}

    def sem_step(params, opt_state, cam, mv, hyp, scfg, generator=None):
        calls["semantic"].append((cam, mv, hyp, scfg))
        return params, opt_state, torch.tensor(1.0)

    def train_step(params, opt_state, stats, ct, bg, lrs, **kw):
        calls["train"].append((ct, bg, lrs, kw))
        return params, opt_state, stats, {"loss": torch.tensor(1.0),
                                          "total_pairs": 1}

    def rasterize(*a, **kw):
        calls["raster"].append((a, kw))
        return types.SimpleNamespace(
            blend=types.SimpleNamespace(color=torch.zeros(1)), total_pairs=1)

    monkeypatch.setattr(tts, "semantic_train_step", sem_step)
    monkeypatch.setattr(ttrain, "train_step", train_step)
    monkeypatch.setattr(tr, "rasterize", rasterize)
    return calls


def test_semantic_inputs_match_bench_py(jax_recorders, port_recorders):
    """bench_semantic's steps, both packages: camera i mod 6 at step i with
    its segmaps (default_rng(1)'s 40-label map) and sampler, the 3D labels
    (drawn after it), no window / the 5-view window of views 1-5 / the same
    with default_rng(7)'s 5 x 128 sorted tiles, λ, the learning rates,
    batch 32·1024, 64 labels, the extras_only raster at 976x728; the
    windowed variants run max(5, iters // 3) steps."""
    (jp, jmk), (st, mk) = _scenes(300)
    jbench.bench_semantic(jp, jmk, iters=6)
    tbench.bench_semantic(st, mk, CPU, _args(), {}, {})
    jc, tc = jax_recorders["semantic"], port_recorders["semantic"]
    assert jax_recorders["iters"] == {"semantic_plain": 6, "semantic_mv": 5,
                                      "semantic_mv_sub": 5}
    assert len(jc) == 18 and len(tc) == 6 + 5 + 5
    variants = {"semantic_plain": (0, 0), "semantic_mv": (6, 6),
                "semantic_mv_sub": (12, 11)}
    for name, (j0, t0) in variants.items():
        for i in range(6 if name == "semantic_plain" else 5):
            (jcam, jmv, jhyp, jscfg), (cam, mv, hyp, scfg) = (jc[j0 + i],
                                                              tc[t0 + i])
            for f in ("w2v", "full_proj", "campos", "segmap",
                      "sorted_segmap"):
                np.testing.assert_array_equal(_np(getattr(cam, f)),
                                              _np(getattr(jcam, f)), f)
            for samp in ("seg_samp", "sorted_samp", "vis3d_samp"):
                np.testing.assert_array_equal(_np(getattr(cam, samp)),
                                              _np(getattr(jcam, samp)), samp)
            np.testing.assert_array_equal(_np(hyp.seg3d_labels),
                                          _np(jhyp.seg3d_labels))
            np.testing.assert_array_equal(_np(hyp.bg), _np(jhyp.bg))
            for lam in ("lam_sv", "lam_mv", "lam_3d"):
                assert np.float32(getattr(hyp, lam)) == getattr(jhyp, lam)
            assert hyp.class_feat is None and jhyp.class_feat is None
            assert {k: np.float32(v) for k, v in hyp.lrs.items()} == {
                k: np.float32(v) for k, v in jhyp.lrs.items()}
            assert (scfg.batch, scfg.max_labels, scfg.consider_negative,
                    scfg.mv_merged, scfg.sparse_px) == (
                jscfg.batch, jscfg.max_labels, jscfg.consider_negative,
                jscfg.mv_merged, jscfg.sparse_px) == (32 * 1024, 64, False,
                                                      False, False)
            r, jr = scfg.raster, jscfg.raster
            assert (r.width, r.height) == (jr.width, jr.height) == (976, 728)
            for flag in ("bwd_extras_only", "fwd_viewer", "track_contrib",
                         "no_depth_dist", "clip_rect", "conic_cull"):
                assert getattr(r, flag) == getattr(jr, flag), flag
            if name == "semantic_plain":
                assert mv is None and jmv is None
                continue
            for f in ("w2v", "full_proj", "campos"):
                np.testing.assert_array_equal(
                    np.stack([_np(getattr(c, f)) for c in mv.cams]),
                    _np(getattr(jmv, f)), f)
            np.testing.assert_array_equal(
                np.stack([_np(c.sorted_segmap) for c in mv.cams]),
                _np(jmv.segmaps))
            if name == "semantic_mv":
                assert mv.sel_tiles is None and jmv.sel_tiles is None
            else:
                assert mv.sel_tiles.shape == (5, 128)
                np.testing.assert_array_equal(_np(mv.sel_tiles),
                                              _np(jmv.sel_tiles))


@pytest.mark.parametrize("dist", [False, True], ids=["no_dist", "dist"])
def test_geometry_inputs_match_bench_py(jax_recorders, port_recorders, dist):
    """bench_geometry's steps, both packages: camera i mod 4 at step i, the
    scene without features, default_rng(2)'s target, geometry_lrs(opt,
    1.0, 1e-4), λ (0.2, 0 or 100, 0.05, 0), no normal prior, the recipe's
    depth_ratio and no_depth_dist flag at 976x728; 10 steps."""
    (jp, jmk), (st, mk) = _scenes(300)
    jbench.bench_geometry(jp, jmk, dist=dist)
    tbench.bench_geometry(st, mk, CPU, _args(), {}, {}, "g", dist=dist)
    assert jax_recorders["iters"] == {"geometry": tbench.SAMPLES["geometry"]}
    jc, tc = jax_recorders["train"], port_recorders["train"]
    assert len(tc) == tbench.SAMPLES["geometry"]
    for i, a in enumerate(jc):
        ct, bg, lrs, kw = tc[i]
        assert a[0].seg_feature is None
        for j, f in enumerate(("w2v", "full_proj", "campos", "c2w_rot",
                               "gt_image"), start=3):
            np.testing.assert_array_equal(_np(getattr(ct, f)), _np(a[j]), f)
        assert ct.normal_prior is None and a[-1] is False
        np.testing.assert_array_equal(_np(bg), _np(a[10]))
        assert {k: np.float32(v) for k, v in lrs.items()} == {
            k: np.float32(v) for k, v in a[11].items()}
        lam = (kw["lambda_dssim"], kw["lambda_dist"], kw["lambda_normal"],
               kw["lambda_normal_prior"])
        assert tuple(np.float32(x) for x in lam) == tuple(
            np.float32(x) for x in a[12:16]) == tuple(np.float32(x) for x in (
                0.2, 100.0 if dist else 0.0, 0.05, 0.0))
        cfg, jcfg = kw["cfg"], a[16]
        assert (cfg.width, cfg.height) == (jcfg.width, jcfg.height) == (
            976, 728)
        for flag in ("no_depth_dist", "bwd_extras_only", "fwd_viewer",
                     "track_contrib", "clip_rect", "conic_cull"):
            assert getattr(cfg, flag) == getattr(jcfg, flag), flag
        assert (np.float32(ct.tanfovx), np.float32(ct.tanfovy)) == (
            np.float32(a[17]), np.float32(a[18]))
        assert kw["depth_ratio"] == a[19] == (0.0 if dist else 1.0)


FRAMES = {"render_1080p": (tbench.FRAME_1080P, "full"),
          "gui_1080p": (tbench.FRAME_1080P, "viewer"),
          "render_4k": (tbench.FRAME_4K, "full"),
          "tracker": (tbench.TRACKER, "track")}


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_configs_match_bench_py(jax_recorders, port_recorders, name):
    """Each frame path's rasterize call, both packages: camera 0 at the
    path's size, the activated scene, SH 3 from the features, a black
    background, the mode's flags, the normalised features where the mode
    splats them; bench.py's sample counts."""
    (jp, jmk), (st, mk) = _scenes(300)
    size, mode = FRAMES[name]
    if mode == "track":
        jbench.bench_tracker_view(jp, jmk)
        assert inspect.signature(jbench.bench_tracker_view).parameters[
            "iters"].default == tbench.SAMPLES["tracker"]
    else:
        jbench.bench_render_fps(jp, jmk, *size, viewer=mode == "viewer",
                                name=name)
        want = 8 if size == tbench.FRAME_4K else 20
        assert "iters=8" in inspect.getsource(jbench.main)
        assert tbench.SAMPLES["render_4k" if want == 8 else "render"] == want
    samples = 3
    tbench.bench_frames(st, mk, CPU, _args(), {}, {}, name, size, mode,
                        samples)
    (ja, jkw), (ta, tkw) = (jax_recorders["raster"][-1],
                            port_recorders["raster"][-1])
    assert len(port_recorders["raster"]) == samples
    # bench.py activates the scene inside its jitted frame
    for got, want in zip(ta[:4], (jp.xyz, jp.scaling_activated(),
                                  jp.rotation_normalized(),
                                  jp.opacity_activated()[:, 0])):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)
    for f in ("w2v", "full_proj", "campos"):
        np.testing.assert_array_equal(_np(getattr(ta[4], f)),
                                      _np(getattr(ja[4], f)), f)
    np.testing.assert_array_equal(_np(ta[5]), np.zeros(3))  # jnp.zeros(3)
    cfg, jcfg = ta[6], ja[6]
    assert (cfg.width, cfg.height) == (jcfg.width, jcfg.height) == size
    for flag in ("fwd_viewer", "track_contrib", "bwd_extras_only",
                 "no_depth_dist", "clip_rect", "conic_cull"):
        assert getattr(cfg, flag) == getattr(jcfg, flag), flag
    assert tkw["sh_degree"] == jkw["sh_degree"] == 3
    np.testing.assert_array_equal(_np(tkw["shs"]), _np(jp.features()))
    assert (tkw.get("extras") is None) == (jkw.get("extras") is None) == (
        mode == "full")
    if mode != "full":
        np.testing.assert_allclose(_np(tkw["extras"]), _np(jkw["extras"]),
                                   rtol=1e-6, atol=1e-7)


def _jax_cam(cam):
    from instascene_tpu.ops.rasterize import CameraMats
    return CameraMats(*(jnp.asarray(_np(getattr(cam, f)))
                        for f in ("w2v", "full_proj", "campos")))


def _frame_vs_jax(st, mk, size, mode, scale, **jcfg):
    """The port's bench frame, the same frame on JAX's splat transforms
    (the port's T moved onto JAX's through the t_offset tap), and JAX's
    rasterize on the same activated inputs, with JAX's config `jcfg` →
    (port RasterizeOut, port on JAX's T, JAX RasterizeOut)."""
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.ops.rasterize import rasterize as jrasterize
    from instascene_tpu_torch.ops.rasterize import rasterize
    p, cam, cfg, extras = tbench.frame_setup(st, mk, CPU, size, mode, scale)
    j = lambda x: jnp.asarray(_np(x))
    jout = jrasterize(
        j(p.xyz), j(p.scaling_activated()), j(p.rotation_normalized()),
        j(p.opacity_activated()[:, 0]), _jax_cam(cam), jnp.zeros(3),
        JCfg(width=cfg.width, height=cfg.height, fwd_viewer=cfg.fwd_viewer,
             track_contrib=cfg.track_contrib, tune_gather=False, **jcfg),
        shs=j(p.features()), sh_degree=3,
        extras=None if extras is None else j(extras))
    assert int(jout.n_dropped) == 0
    with torch.no_grad():
        out = tbench.frame(p, cam, cfg, extras)
        on_jax_T = rasterize(
            p.xyz, p.scaling_activated(), p.rotation_normalized(),
            p.opacity_activated()[:, 0], cam, torch.zeros(3), cfg,
            shs=p.features(), sh_degree=3, extras=extras,
            t_offset=torch.as_tensor(np.array(jout.T)) - out.T)
    assert out.total_pairs > 0
    return out, on_jax_T, jout


def _beyond(b, jb, key, atol, rtol):
    """[H, W] pixels where map `key` differs beyond atol / rtol."""
    bad = ~np.isclose(_np(getattr(b, key)), _np(getattr(jb, key)),
                      atol=atol, rtol=rtol)
    return bad.any(-1) if bad.ndim == 3 else bad


def _maps(mode):
    keys = ["color", "alpha", "final_T"]
    if mode != "viewer":
        keys += ["depth", "normal", "median_depth", "distortion"]
    return keys + (["extra"] if mode != "full" else [])


# the JAX suite's tolerances between its XLA blend and its Pallas kernel
# (tests/test_blend_pallas.py:83-90), as tests/test_torch_render.py carries
# them
TWIN_TOL = {"color": 3e-4, "alpha": 2e-5, "final_T": 2e-5, "depth": 3e-3,
            "normal": 3e-4, "median_depth": 3e-3, "distortion": 3e-3,
            "extra": 5e-4}


def _check_own_preprocess(out, jout, share):
    """The port's own frame: its splat transforms within float32 rounding
    of JAX's (test_torch_render's 1e-3), and n_contrib equal on all but
    `share` of the pixels — a splat transform re-rounded in float32 can
    move one contribution across the 1/255 alpha cut or the T floor."""
    np.testing.assert_allclose(_np(out.T), _np(jout.T), atol=1e-3, rtol=0)
    moved = _np(out.blend.n_contrib) != _np(jout.blend.n_contrib)
    assert moved.sum() <= share * moved.size, int(moved.sum())


@pytest.mark.parametrize("name", ["render_1080p", "gui_1080p", "tracker"])
def test_frames_match_jax(name):
    """The 1080p full and viewer frames and the tracker view at 1/8 size
    (2,000 gaussians) against JAX's rasterize on its Pallas path (the one
    bench.py runs; interpret mode): on JAX's splat transforms every map at
    atol 2e-5 / rtol 1e-4, n_contrib equal, the tracker's contributor ids
    equal and weights within the same tolerance; on the port's own, n_contrib
    equal on all but 1e-4 of the pixels."""
    _, (st, mk) = _scenes(2000)
    size, mode = FRAMES[name]
    out, on_jax_T, jout = _frame_vs_jax(st, mk, size, mode, 8,
                                        impl="pallas", pair_cap=8192)
    b, jb = on_jax_T.blend, jout.blend
    np.testing.assert_array_equal(_np(b.n_contrib), _np(jb.n_contrib))
    assert _np(b.n_contrib).max() > 0
    for k in _maps(mode):
        np.testing.assert_allclose(_np(getattr(b, k)), _np(getattr(jb, k)),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    if mode == "track":
        np.testing.assert_array_equal(_np(b.contrib_ids),
                                      _np(jb.contrib_ids))
        np.testing.assert_allclose(_np(b.contrib_w), _np(jb.contrib_w),
                                   atol=ATOL, rtol=RTOL)
    _check_own_preprocess(out, jout, 1e-4)


def test_4k_grid_frame_matches_jax():
    """A frame on 4K's whole tile grid (3840x2160, 240 x 135 tiles; one
    launch in the port, where the JAX package's TPU path may cut slabs) with
    300 gaussians, against JAX's rasterize on its CPU path, which renders
    the whole frame (its XLA blend; tile_cap 32 holds every tile's pairs):
    on JAX's splat transforms n_contrib equal and every map within the JAX
    suite's XLA-vs-Pallas tolerances on all but 1e-5 of the pixels (the
    XLA blend rounds alpha in another order than the kernels, which the
    port follows); on the port's own, n_contrib equal on all but 1e-5 of
    the pixels, the full-width frame's bound in chip_smoke.py."""
    _, (st, mk) = _scenes(300)
    out, on_jax_T, jout = _frame_vs_jax(st, mk, tbench.FRAME_4K, "full", 1,
                                        pair_cap=8192, tile_cap=32)
    assert out.blend.color.shape == (2160, 3840, 3)
    b, jb = on_jax_T.blend, jout.blend
    np.testing.assert_array_equal(_np(b.n_contrib), _np(jb.n_contrib))
    assert _np(b.n_contrib).max() > 0
    for k in _maps("full"):
        bad = _beyond(b, jb, k, TWIN_TOL[k], 1e-5)
        assert bad.sum() <= 1e-5 * bad.size, (k, int(bad.sum()))
    _check_own_preprocess(out, jout, 1e-5)


GEOM_N, GEOM_SCALE = 2000, 16


@pytest.mark.parametrize("dist", [False, True], ids=["no_dist", "dist"])
def test_geometry_step_matches_jax(dist):
    """One step of each geometry recipe on the bench's inputs at 1/16 size
    (2,000 gaussians) against JAX's train_step: the loss at rtol 1e-4,
    each field's gradient (Adam's first moment) within 3e-3 (`full`) /
    5e-3 (`no_dist`) of its largest, the densification stats within 2e-3
    of their largest, visibility counts and radii equal."""
    from instascene_tpu.models import densify as jdens
    from instascene_tpu.models.optimizer import init_adam_state as jinit
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.pipelines import train as jtrain
    from instascene_tpu_torch.pipelines.train import train_step
    _, (st, mk) = _scenes(GEOM_N)
    p, opt, stats, cams, lrs, kw = tbench.geometry_inputs(st, mk, "cpu",
                                                          GEOM_SCALE, dist)
    ct = cams[0]
    bg = torch.zeros(3)
    _, topt, tst, tm = train_step(p, opt, stats, ct, bg, lrs, **kw)

    jp = _jax_params({**st, "seg_feature": None})
    cfg = kw["cfg"]
    j = lambda x: jnp.asarray(_np(x))
    dummy = jnp.zeros(1)
    _, jopt, jst, jm = jtrain.train_step(
        jp, jinit(jp), jdens.init_stats(jp.capacity), j(ct.w2v),
        j(ct.full_proj), j(ct.campos), j(ct.c2w_rot), j(ct.gt_image), dummy,
        dummy, jnp.zeros(3), {k: jnp.float32(v) for k, v in lrs.items()},
        *(jnp.float32(kw[k]) for k in ("lambda_dssim", "lambda_dist",
                                       "lambda_normal",
                                       "lambda_normal_prior")),
        JCfg(width=cfg.width, height=cfg.height,
             no_depth_dist=cfg.no_depth_dist, tune_gather=False),
        ct.tanfovx, ct.tanfovy, kw["depth_ratio"], False)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    tol = 5e-3 if cfg.no_depth_dist else 3e-3
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        got, want = _np(topt.m[f]), _np(getattr(jopt.m, f))
        scale = np.abs(want).max()
        if f != "features_rest":    # SH rest starts at zero: no gradient
            assert scale > 0, f
        assert np.abs(got - want).max() <= tol * scale, f
    np.testing.assert_array_equal(_np(tst.denom), _np(jst.denom))
    np.testing.assert_array_equal(_np(tst.max_radii2d), _np(jst.max_radii2d))
    # zero in both on this scene of near-filter-floor splats, whose
    # screen-space filter branch carries no dL/dT
    acc, jacc = _np(tst.xyz_gradient_accum), _np(jst.xyz_gradient_accum)
    np.testing.assert_allclose(acc, jacc, atol=2e-3 * jacc.max(), rtol=0)


MAIN_ARGS = ["--device", "cpu", "--n", "300", "--scale", "16", "--iters",
             "1", "--warmup", "0"]


def test_main_prints_one_json_line(monkeypatch):
    """main on the CPU at a tiny size (one sample of each path bench.py
    fixes, 1,024 draws a set, one torch thread): exactly one stdout line, a
    JSON object with bench.py's keys (every extra finite and > 0), device
    "cpu", each path's samples, median, min/max ms and launches (none: the
    plain versions launch nothing), and the pairs of the 1080p and 4K
    frames."""
    for k in tbench.SAMPLES:
        monkeypatch.setitem(tbench.SAMPLES, k, 1)
    monkeypatch.setitem(tbench.SEM, "batch", 1024)
    threads = torch.get_num_threads()
    buf = io.StringIO()
    try:
        torch.set_num_threads(1)
        with contextlib.redirect_stdout(buf):
            ret = tbench.main(MAIN_ARGS)
    finally:
        torch.set_num_threads(threads)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(ret))
    assert set(line) >= {"metric", "value", "unit", "vs_baseline", "extra",
                         "device", "paths", "pairs", "peak_memory_bytes"}
    assert line["device"] == "cpu" and line["unit"] == "it/s"
    assert set(line["extra"]) == set(EXTRA_KEYS)
    for v in [line["value"], line["vs_baseline"], *line["extra"].values()]:
        assert np.isfinite(v) and v > 0
    np.testing.assert_allclose(line["vs_baseline"], line["value"] / (
        10_000 / 1200), rtol=1e-12)
    assert set(line["paths"]) == set(PATHS)
    for name, r in line["paths"].items():
        assert r["min_ms"] <= r["median_ms"] <= r["max_ms"], name
        assert r["launches"] == {}, name
    assert line["paths"]["semantic_plain"]["samples"] == 1
    assert line["paths"]["semantic_mv"]["samples"] == 5
    assert line["paths"]["render_4k"]["samples"] == 1
    assert line["pairs"]["render_1080p"] > 0 and line["pairs"][
        "render_4k"] > 0
    t = {k: line["paths"][k]["median_ms"] for k in PATHS}
    np.testing.assert_allclose(line["value"], 1e3 / (
        0.9 * t["semantic_plain"] + 0.1 * t["semantic_mv"]), rtol=1e-12)


def test_a_failing_path_prints_no_line(monkeypatch):
    """A path that raises (the 4K frame here, after the semantic and
    geometry paths have run) ends main with that error and no line; so does
    a count below its range; with no GPU and no --device, main refuses,
    naming the visible count."""
    def frames(st, make_cam, dev, args, paths, pairs, name, size, mode, n):
        if size == tbench.FRAME_4K:
            raise RuntimeError("the 4K frame failed")
        return 1.0
    monkeypatch.setattr(tbench, "bench_semantic", lambda *a: (1.0, 1.0, 1.0))
    monkeypatch.setattr(tbench, "bench_geometry", lambda *a, **kw: 1.0)
    monkeypatch.setattr(tbench, "bench_frames", frames)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(
            RuntimeError, match="the 4K frame failed"):
        tbench.main(MAIN_ARGS)
    assert buf.getvalue() == ""
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        tbench.main(["--device", "cpu", "--iters", "0"])
    assert buf.getvalue() == ""
    if not torch.cuda.is_available():
        with contextlib.redirect_stdout(buf), pytest.raises(
                RuntimeError, match="0 are visible"):
            tbench.main([])
        assert buf.getvalue() == ""
