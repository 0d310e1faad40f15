"""The slice as a whole: the port's rasterize()/render() against the
committed goldens and against JAX render() (Pallas path in interpret mode)
over the whole key set, viewer and full."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "forward.npz")
ATOL, RTOL = 2e-5, 1e-4          # the golden test's own tolerances


def _golden():
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.data.synthetic import look_at
    g = np.load(GOLDEN)
    W, H = int(g["W"]), int(g["H"])
    R_w2c, t = look_at(np.array([0.0, -3.5, 1.0]), np.zeros(3))
    cam = Camera(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=0.9, fovy=0.65,
                 image_name="g", width=W, height=H)
    return g, cam


def test_rasterize_matches_goldens():
    from instascene_tpu_torch.ops.rasterize import (CameraMats,
                                                    RasterizeConfig,
                                                    rasterize)
    g, cam = _golden()
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    cm = CameraMats(f(cam.w2v), f(cam.full_proj), f(cam.camera_center))
    out = rasterize(f(g["inputs_xyz"]), f(g["inputs_scales"]),
                    f(g["inputs_rots"]), f(g["inputs_opac"]), cm,
                    [0.1, 0.2, 0.3], RasterizeConfig(cam.width, cam.height),
                    colors=f(g["inputs_color"]), extras=f(g["inputs_extra"]))
    b = out.blend
    for key in ("color", "depth", "alpha", "normal", "median_depth",
                "distortion", "extra", "final_T"):
        np.testing.assert_allclose(getattr(b, key).numpy(), g[key],
                                   atol=ATOL, rtol=RTOL, err_msg=key)
    np.testing.assert_array_equal(b.n_contrib.numpy(), g["n_contrib"])
    assert out.n_dropped == 0 and out.total_pairs > 0


def test_render_matches_goldens():
    """render() over a GaussianModel carrying the golden inputs (log
    scales, logit opacities, override colors, raw features)."""
    from instascene_tpu_torch.config import PipelineParams
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.render import render
    g, cam = _golden()
    n = int(g["n"])
    opac = g["inputs_opac"].astype(np.float64)
    p = from_numpy(dict(
        xyz=g["inputs_xyz"], features_dc=np.zeros((n, 1, 3), np.float32),
        features_rest=np.zeros((n, 15, 3), np.float32),
        scaling=np.log(g["inputs_scales"]), rotation=g["inputs_rots"],
        opacity=np.log(opac / (1 - opac))[:, None], alive=np.ones(n, bool),
        seg_feature=g["inputs_extra"]), device="cpu")
    pkg = render(cam, p, PipelineParams(), np.array([0.1, 0.2, 0.3]),
                 override_color=torch.as_tensor(g["inputs_color"]),
                 norm_seg_feat=False)
    alpha = g["alpha"][..., None]
    expect = {"render": g["color"], "rend_alpha": alpha,
              "rend_median_depth": g["median_depth"][..., None],
              "rend_dist": g["distortion"][..., None],
              "seg_feature": g["extra"], "final_T": g["final_T"],
              "rend_depth": np.where(alpha > 0, g["depth"][..., None]
                                     / np.where(alpha > 0, alpha, 1), 0)}
    for key, want in expect.items():
        np.testing.assert_allclose(pkg[key].numpy(), want, atol=ATOL,
                                   rtol=RTOL, err_msg=key)
    np.testing.assert_array_equal(pkg["n_contrib"].numpy(), g["n_contrib"])


# per-key tolerances, port render() vs JAX render(): the blend tolerances of
# the JAX suite, carried through render()'s post-processing
KEY_TOL = {"render": 3e-4, "rend_alpha": 2e-5, "seg_feature": 5e-4,
           "final_T": 2e-5, "rend_normal": 3e-4, "rend_dist": 3e-3,
           "rend_depth": 3e-3, "rend_median_depth": 3e-3,
           "surf_depth": 3e-3, "surf_normal": 3e-3, "gaussian_depth": 1e-5,
           "T": 1e-3}


@pytest.mark.parametrize("viewer", [True, False], ids=["viewer", "full"])
def test_render_matches_jax(viewer):
    from instascene_tpu.config import PipelineParams as JPipe
    from instascene_tpu.models.gaussians import GaussianParams
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.render import render as jrender
    from instascene_tpu_torch.config import PipelineParams
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.render import render
    W, H = 64, 48
    st, mk = make_bench_scene(n=300, seed=6, profile="trained")
    rng = np.random.default_rng(6)
    st["features_rest"] = rng.normal(0, 0.2, (300, 15, 3)).astype(np.float32)
    st["alive"] = rng.random(300) > 0.1
    cam = mk(5, W, H)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    jp = GaussianParams(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in st.items()})
    ja = jrender(cam, jp, JPipe(), bg, viewer=viewer,
                 cfg=JCfg(width=W, height=H, impl="pallas", pair_cap=2048,
                          tune_gather=False))
    ta = render(cam, from_numpy(st, device="cpu"), PipelineParams(), bg,
                viewer=viewer)
    assert set(ta) == set(ja)
    assert int(ja["n_dropped"]) == ta["n_dropped"] == 0
    assert ja["gau_related_pixels"] is None and ta["gau_related_pixels"] is None
    np.testing.assert_array_equal(ta["n_contrib"].numpy(),
                                  np.asarray(ja["n_contrib"]))
    assert ta["n_contrib"].numpy().max() > 0
    for key in ("radii", "visibility_filter"):
        np.testing.assert_array_equal(ta[key].numpy(), np.asarray(ja[key]),
                                      key)
    for key, tol in KEY_TOL.items():
        a, b = ta[key].numpy(), np.asarray(ja[key])
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, atol=tol, rtol=1e-5, err_msg=key)


def test_render_maps_equal_the_training_render():
    """render()'s maps, surface maps included, are the geometry training
    step's (render_for_training) bit for bit for one model and camera on
    the CPU: one activation, one ray function and one surface-map function
    serve both."""
    from instascene_tpu_torch.config import PipelineParams
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines.train import (camera_tensors,
                                                      render_for_training)
    from instascene_tpu_torch.render import render
    W, H = 64, 48
    st, mk = make_bench_scene(n=300, seed=4, profile="trained")
    st["alive"] = np.random.default_rng(4).random(300) > 0.1
    p = from_numpy(st, device="cpu")
    cam = mk(3, W, H)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    pipe = PipelineParams()
    pipe.depth_ratio = 0.5          # both depths enter surf_depth
    got = render(cam, p, pipe, bg)
    ct = camera_tensors(cam, "cpu")
    out, normal, surf_normal, alpha, surf_depth = render_for_training(
        p, ct.mats, bg, RasterizeConfig(W, H), None, ct.c2w_rot, ct.tanfovx,
        ct.tanfovy, pipe.depth_ratio)
    assert float(alpha.max()) > 0 and bool(surf_normal.any())
    for key, want in (("render", out.blend.color), ("rend_alpha", alpha),
                      ("seg_feature", out.blend.extra),
                      ("rend_normal", normal), ("surf_depth", surf_depth),
                      ("surf_normal", surf_normal)):
        assert torch.equal(got[key], want), key


def test_later_slice_options_raise():
    from instascene_tpu_torch.config import PipelineParams
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.render import render
    st, mk = make_bench_scene(n=50, seed=0, profile="trained")
    p = from_numpy(st, device="cpu")
    cam = mk(0, 32, 32)
    # clip_rect serves a cached binning (a fresh render has none to
    # clip); conic culling leaves the maps as they were
    with pytest.raises(ValueError, match="cached binning"):
        render(cam, p, PipelineParams(), np.zeros(3),
               cfg=RasterizeConfig(32, 32, clip_rect=True))
    plain = render(cam, p, PipelineParams(), np.zeros(3),
                   cfg=RasterizeConfig(32, 32))
    culled = render(cam, p, PipelineParams(), np.zeros(3),
                    cfg=RasterizeConfig(32, 32, conic_cull=True))
    for key in ("render", "rend_alpha", "rend_normal", "surf_depth"):
        torch.testing.assert_close(culled[key], plain[key], atol=1e-6,
                                   rtol=0)
    # slice 4 serves merged views at the blend (blend_visits.blend's
    # tiles_per_view), as the JAX package does: no RasterizeConfig field
    with pytest.raises(TypeError):
        RasterizeConfig(32, 32, tiles_per_view=4)
    # slice 3 serves contributor tracking (the priors' tracker renders);
    # bwd_extras_only is exercised by tests/test_torch_semantic_step.py
    out = render(cam, p, PipelineParams(), np.zeros(3), track_contrib=True)
    ids, w = out["gau_related_pixels"]
    assert ids.shape == (32, 32, 10) and w.shape == (32, 32, 10)
    assert ((ids >= 0) == (w > 0.1)).all()
    with pytest.raises(ValueError, match="separate modes"):
        render(cam, p, PipelineParams(), np.zeros(3), track_contrib=True,
               viewer=True)
    # slice 2 serves no_depth_dist and the t_offset densification tap
    out = render(cam, p, PipelineParams(), np.zeros(3),
                 cfg=RasterizeConfig(32, 32, no_depth_dist=True))
    assert not out["rend_dist"].any()
    # (surfels scaled up: a splat smaller than the 2D filter takes no
    # gradient through T, only through its centre)
    t0 = torch.zeros(50, 3, 3, requires_grad=True)
    out = render(cam, p, PipelineParams(), np.zeros(3), t_offset=t0,
                 scaling_modifier=12.0)
    out["render"].sum().backward()
    assert torch.isfinite(t0.grad).all() and t0.grad.any()
