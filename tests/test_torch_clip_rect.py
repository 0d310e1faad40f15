"""The cached-superset path: a binning dilated at camera A
(compute_binning_cache(dilate_tiles=1)) rendered at nearby cameras through
K1/K2's clip_rect gate (RasterizeConfig(clip_rect=True)). The port's
`dilate_rects` and dilated pair lists against the JAX package's, its
clip_rect render (maps and gradients) against JAX's over JAX's own dilated
cache (Pallas in interpret mode), and against the port's own fresh
render: tests/test_coherent.py:93-140's contract on its depth-separated
scene, scaled down to 96x64 and 80 gaussians."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_coherent import _contained, _depth_separated_params

W, H = 96, 64
GX, GY = (W + 15) // 16, (H + 15) // 16
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "alive", "seg_feature")
MAP_KEYS = ("color", "alpha", "extra", "depth", "normal", "median_depth",
            "distortion", "final_T")


def _setup():
    """(JAX params, port params, the cache camera's JAX CameraMats, the
    orbit cameras that stay inside its dilated envelope, the envelope)."""
    from instascene_tpu.ops.binning import dilate_rects
    from instascene_tpu.ops.preprocess import preprocess_gaussians
    from instascene_tpu.ops.rasterize import CameraMats
    from instascene_tpu.viewer.gui import OrbitCamera
    from instascene_tpu_torch.models.gaussians import from_numpy
    params = _depth_separated_params(n=80)
    tp = from_numpy({k: np.array(getattr(params, k)) for k in FIELDS},
                    device="cpu")
    orbit = OrbitCamera(W, H, r=4.0)
    cam0 = orbit.minicam()
    cm0 = CameraMats(jnp.asarray(cam0.w2v), jnp.asarray(cam0.full_proj),
                     jnp.asarray(cam0.camera_center))
    pre0 = preprocess_gaussians(
        params.xyz, params.scaling_activated(), params.rotation_normalized(),
        cm0.w2v, cm0.full_proj, cm0.campos, W, H, color=params.xyz * 0.0,
        alive=params.alive, opacity=params.opacity_activated())
    env = dilate_rects(pre0.rect_min, pre0.rect_max, pre0.tiles_touched, GX,
                       GY, 1)
    need0 = np.asarray(pre0.tiles_touched) > 0
    cams = []
    for dx, dy in [(2, 1), (-1, 2)]:
        orbit.orbit(dx, dy)
        cam = orbit.minicam()
        if _contained(params, cam, W, H, env[0], env[1], need0):
            cams.append(cam)
    assert len(cams) == 2, "orbit moves this small stay in the envelope"
    return params, tp, cam0, cm0, cams, (pre0, env)


def _tcam(cam):
    from instascene_tpu_torch.ops.rasterize import CameraMats
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return CameraMats(f(cam.w2v), f(cam.full_proj), f(cam.camera_center))


def test_dilate_rects_and_dilated_pairs_match_jax():
    """dilate_rects of the cache camera's rects equals JAX's, and the
    dilated cache's pair list equals JAX's tile for tile (more pairs than
    the fresh binning)."""
    from instascene_tpu.ops.rasterize import compute_binning_cache as jcache
    from instascene_tpu_torch.ops.binning import dilate_rects
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.ops.rasterize import compute_binning_cache
    params, tp, cam0, cm0, _, (pre0, env) = _setup()
    tcam = _tcam(cam0)
    pre = preprocess_gaussians(
        tp.xyz, tp.scaling_activated(), tp.rotation_normalized(), tcam.w2v,
        tcam.full_proj, tcam.campos, W, H, tp.opacity_activated()[:, 0],
        color=torch.zeros_like(tp.xyz), alive=tp.alive)
    got = dilate_rects(pre.rect_min, pre.rect_max, pre.tiles_touched, GX,
                       GY, 1)
    for g, j in zip(got, env):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    jb, _, nd = jcache(params, cm0, W, H, impl="pallas", dilate_tiles=1)
    assert int(nd) == 0
    b = compute_binning_cache(tp, tcam, W, H, dilate_tiles=1)
    fresh = compute_binning_cache(tp, tcam, W, H)
    assert b.total_pairs > fresh.total_pairs
    tb = np.asarray(jb.tile_bounds)
    sg = np.asarray(jb.sorted_gid)
    assert b.total_pairs == tb[-1]
    for t in range(GX * GY):
        np.testing.assert_array_equal(
            b.sorted_gid[int(b.tile_start[t]):int(b.tile_end[t])].numpy(),
            sg[tb[t]:tb[t + 1]])


def _port_render(tp, cam, binning, clip, weights):
    """The port's maps at cam (clip_rect over `binning`, or fresh binning)
    and the gradient of Σ weights·maps in xyz and the features."""
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    xyz = tp.xyz.clone().requires_grad_(True)
    feat = tp.seg_feature_normed().detach().clone().requires_grad_(True)
    o = rasterize(xyz, tp.scaling_activated(), tp.rotation_normalized(),
                  tp.opacity_activated()[:, 0], _tcam(cam), np.zeros(3),
                  RasterizeConfig(W, H, clip_rect=clip), shs=tp.features(),
                  sh_degree=0, extras=feat, alive=tp.alive,
                  cached_binning=binning if clip else None)
    sum(((getattr(o.blend, k) * torch.as_tensor(weights[k])).sum()
         for k in weights)).backward()
    maps = {k: getattr(o.blend, k).detach().numpy() for k in MAP_KEYS}
    return maps, xyz.grad.numpy(), feat.grad.numpy()


def _weights():
    rng = np.random.default_rng(4)
    shapes = {"color": (H, W, 3), "extra": (H, W, 16), "depth": (H, W),
              "normal": (H, W, 3), "alpha": (H, W)}
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def test_clip_rect_matches_jax_and_fresh():
    """At each orbit camera inside the envelope: the port's clip_rect
    render over its dilated cache against JAX's over JAX's (maps at atol
    2e-5 / rtol 1e-4, the gradients in xyz and the features within 3e-3
    of each one's largest |value|), and against the port's own fresh
    render (maps and gradients at rtol = atol = 2e-6)."""
    from instascene_tpu.ops.rasterize import CameraMats as JCam
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.ops.rasterize import compute_binning_cache as jcache
    from instascene_tpu.ops.rasterize import rasterize as jrast
    from instascene_tpu_torch.ops.rasterize import compute_binning_cache
    params, tp, cam0, cm0, cams, _ = _setup()
    jb, _, _ = jcache(params, cm0, W, H, impl="pallas", dilate_tiles=1)
    b = compute_binning_cache(tp, _tcam(cam0), W, H, dilate_tiles=1)
    jcfg = JCfg(width=W, height=H, impl="pallas", clip_rect=True)
    wts = _weights()
    for cam in cams:
        jcm = JCam(jnp.asarray(cam.w2v), jnp.asarray(cam.full_proj),
                   jnp.asarray(cam.camera_center))

        def jloss(xyz, feat):
            o = jrast(xyz, params.scaling_activated(),
                      params.rotation_normalized(),
                      params.opacity_activated()[:, 0], jcm, jnp.zeros(3),
                      jcfg, shs=params.features(), sh_degree=0, extras=feat,
                      alive=params.alive, cached_binning=jb)
            return sum(jnp.sum(getattr(o.blend, k) * wts[k])
                       for k in wts), o

        (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                         has_aux=True)(
            params.xyz, params.seg_feature_normed())
        maps, gx, gf = _port_render(tp, cam, b, True, wts)
        for k in MAP_KEYS:
            np.testing.assert_allclose(maps[k], np.asarray(getattr(
                jo.blend, k)), atol=2e-5, rtol=1e-4, err_msg=k)
        for got, want in ((gx, jg[0]), (gf, jg[1])):
            want = np.asarray(want)
            scale = np.abs(want).max()
            assert scale > 0 and np.abs(got - want).max() <= 3e-3 * scale
        fmaps, fgx, fgf = _port_render(tp, cam, None, False, wts)
        for k in MAP_KEYS:
            np.testing.assert_allclose(maps[k], fmaps[k], rtol=2e-6,
                                       atol=2e-6, err_msg=k)
        np.testing.assert_allclose(gx, fgx, rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(gf, fgf, rtol=2e-6, atol=2e-6)


def test_clip_rect_needs_a_cached_binning():
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    with pytest.raises(ValueError, match="clip_rect"):
        RasterizeConfig(W, H, clip_rect=True, track_contrib=True).check()
