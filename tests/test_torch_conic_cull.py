"""Exact conic-vs-tile pair culling (RasterizeConfig.conic_cull): the port's
`conic_cull_masks` against the JAX package's bit for bit, the culled pair
list against JAX's slot for slot (a duplicate-free subset of the unculled
one), and the maps and gradients with culling on against culling off and
against JAX's, on tests/test_rasterizer.py::test_conic_cull_exact's scene
(48x32, 60 gaussians with opacities down to 0.002 and log-normal scales)
and a wider one whose splats span more than the mask's 8 rows and 64
offsets; and at full width (1920x1080), where the conic's float32
coefficients cancel and the JAX package's masks cull live pairs, the
port's (float64 coefficients) cull only dead ones."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_rasterizer import H, W, make_camera, make_gaussians


def _scene(kind):
    """(camera, width, height, xyz, scales, rots, opac, color, extra)."""
    if kind == "rasterizer":
        xyz, _, rots, _, color, extra = make_gaussians(
            np.random.default_rng(42))
        rng2 = np.random.default_rng(11)
        n = xyz.shape[0]
        opac = np.concatenate([
            rng2.uniform(0.002, 0.05, 20), rng2.uniform(0.05, 0.5, n - 40),
            rng2.uniform(0.5, 0.999, 20)]).astype(np.float32)
        scales = np.exp(rng2.normal(-2.0, 1.0, (n, 2))).astype(np.float32)
        return make_camera(), W, H, xyz, scales, rots, opac, color, extra
    from instascene_tpu.cameras import Camera
    from instascene_tpu.data.synthetic import look_at
    rng = np.random.default_rng(7)
    w, h, n = 192, 160, 300
    R_w2c, t = look_at(np.array([0.0, -3.0, 0.8]), np.zeros(3))
    cam = Camera(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=0.9, fovy=0.8,
                 image_name="w", width=w, height=h)
    xyz = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(-1.6, 0.8, (n, 2))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.003, 0.99, n).astype(np.float32)
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    extra = rng.normal(size=(n, 4)).astype(np.float32)
    return cam, w, h, xyz, scales, rots, opac, color, extra


def _pre_both(kind, conic):
    """The JAX and the port's preprocess of the scene, conic culling on or
    off."""
    from instascene_tpu.ops.preprocess import preprocess_gaussians as jpre
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    cam, w, h, xyz, scales, rots, opac, color, _ = _scene(kind)
    jp = jpre(jnp.asarray(xyz), jnp.asarray(scales), jnp.asarray(rots),
              jnp.asarray(cam.w2v), jnp.asarray(cam.full_proj),
              jnp.asarray(cam.camera_center), w, h, color=jnp.asarray(color),
              opacity=jnp.asarray(opac), conic_cull=conic)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tp = preprocess_gaussians(f(xyz), f(scales), f(rots), f(cam.w2v),
                              f(cam.full_proj), f(cam.camera_center), w, h,
                              f(opac), color=f(color), conic_cull=conic)
    return jp, tp, w, h


@pytest.mark.parametrize("kind", ["rasterizer", "wide"])
def test_conic_cull_masks_bit_for_bit(kind):
    """Both 32-bit mask words and the kept-tile counts equal JAX's; the
    scene culls something, and the wide one has rects past the window."""
    jp, tp, _, _ = _pre_both(kind, True)
    for got, want in ((tp.cull_lo, jp.cull_lo), (tp.cull_hi, jp.cull_hi)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    np.testing.assert_array_equal(tp.tiles_touched.numpy(),
                                  np.asarray(jp.tiles_touched))
    rw = (tp.rect_max - tp.rect_min)[:, 0].clamp(min=1)
    rh = (tp.rect_max - tp.rect_min)[:, 1].clamp(min=0)
    full = torch.where(tp.valid, rw * rh, 0)
    assert (tp.tiles_touched < full).any()
    if kind == "wide":
        assert (full > 64).any() and (rh > 8).any()


def _pairs(b, num_tiles):
    return [(t, int(g)) for t in range(num_tiles)
            for g in b.sorted_gid[int(b.tile_start[t]):int(b.tile_end[t])]]


@pytest.mark.parametrize("kind", ["rasterizer", "wide"])
def test_culled_pair_list_matches_jax(kind):
    """The culled binning's per-tile pair lists equal JAX's slot for slot,
    and are a duplicate-free strict subset of the unculled pairs."""
    from instascene_tpu.ops.binning import bin_gaussians as jbin
    from instascene_tpu_torch.ops.binning import bin_gaussians
    jp, tp, w, h = _pre_both(kind, True)
    _, tp0, _, _ = _pre_both(kind, False)
    jb = jbin(jp, w, h, pair_cap=65536, tile_cap=4096, layout="padded")
    assert int(jb.n_dropped) == 0
    b = bin_gaussians(tp, w, h)
    nt = ((w + 15) // 16) * ((h + 15) // 16)
    ji, jc = np.asarray(jb.tile_indices), np.asarray(jb.tile_count)
    np.testing.assert_array_equal((b.tile_end - b.tile_start).numpy(), jc)
    for t in range(nt):
        np.testing.assert_array_equal(
            b.sorted_gid[int(b.tile_start[t]):int(b.tile_end[t])].numpy(),
            ji[t, :jc[t]])
    on = _pairs(b, nt)
    off = _pairs(bin_gaussians(tp0, w, h), nt)
    assert len(set(on)) == len(on) and set(on) < set(off)


def test_conic_cull_maps_and_grads():
    """rasterize with conic_cull: the maps and the gradients of a loss over
    every map equal the unculled render's (maps to 1e-6, gradients to
    atol 1e-5: removing a pair that contributes nowhere changes no sum),
    and JAX's with conic_cull (impl="xla") within the kernel-vs-twin
    tolerances, the gradients within 3e-3 of each one's largest |value|."""
    from instascene_tpu.ops.rasterize import CameraMats as JCam
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.ops.rasterize import rasterize as jrast
    from instascene_tpu_torch.ops.rasterize import (CameraMats,
                                                    RasterizeConfig,
                                                    rasterize)
    cam, w, h, *arrs = _scene("rasterizer")
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tcam = CameraMats(f(cam.w2v), f(cam.full_proj), f(cam.camera_center))

    def loss_of(b):
        return ((b.color * 0.7).sum() + (b.depth * 0.3).sum()
                + (b.normal * 0.1).sum() + (b.distortion * 0.2).sum()
                + (b.extra * 0.05).sum() + b.alpha.sum())

    res = {}
    for conic in (False, True):
        ts = [f(a).requires_grad_(True) for a in arrs]
        o = rasterize(*ts[:4], tcam, bg,
                      RasterizeConfig(w, h, conic_cull=conic),
                      colors=ts[4], extras=ts[5])
        loss_of(o.blend).backward()
        res[conic] = (o, [t.grad for t in ts])
    (o0, g0), (o1, g1) = res[False], res[True]
    assert o1.total_pairs < o0.total_pairs
    keys = ("color", "depth", "alpha", "normal", "median_depth",
            "distortion", "extra", "final_T")
    for k in keys:
        torch.testing.assert_close(getattr(o1.blend, k),
                                   getattr(o0.blend, k), atol=1e-6, rtol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)

    jcfg = JCfg(width=w, height=h, chunk=16, pair_cap=8192, tile_cap=1024,
                impl="xla", conic_cull=True)
    jcam = JCam(jnp.asarray(cam.w2v), jnp.asarray(cam.full_proj),
                jnp.asarray(cam.camera_center))

    def jloss(xyz, scales, rots, opac, color, extra):
        o = jrast(xyz, scales, rots, opac, jcam, jnp.asarray(bg), jcfg,
                  colors=color, extras=extra)
        return loss_of(o.blend), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                     has_aux=True)(*map(jnp.asarray, arrs))
    assert int(jo.total_pairs) == o1.total_pairs
    for k, tol in (("color", 3e-4), ("depth", 3e-3), ("alpha", 2e-5),
                   ("normal", 3e-4), ("median_depth", 3e-3),
                   ("distortion", 3e-3), ("extra", 5e-4),
                   ("final_T", 2e-5)):
        np.testing.assert_allclose(getattr(o1.blend, k).detach().numpy(),
                                   np.asarray(getattr(jo.blend, k)),
                                   atol=tol, rtol=0, err_msg=k)
    for got, want in zip(g1, jg):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got.numpy() - want).max() <= 3e-3 * scale


def _culled_pairs(pre, lo, hi, width, height):
    """(tiles, gaussians) of the pairs of pre's rects whose row-major
    offset's bit is clear in the keep-masks lo/hi (int32 words)."""
    from instascene_tpu_torch.ops.binning import bin_gaussians
    from instascene_tpu_torch.ops.preprocess import word_of_i32
    gx = (width + 15) // 16
    b = bin_gaussians(pre, width, height)
    t = torch.repeat_interleave(torch.arange(b.tile_start.numel()),
                                (b.tile_end - b.tile_start).long())
    g = b.sorted_gid.long()
    rw = (pre.rect_max[g, 0] - pre.rect_min[g, 0]).clamp(min=1).long()
    off = ((t // gx - pre.rect_min[g, 1]) * rw
           + (t % gx - pre.rect_min[g, 0]))
    word = torch.where(off < 32, word_of_i32(lo)[g] >> off.clamp(0, 31),
                       word_of_i32(hi)[g] >> (off - 32).clamp(0, 31))
    kept = (off >= 64) | ((word & 1) == 1)
    return t[~kept], g[~kept]


def test_conic_cull_exact_at_full_width():
    """At 1920x1080 (3,000 gaussians of the benchmark scene, camera 0)
    every pair the port's masks cull fails the blend's alpha >= 1/255 mask
    at every pixel of its tile (K1's own splat arithmetic), while the JAX
    package's float32 masks cull some live pairs; the port still culls
    at least 95 % as many."""
    from instascene_tpu.ops.preprocess import preprocess_gaussians as jpre
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops.blend_visits import _splat, pack_flat_cols
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats
    w, h, n = 1920, 1080, 3000
    st, mk = make_bench_scene(n=n, seed=0, profile="trained")
    p = from_numpy(st, device="cpu")
    cm = camera_mats(mk(0, w, h), "cpu")
    opac = p.opacity_activated()[:, 0]
    args = (p.xyz, p.scaling_activated(), p.rotation_normalized(), cm.w2v,
            cm.full_proj, cm.campos, w, h, opac)
    pre = preprocess_gaussians(*args, color=torch.zeros(n, 3),
                               alive=p.alive)
    tp = preprocess_gaussians(*args, color=torch.zeros(n, 3), alive=p.alive,
                              conic_cull=True)
    jp = jpre(*[jnp.asarray(a.numpy()) for a in args[:6]], w, h,
              color=jnp.zeros((n, 3)), opacity=jnp.asarray(opac.numpy()),
              conic_cull=True)
    flat = pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac, pre.color)
    pix = torch.arange(256)
    gx = (w + 15) // 16

    def live(lo, hi):
        t, g = _culled_pairs(pre, lo, hi, w, h)
        X = ((t % gx) * 16)[:, None].float() + (pix % 16).float()
        Y = ((t // gx) * 16)[:, None].float() + (pix // 16).float()
        return t.numel(), int(_splat(flat[g][:, :, None], X, Y)["m"].any(
            dim=1).sum())

    as_i32 = lambda a: torch.as_tensor(np.array(a).view(np.int32))
    culled, alive = live(tp.cull_lo, tp.cull_hi)
    j_culled, j_alive = live(as_i32(jp.cull_lo), as_i32(jp.cull_hi))
    assert alive == 0 and culled >= 0.95 * j_culled
    assert j_alive > 0, "the float32 masks cull no live pair here"
