"""K3 and K4, K1 and K2 over a tile list (the --mv_tile_subsample path and
rasterize(tile_ids=)): the port's plain versions against the JAX TPU
kernels over a select_tiles_bundle mini bundle (blend_aligned_diff in its
extras_only and full modes, blend_aligned_viewer; Pallas in interpret
mode), `rasterize_extras_tiles` against the JAX package's, a tile subset
of rasterize against the whole frame, and `select_tiles`' count of the
chunks the JAX bundle cuts, on test_mv_merged's scene. The CUDA kernels are
held against the plain versions in test_torch_kernel.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_mv_merged import E, H, W, scene

GRID_X = (W + 15) // 16
NUM_TILES = GRID_X * ((H + 15) // 16)


def _sel(seed, k=5):
    return np.sort(np.random.default_rng(seed).choice(
        NUM_TILES, k, replace=False)).astype(np.int32)


def _jax_flat(params, mv, v):
    from instascene_tpu.ops.blend_pallas import pack_flat_cols
    from instascene_tpu.ops.preprocess import preprocess_gaussians
    pre = preprocess_gaussians(
        params.xyz, params.scaling_activated(), params.rotation_normalized(),
        mv.w2v[v], mv.full_proj[v], mv.campos[v], W, H,
        color=params.xyz * 0.0, alive=params.alive)
    f = params.seg_feature
    featn = f / (jnp.linalg.norm(f, axis=1, keepdims=True) + 1e-6)
    return pack_flat_cols(pre.T, pre.xy, pre.normal_view,
                          params.opacity_activated()[:, 0], pre.color, featn)


def test_plain_k3_k4_match_aligned_kernels():
    """Five random tiles of view 1 (no chunk cut): final T and features at
    atol 2e-5 / rtol 1e-4, n_contrib exact, the other rows zero; the
    feature gradient of a random cotangent on the listed rows within 1e-5
    of its largest |value|; each listed row bit for bit the whole frame's
    extras_only row of its tile."""
    from instascene_tpu.ops.binning import select_tiles_bundle
    from instascene_tpu.ops.blend_pallas import blend_aligned_diff
    from instascene_tpu_torch.ops import blend_visits as bv
    params, mv, _, bins = scene()
    cb = jax.tree.map(lambda a: a[1], mv.binning)
    flat = _jax_flat(params, mv, 1)
    sel = _sel(1)
    K = len(sel)
    gid, mtile, mrank, n_tr = select_tiles_bundle(
        cb.sorted_gid, cb.tile_bounds, jnp.asarray(sel), chunk_cap=K * 8,
        n=params.capacity)
    assert int(n_tr) == 0
    rng = np.random.default_rng(2)
    gout = rng.normal(size=(K, 12 + E, 256)).astype(np.float32)
    gfull = np.zeros((NUM_TILES, 12 + E, 256), np.float32)
    gfull[sel] = gout

    def jfwd(fl):
        out, iout = blend_aligned_diff(fl, (gid, mtile, mrank), NUM_TILES,
                                       16, GRID_X, E, True, True, 128)
        return jnp.where(jnp.asarray(np.isin(np.arange(NUM_TILES), sel))
                         [:, None, None], out, 0.0), iout

    (jout, jiout), vjp = jax.vjp(jfwd, flat)
    (jg,) = vjp((jnp.asarray(gfull), jnp.zeros_like(jiout)))
    jout, jiout = np.asarray(jout)[sel], np.asarray(jiout)[sel]
    jg = np.asarray(jg)[:-1]

    b = bins[1]
    runs = (b.gid_order, b.run_start)
    tflat = torch.as_tensor(np.array(flat)[:-1]).requires_grad_(True)
    out, iout = bv.blend(tflat, b.sorted_gid, b.tile_start, b.tile_end,
                         GRID_X, E, runs, extras_only=True,
                         tile_ids=torch.as_tensor(sel))
    (out * torch.as_tensor(gout)).sum().backward()
    out, iout = out.detach().numpy(), iout.numpy()
    np.testing.assert_array_equal(iout[:, 0], jiout[:, 0])
    assert iout[:, 0].max() > 0 and not iout[:, 1].any()
    np.testing.assert_allclose(out[:, 9:10 + E], jout[:, 9:10 + E],
                               atol=2e-5, rtol=1e-4)
    zero = [r for r in range(12 + E) if not 9 <= r < 10 + E]
    assert not out[:, zero].any()
    g = tflat.grad.numpy()
    assert not g[:, :21].any() and not jg[:, :21].any()
    scale = np.abs(jg).max()
    assert scale > 0 and np.abs(g - jg).max() <= 1e-5 * scale

    full, ifull = bv.blend_fwd_reference(
        tflat.detach(), b.sorted_gid, b.tile_start, b.tile_end, GRID_X, E,
        extras_only=True)
    np.testing.assert_array_equal(out, full.numpy()[sel])
    np.testing.assert_array_equal(iout, ifull.numpy()[sel])


def test_rasterize_extras_tiles_matches_jax():
    """rasterize_extras_tiles → [K, 256, E] on view 2 at atol 2e-5 / rtol
    1e-4, and its gradient in the features within 1e-5 of the largest."""
    from instascene_tpu.ops.binning import select_tiles_bundle
    from instascene_tpu.ops.rasterize import CameraMats as JCam
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.ops.rasterize import rasterize_extras_tiles as jret
    from instascene_tpu_torch.ops.rasterize import (CameraMats,
                                                    RasterizeConfig,
                                                    rasterize_extras_tiles)
    params, mv, tp, bins = scene()
    v = 2
    cb = jax.tree.map(lambda a: a[v], mv.binning)
    sel = _sel(4, k=6)
    bundle = select_tiles_bundle(cb.sorted_gid, cb.tile_bounds,
                                 jnp.asarray(sel), chunk_cap=len(sel) * 8,
                                 n=params.capacity)
    assert int(bundle[3]) == 0
    tgt = np.random.default_rng(6).normal(
        size=(len(sel), 256, E)).astype(np.float32)
    jcfg = JCfg(width=W, height=H, impl="pallas", bwd_extras_only=True,
                extras_dim=E)
    jcam = JCam(mv.w2v[v], mv.full_proj[v], mv.campos[v])

    def jloss(f):
        out = jret(params.xyz, params.scaling_activated(),
                   params.rotation_normalized(),
                   params.opacity_activated()[:, 0], jcam, jcfg, f,
                   bundle[:3], jnp.asarray(sel), alive=params.alive)
        return jnp.sum(out * tgt), out

    featn = params.seg_feature
    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(featn)
    jout, jg = np.asarray(jout), np.asarray(jg)

    t = lambda a: torch.as_tensor(np.array(a))
    f = tp.seg_feature.clone().requires_grad_(True)
    out = rasterize_extras_tiles(
        tp.xyz, tp.scaling_activated(), tp.rotation_normalized(),
        tp.opacity_activated()[:, 0],
        CameraMats(t(mv.w2v[v]), t(mv.full_proj[v]), t(mv.campos[v])),
        RasterizeConfig(W, H, bwd_extras_only=True), f, bins[v],
        torch.as_tensor(sel), alive=tp.alive)
    assert out.shape == (len(sel), 256, E)
    (out * torch.as_tensor(tgt)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=2e-5,
                               rtol=1e-4)
    scale = np.abs(jg).max()
    assert scale > 0 and np.abs(f.grad.numpy() - jg).max() <= 1e-5 * scale


@pytest.mark.parametrize("align", [128, 8, 2])
def test_select_tiles_counts_jax_truncation(align):
    """select_tiles lists the tiles and their slot ranges, and counts the
    chunks JAX's mini bundle (chunk_cap = 8·K) cuts: none at 128-pair
    chunks on this scene, some at narrower chunks."""
    from instascene_tpu.ops.binning import select_tiles_bundle
    from instascene_tpu_torch.ops.binning import select_tiles
    params, mv, _, bins = scene()
    cb = jax.tree.map(lambda a: a[0], mv.binning)
    sel = np.arange(NUM_TILES, dtype=np.int32)
    *_, n_tr = select_tiles_bundle(cb.sorted_gid, cb.tile_bounds,
                                   jnp.asarray(sel), chunk_cap=8 * len(sel),
                                   n=params.capacity, align=align)
    s = select_tiles(torch.as_tensor(sel).long(), bins[0], chunk=align)
    assert s.tile_ids.dtype == torch.int32 and s.tile_ids.is_contiguous()
    np.testing.assert_array_equal((s.tile_end - s.tile_start).numpy(),
                                  np.diff(np.asarray(cb.tile_bounds)))
    assert int(s.jax_capped_chunks) == int(n_tr)
    assert (int(n_tr) > 0) == (align == 2)


@pytest.mark.parametrize("bad", [-1, NUM_TILES])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_tile_ids_out_of_range_raise(kernel, bad):
    """A listed id outside [0, tiles) raises before K1/K2 (K3/K4) or their
    plain versions read a tile range; the same assertion runs on the card,
    where the kernel would read out of bounds."""
    from instascene_tpu_torch.ops import blend_visits as bv
    _, _, tp, bins = scene()
    b = bins[1]
    flat = torch.zeros((tp.xyz.shape[0], 21 + E))
    ids = torch.tensor([0, bad, 3], dtype=torch.int32)
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, GRID_X, E)
    with pytest.raises(RuntimeError, match="tile_ids must lie in"):
        if kernel == "fwd":
            bv.blend_fwd(*args, extras_only=True, tile_ids=ids)
        else:
            bv.blend_bwd(*args, torch.zeros((3, 12 + E, 256)),
                         torch.zeros((3, 3, 256)),
                         torch.zeros((3, 2, 256), dtype=torch.int32),
                         extras_only=True, tile_ids=ids)


E4 = 4      # the full-mode tests' feature width


def _jax_flat_full(params, mv, v):
    """JAX's packed table of view v with colors and E4 features (the
    scene's first four, normalised)."""
    from instascene_tpu.ops.blend_pallas import pack_flat_cols
    from instascene_tpu.ops.preprocess import preprocess_gaussians
    pre = preprocess_gaussians(
        params.xyz, params.scaling_activated(), params.rotation_normalized(),
        mv.w2v[v], mv.full_proj[v], mv.campos[v], W, H,
        shs=params.features(), sh_degree=0, alive=params.alive)
    f = params.seg_feature[:, :E4]
    featn = f / (jnp.linalg.norm(f, axis=1, keepdims=True) + 1e-6)
    return pack_flat_cols(pre.T, pre.xy, pre.normal_view,
                          params.opacity_activated()[:, 0], pre.color, featn)


# the JAX suite's kernel-vs-twin tolerances by out row
# (tests/test_blend_pallas.py:83-93)
ROW_TOL = ((slice(0, 3), 3e-4), (slice(3, 4), 3e-3), (slice(4, 7), 3e-4),
           (slice(7, 8), 3e-3), (slice(8, 9), 3e-3), (slice(9, 10), 2e-5),
           (slice(10, 10 + E4), 5e-4))


@pytest.mark.parametrize("mode", ["full", "viewer"])
def test_plain_k3_k4_full_and_viewer_match_aligned_kernels(mode):
    """Five random tiles of view 1 at E = 4 (no chunk cut): K3's listed
    rows against blend_aligned_diff (full) / blend_aligned_viewer within
    the JAX suite's row tolerances, n_contrib exact, and bit for bit the
    whole frame's rows of those tiles; in full mode K4's gradient of a
    random cotangent on the listed rows within 3e-3 of the largest |value|
    of jax.grad's, per packed column group."""
    from instascene_tpu.ops.binning import select_tiles_bundle
    from instascene_tpu.ops.blend_pallas import (blend_aligned_diff,
                                                 blend_aligned_viewer)
    from instascene_tpu_torch.ops import blend_visits as bv
    params, mv, _, bins = scene()
    cb = jax.tree.map(lambda a: a[1], mv.binning)
    flat = _jax_flat_full(params, mv, 1)
    sel = _sel(7)
    K = len(sel)
    gid, mtile, mrank, n_tr = select_tiles_bundle(
        cb.sorted_gid, cb.tile_bounds, jnp.asarray(sel), chunk_cap=K * 8,
        n=params.capacity)
    assert int(n_tr) == 0
    bundle = (gid, mtile, mrank)
    b = bins[1]
    args = (b.sorted_gid, b.tile_start, b.tile_end, GRID_X, E4)
    ids = torch.as_tensor(sel)
    tflat = torch.as_tensor(np.array(flat)[:-1])
    if mode == "viewer":
        jout, jiout = blend_aligned_viewer(flat, bundle, NUM_TILES, 16,
                                           GRID_X, E4, True, 128)
        out, iout = bv.blend_fwd(tflat, *args, viewer=True, tile_ids=ids)
    else:
        rng = np.random.default_rng(8)
        gout = rng.normal(size=(K, 12 + E4, 256)).astype(np.float32)
        gout[:, 10 + E4:] = 0.0
        gfull = np.zeros((NUM_TILES, 12 + E4, 256), np.float32)
        gfull[sel] = gout
        listed = jnp.asarray(np.isin(np.arange(NUM_TILES), sel))

        def jfwd(fl):
            out, iout = blend_aligned_diff(fl, bundle, NUM_TILES, 16, GRID_X,
                                           E4, True, False, 128)
            return jnp.where(listed[:, None, None], out, 0.0), iout

        (jout, jiout), vjp = jax.vjp(jfwd, flat)
        (jg,) = vjp((jnp.asarray(gfull), jnp.zeros_like(jiout)))
        jg = np.asarray(jg)[:-1]
        tf = tflat.clone().requires_grad_(True)
        out, iout = bv.blend(tf, *args, (b.gid_order, b.run_start),
                             tile_ids=ids)
        (out * torch.as_tensor(gout)).sum().backward()
        g = tf.grad.numpy()
        for cols in (slice(0, 12), slice(12, 14), slice(14, 17),
                     slice(17, 18), slice(18, 21), slice(21, 21 + E4)):
            scale = np.abs(jg[:, cols]).max()
            assert scale > 0, cols
            assert np.abs(g[:, cols] - jg[:, cols]).max() <= 3e-3 * scale
        out = out.detach()
    jout, jiout = np.asarray(jout)[sel], np.asarray(jiout)[sel]
    np.testing.assert_array_equal(iout[:, 0].numpy(), jiout[:, 0])
    assert iout[:, 0].max() > 0
    for rows, tol in ROW_TOL:
        np.testing.assert_allclose(out[:, rows].numpy(), jout[:, rows],
                                   atol=tol, rtol=0)
    full, ifull = bv.blend_fwd(tflat, *args, viewer=mode == "viewer")
    assert torch.equal(out, full[ids.long()])
    assert torch.equal(iout, ifull[ids.long()])


def test_rasterize_tile_subset_matches_the_whole_frame():
    """rasterize(tile_ids=) over view 1's cached binning in full mode
    (tests/test_blend_pallas.py:338-424's contract): the listed tiles'
    maps within 1e-6 of the whole frame's, the other tiles' rows zero (the
    maps derived from them, such as alpha = 1 − T, are not to be read),
    and the xyz
    gradient of a loss over the listed tiles' pixels within 1e-5 of the
    largest |value| of the whole frame's."""
    from instascene_tpu_torch.ops.rasterize import (CameraMats,
                                                    RasterizeConfig,
                                                    rasterize)
    params, mv, tp, bins = scene()
    t = lambda a: torch.as_tensor(np.array(a))
    cam = CameraMats(t(mv.w2v[1]), t(mv.full_proj[1]), t(mv.campos[1]))
    sel = _sel(9, k=4)
    mask = torch.zeros(NUM_TILES, dtype=torch.bool)
    mask[torch.as_tensor(sel).long()] = True
    pix = mask.reshape(H // 16, 1, GRID_X, 1).expand(
        H // 16, 16, GRID_X, 16).reshape(H, W)

    def run(tile_ids):
        xyz = tp.xyz.clone().requires_grad_(True)
        o = rasterize(xyz, tp.scaling_activated(), tp.rotation_normalized(),
                      tp.opacity_activated()[:, 0], cam, np.zeros(3),
                      RasterizeConfig(W, H), shs=tp.features(), sh_degree=0,
                      extras=tp.seg_feature_normed(), alive=tp.alive,
                      cached_binning=bins[1], tile_ids=tile_ids)
        ((o.blend.extra[pix] ** 2).sum()
         + (o.blend.color[pix] * 0.5).sum()).backward()
        return o.blend, xyz.grad

    full, gf = run(None)
    sub, gs = run(torch.as_tensor(sel))
    for k in ("color", "extra", "depth", "normal", "final_T", "distortion",
              "median_depth"):
        a, b = getattr(sub, k).detach(), getattr(full, k).detach()
        torch.testing.assert_close(a[pix], b[pix], atol=1e-6, rtol=0)
        assert not a[~pix].any(), k      # the kernels' rows, unlisted: 0
    scale = gf.abs().max()
    assert scale > 0 and (gs - gf).abs().max() <= 1e-5 * scale
