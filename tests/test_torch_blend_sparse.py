"""K5 and K6, the sparse-pixel blend and its backward: the port's plain
versions against the JAX TPU kernels (blend_sparse_diff, Pallas in
interpret mode) on one view of test_mv_merged's scene, and the slot packing
(pick_sparse_s, spix_from_idx) against the JAX package's. The CUDA kernels
are held against the plain versions in test_torch_kernel.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_mv_merged import E, H, W, scene

GRID_X = (W + 15) // 16
NUM_TILES = GRID_X * ((H + 15) // 16)


@pytest.mark.parametrize("case", ["all", "masked", "overflow"])
def test_spix_from_idx_matches_jax(case):
    """pick_sparse_s equals JAX's over a range of densities; spix (JAX's
    slot row cut to S), t_of, slot_of and the overflow flag equal JAX's,
    with duplicate draws, an ownership mask, and a tile that overflows."""
    from instascene_tpu.ops.blend_sparse import pick_sparse_s as jpick
    from instascene_tpu.ops.blend_sparse import spix_from_idx as jspix
    from instascene_tpu_torch.ops.blend_sparse import (pick_sparse_s,
                                                       spix_from_idx)
    for b, t in ((150, 12), (32768, 2806), (6554, 14030), (1, 1),
                 (10 ** 6, 3)):
        assert pick_sparse_s(b, t) == jpick(b, t)
    rng = np.random.default_rng(3)
    B = 400
    idx = rng.integers(0, H * W, B).astype(np.int32)
    idx[10:20] = idx[0]                              # duplicates
    valid = None
    S = pick_sparse_s(B, NUM_TILES)
    if case == "masked":
        valid = rng.random(B) < 0.5
    if case == "overflow":
        idx[:S + 5] = idx[0]
    jv = None if valid is None else jnp.asarray(valid)
    js, jt, jsl, jov = jspix(jnp.asarray(idx), W, H, 16, S, valid=jv)
    ts_, tt, tsl, tov = spix_from_idx(
        torch.as_tensor(idx), W, H, 16, S,
        valid=None if valid is None else torch.as_tensor(valid))
    js = np.asarray(js)
    assert (js[:, 1:] == -1).all() and (js[:, 0, S:] == -1).all()
    np.testing.assert_array_equal(ts_.numpy(), js[:, 0, :S])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    assert bool(tov) == bool(jov) == (case == "overflow")


def test_plain_k5_k6_match_sparse_kernels():
    """~300 draws on view 0 (duplicates included): features and final T at
    atol 2e-5 / rtol 1e-4, n_contrib exact, and the feature gradient of a
    random linear loss within 1e-5 of its largest |value|; the plain K5
    equals K1 extras_only's plain version with a done0 that frees the same
    pixels, bit for bit."""
    from instascene_tpu.ops.blend_pallas import pack_flat_cols as jpack
    from instascene_tpu.ops.blend_sparse import (blend_sparse_diff,
                                                 pick_sparse_s,
                                                 spix_from_idx)
    from instascene_tpu.ops.preprocess import preprocess_gaussians as jpre
    from instascene_tpu_torch.ops import blend_sparse as bs
    from instascene_tpu_torch.ops.blend_visits import blend_fwd_reference
    params, mv, _, bins = scene()
    cb = jax.tree.map(lambda a: a[0], mv.binning)
    pre = jpre(params.xyz, params.scaling_activated(),
               params.rotation_normalized(), mv.w2v[0], mv.full_proj[0],
               mv.campos[0], W, H, color=params.xyz * 0.0,
               alive=params.alive)
    f = params.seg_feature
    featn = f / (jnp.linalg.norm(f, axis=1, keepdims=True) + 1e-6)
    flat = jpack(pre.T, pre.xy, pre.normal_view,
                 params.opacity_activated()[:, 0], pre.color, featn)
    rng = np.random.default_rng(11)
    B = 300
    idx = rng.integers(0, H * W, B).astype(np.int32)
    idx[5:9] = idx[0]
    S = pick_sparse_s(B, NUM_TILES)
    jsp, _, _, ov = spix_from_idx(jnp.asarray(idx), W, H, 16, S)
    assert not bool(ov)
    tgt = rng.normal(size=(NUM_TILES, S, E)).astype(np.float32)

    def jloss(fl):
        feat, aux = blend_sparse_diff(fl, tuple(cb)[:9], jsp, NUM_TILES, 16,
                                      GRID_X, E, True, 128, S)
        return jnp.sum(feat * tgt), (feat, aux)

    (_, (jfeat, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(flat)
    jfeat, jaux = np.asarray(jfeat), np.asarray(jaux)
    jg = np.asarray(jg)[:-1]                           # the sentinel row

    b = bins[0]
    spix = torch.as_tensor(np.asarray(jsp)[:, 0, :S].copy())
    tflat = torch.as_tensor(np.array(flat)[:-1]).requires_grad_(True)
    feat, aux = bs.blend_sparse(tflat, b, spix, GRID_X, E)
    (feat * torch.as_tensor(tgt)).sum().backward()
    feat, aux = feat.detach().numpy(), aux.numpy()
    np.testing.assert_array_equal(aux[..., 1], jaux[..., 1])
    assert aux[..., 1].max() > 0
    np.testing.assert_allclose(aux[..., 0], jaux[..., 0], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(feat, jfeat, atol=2e-5, rtol=1e-4)
    g = tflat.grad.numpy()
    assert not g[:, :21].any() and not jg[:, :21].any()
    scale = np.abs(jg).max()
    assert scale > 0 and np.abs(g - jg).max() <= 1e-5 * scale

    # K5's plain version is K1 extras_only's at the drawn pixels
    sp = spix.numpy()
    d0 = np.ones((NUM_TILES, 1, 256), np.int32)
    t_i, s_i = np.nonzero(sp >= 0)
    d0[t_i, 0, sp[t_i, s_i]] = 0
    out, iout = blend_fwd_reference(
        tflat.detach(), b.sorted_gid, b.tile_start, b.tile_end, GRID_X, E,
        extras_only=True, done0=torch.as_tensor(d0))
    out, iout = out.numpy(), iout.numpy()
    np.testing.assert_array_equal(feat[t_i, s_i],
                                  out[t_i, 10:10 + E, sp[t_i, s_i]])
    np.testing.assert_array_equal(aux[t_i, s_i, 0], out[t_i, 9, sp[t_i, s_i]])
    np.testing.assert_array_equal(aux[t_i, s_i, 1],
                                  iout[t_i, 0, sp[t_i, s_i]])
    empty = sp < 0
    assert (aux[empty, 0] == 1).all() and not aux[empty, 1].any()
    assert not feat[empty].any()


def test_plain_versions_at_e320_match_jax():
    """A width above the kernels' old limit of 256 (E = 320, random unit
    feature rows) on view 0: K1 extras_only with a done0 mask
    (blend_visits_diff) and K5/K6 (blend_sparse_diff, ~300 draws), Pallas in
    interpret mode, against the port's plain versions — final T at atol
    2e-5, features at atol 3e-4 (the suite's tolerances between blends),
    n_contrib exactly, and K6's feature gradient of a random linear loss
    within 1e-5 of its largest |value| (as at E = 8 above)."""
    from instascene_tpu.ops.blend_pallas import pack_flat_cols as jpack
    from instascene_tpu.ops.blend_sparse import (blend_sparse_diff,
                                                 pick_sparse_s,
                                                 spix_from_idx)
    from instascene_tpu.ops.blend_visits import blend_visits_diff
    from instascene_tpu.ops.preprocess import preprocess_gaussians as jpre
    from instascene_tpu_torch.ops import blend_sparse as bs
    from instascene_tpu_torch.ops.blend_visits import blend_fwd_reference
    E = 320
    params, mv, _, bins = scene()
    cb = jax.tree.map(lambda a: a[0], mv.binning)
    pre = jpre(params.xyz, params.scaling_activated(),
               params.rotation_normalized(), mv.w2v[0], mv.full_proj[0],
               mv.campos[0], W, H, color=params.xyz * 0.0,
               alive=params.alive)
    rng = np.random.default_rng(23)
    ext = rng.normal(size=(params.capacity, E)).astype(np.float32)
    ext /= np.linalg.norm(ext, axis=1, keepdims=True)
    flat = jpack(pre.T, pre.xy, pre.normal_view,
                 params.opacity_activated()[:, 0], pre.color,
                 jnp.asarray(ext))
    b = bins[0]
    tflat = torch.as_tensor(np.array(flat)[:-1])
    port = (tflat, b.sorted_gid, b.tile_start, b.tile_end)

    # K1 extras_only with done0
    d0 = (rng.random((NUM_TILES, 1, 256)) >= 0.2).astype(np.int32)
    jout, jiout = blend_visits_diff(flat, tuple(cb)[:9], jnp.asarray(d0),
                                    NUM_TILES, 16, GRID_X, E, True, True)
    jout, jiout = np.asarray(jout), np.asarray(jiout)
    out, iout = blend_fwd_reference(*port, GRID_X, E, extras_only=True,
                                    done0=torch.as_tensor(d0))
    out, iout = out.numpy(), iout.numpy()
    np.testing.assert_array_equal(iout, jiout)
    assert iout[:, 0].max() > 0
    np.testing.assert_allclose(out[:, 9], jout[:, 9], atol=2e-5, rtol=0)
    np.testing.assert_allclose(out[:, 10:10 + E], jout[:, 10:10 + E],
                               atol=3e-4, rtol=0)

    # K5/K6
    B = 300
    idx = rng.integers(0, H * W, B).astype(np.int32)
    idx[5:9] = idx[0]
    S = pick_sparse_s(B, NUM_TILES)
    jsp, _, _, ov = spix_from_idx(jnp.asarray(idx), W, H, 16, S)
    assert not bool(ov)
    tgt = rng.normal(size=(NUM_TILES, S, E)).astype(np.float32)

    def jloss(fl):
        feat, aux = blend_sparse_diff(fl, tuple(cb)[:9], jsp, NUM_TILES, 16,
                                      GRID_X, E, True, 128, S)
        return jnp.sum(feat * tgt), (feat, aux)

    (_, (jfeat, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(flat)
    jfeat, jaux = np.asarray(jfeat), np.asarray(jaux)
    jg = np.asarray(jg)[:-1]                           # the sentinel row
    spix = torch.as_tensor(np.asarray(jsp)[:, 0, :S].copy())
    tf = tflat.clone().requires_grad_(True)
    feat, aux = bs.blend_sparse(tf, b, spix, GRID_X, E)
    (feat * torch.as_tensor(tgt)).sum().backward()
    feat, aux = feat.detach().numpy(), aux.numpy()
    np.testing.assert_array_equal(aux[..., 1], jaux[..., 1])
    assert aux[..., 1].max() > 0
    np.testing.assert_allclose(aux[..., 0], jaux[..., 0], atol=2e-5, rtol=0)
    np.testing.assert_allclose(feat, jfeat, atol=3e-4, rtol=0)
    g = tf.grad.numpy()
    assert not g[:, :21].any() and not jg[:, :21].any()
    scale = np.abs(jg).max()
    assert scale > 0 and np.abs(g - jg).max() <= 1e-5 * scale
