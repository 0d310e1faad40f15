"""The port's bench (instascene_tpu_torch/bench.py): its three semantic
variants — the plain step, the 5-view window in full and tile-subsampled —
on the bench's inputs at 1/16 size against the loss of the JAX package's
semantic step, with JAX's pixel draws injected. The rest of the bench's
tests are in test_torch_bench.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from instascene_tpu_torch import bench as tbench
from test_torch_bench import CPU, _jax_cam, _jax_params, _np, _scenes

SEM_N, SEM_SCALE = 1000, 16


@pytest.fixture(scope="module")
def sem():
    """The bench's semantic inputs at 1/16 size (1,000 gaussians), the
    port's and, on the same numpy arrays, JAX's: each camera with its CPU
    (XLA layout) binning cache, and the window views' visit caches, which
    JAX's tile subsample needs."""
    from instascene_tpu.ops.rasterize import compute_binning_cache
    from instascene_tpu.pipelines import train_semantic as jts
    from instascene_tpu.semantic.contrastive import valid_ids_pack
    _, (st, mk) = _scenes(SEM_N)
    p, cams, hyp, scfg, _ = tbench.semantic_inputs(st, mk, CPU, SEM_SCALE)
    windows = tbench.semantic_windows(cams, SEM_SCALE, CPU)
    jp = _jax_params(st)
    W, H = scfg.raster.width, scfg.raster.height
    j = lambda x: jnp.asarray(_np(x))
    jcams, visits = [], []
    for i, c in enumerate(cams):
        cb, _, nd = compute_binning_cache(jp, _jax_cam(c), W, H, impl="xla",
                                          tune_gather=False)
        assert int(nd) == 0
        if i:
            vb, _, nd = compute_binning_cache(
                jp, _jax_cam(c), W, H, impl="pallas", extras_dim=16,
                tune_gather=False)
            assert int(nd) == 0
            visits.append(vb)
        seg = j(c.segmap)
        pack = valid_ids_pack(seg.reshape(-1) > 0)
        jcams.append(jts.SemanticCamera(
            w2v=j(c.w2v), full_proj=j(c.full_proj), campos=j(c.campos),
            segmap=seg, sorted_segmap=seg, binning=cb, seg_samp=pack,
            sorted_samp=pack,
            vis3d_samp=valid_ids_pack(j(hyp.seg3d_labels) > 0)))
    return dict(p=p, cams=cams, hyp=hyp, scfg=scfg, windows=windows, jp=jp,
                jcams=jcams, visits=visits)


def _jax_window(jcams, binnings, sel):
    """JAX's window of views 1-5 over the given binning caches."""
    from instascene_tpu.pipelines.train_semantic import SemanticMVBlock
    w = jcams[1:6]
    return SemanticMVBlock(
        w2v=jnp.stack([c.w2v for c in w]),
        full_proj=jnp.stack([c.full_proj for c in w]),
        campos=jnp.stack([c.campos for c in w]),
        segmaps=jnp.stack([c.sorted_segmap for c in w]),
        binning=jax.tree.map(lambda *xs: jnp.stack(xs), *binnings),
        sel_tiles=None if sel is None else jnp.asarray(_np(sel)))


@pytest.mark.parametrize("name", ["semantic_plain", "semantic_mv",
                                  "semantic_mv_sub"])
def test_semantic_variants_match_jax(sem, name):
    """Camera 0's step of each variant, the port's loss with JAX's draws
    (key 0, replayed from its splits) against the loss of JAX's
    semantic_train_step composed from its functions on its CPU path (the
    XLA-layout caches; the tile-subsampled window on visit caches, Pallas
    in interpret mode): the loss at rtol 1e-4 and the feature gradient
    within 3e-3 of its largest |value|."""
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.pipelines import train_semantic as jts
    from instascene_tpu.semantic.contrastive import (sample_from_ids,
                                                     sample_valid_pixels)
    from instascene_tpu_torch.pipelines import train_semantic as ts
    p, cams, hyp, scfg = sem["p"], sem["cams"], sem["hyp"], sem["scfg"]
    mv = sem["windows"][name]
    jp, jcam = sem["jp"], sem["jcams"][0]
    W, H, B, ML = (scfg.raster.width, scfg.raster.height, scfg.batch,
                   scfg.max_labels)
    jcfg = JCfg(width=W, height=H, bwd_extras_only=True, extras_dim=16,
                tune_gather=False)
    jmv = None
    if mv is not None and mv.sel_tiles is not None:
        jmv = _jax_window(sem["jcams"], sem["visits"], mv.sel_tiles)
        jcfg_tiles = JCfg(width=W, height=H, impl="pallas",
                          bwd_extras_only=True, extras_dim=16,
                          tune_gather=False)
    elif mv is not None:
        jmv = _jax_window(sem["jcams"], [c.binning for c in
                                         sem["jcams"][1:6]], None)
    lab3d, bg = jnp.asarray(_np(hyp.seg3d_labels)), jnp.zeros(3)
    k, k_sv = jax.random.split(jax.random.PRNGKey(0))
    _, sub = jax.random.split(k)

    def jloss(f):
        out = jts.render_features(jp, _jax_cam(jcam), bg, jcfg, f,
                                  jcam.binning)
        total = jts.single_view_and_3d_losses(
            jp, f, out, k_sv, jcam.segmap, jcam.sorted_segmap, lab3d, None,
            jnp.float32(hyp.lam_sv), jnp.float32(hyp.lam_3d), B, ML, False,
            True, jcam.seg_samp, jcam.sorted_samp, jcam.vis3d_samp, tile=16)
        if jmv is not None and jmv.sel_tiles is not None:
            cl, _ = jts._mv_tile_subsample_loss(jp, f, jmv, sub, None, B,
                                                ML, jcfg_tiles)
            total = total + cl * jnp.float32(hyp.lam_mv)
        elif jmv is not None:
            total = total + jts._mv_full_loss(
                jp, f, jmv, sub, None, bg, B, ML,
                jcfg) * jnp.float32(hyp.lam_mv)
        return total

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp.seg_feature)
    jg = np.asarray(jg)
    # the draws the loss made, replayed from its keys
    sv_draws, _ = jts._draw_sv_pixel_idx(
        k_sv, jcam.segmap, jcam.sorted_segmap, None, B, False, True,
        jcam.seg_samp, jcam.sorted_samp)
    k3 = k_sv
    for _ in sv_draws:
        k3, _ = jax.random.split(k3)
    _, sub3 = jax.random.split(k3)
    t = lambda a: torch.as_tensor(np.array(a)).long()
    draws = {"sv": [t(d[0]) for d in sv_draws],
             "d3": t(sample_from_ids(sub3, jcam.vis3d_samp, B)[0])}
    if mv is not None:
        valid = (ts._tile_labels(mv) if mv.sel_tiles is not None
                 else ts._window_labels(mv)) > 0
        draws["mv"] = t(sample_valid_pixels(sub, jnp.asarray(valid.numpy()),
                                            B)[0])
    seg = p.seg_feature.clone().requires_grad_(True)
    tl = ts.semantic_loss(p, seg, cams[0], mv, hyp, scfg, draws)
    (tg,) = torch.autograd.grad(tl, [seg])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    scale = np.abs(jg).max()
    assert scale > 0 and np.isfinite(tg.numpy()).all()
    assert np.abs(tg.numpy() - jg).max() <= 3e-3 * scale
