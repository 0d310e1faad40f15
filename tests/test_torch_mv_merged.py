"""The merged multi-view loss (--mv_merged: the window's views concatenated
along the tile axis, one K1 and one K2 launch in their tiles_per_view mode)
against the JAX package's `_mv_full_loss_merged` (Pallas in interpret mode)
and against the port's own per-view loss, on test_mv_merged's scene (90
gaussians, three views at 64x48, E = 8). Also the scene helpers the other
multi-view tests share: the JAX visit caches' pair lists become the port's
BinningOut, so both packages walk the same pairs."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_mv_merged import E, H, W, _setup
from test_torch_blend_bwd import _runs

BATCH, MAX_LABELS = 512, 8
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "alive", "seg_feature")


def port_binning(cb, n):
    """The port's BinningOut of a JAX VisitBinningCache (one view): its
    compact pair list, tile ranges and per-gaussian runs."""
    from instascene_tpu_torch.ops.binning import BinningOut
    tb = np.asarray(cb.tile_bounds).astype(np.int32)
    total = int(tb[-1])
    gid = torch.as_tensor(np.asarray(cb.sorted_gid)[:total].astype(np.int32))
    return BinningOut(gid, torch.as_tensor(tb[:-1]), torch.as_tensor(tb[1:]),
                      total, *_runs(gid, n))


def scene(seed=5):
    """(JAX params, JAX window of the three views with their visit caches,
    the port's params, the port's per-view BinningOut)."""
    from instascene_tpu_torch.models.gaussians import from_numpy
    params, mv = _setup(np.random.default_rng(seed))
    tp = from_numpy({k: np.array(getattr(params, k)) for k in FIELDS},
                    device="cpu")
    bins = [port_binning(jax.tree.map(lambda a: a[v], mv.binning),
                         params.capacity) for v in range(mv.w2v.shape[0])]
    return params, mv, tp, bins


def port_cams(mv, bins, lab3d):
    """The port's SemanticCamera of each view: its camera, its segmap as
    raw and sorted map, its BinningOut and the sampler packs (the 3D pack
    over lab3d > 0)."""
    from instascene_tpu_torch.pipelines.train_semantic import SemanticCamera
    from instascene_tpu_torch.semantic.contrastive import valid_ids_pack
    t = lambda a: torch.as_tensor(np.array(a))
    vis = valid_ids_pack(t(lab3d) > 0)
    cams = []
    for v, b in enumerate(bins):
        seg = t(mv.segmaps[v])
        pack = valid_ids_pack(seg.reshape(-1) > 0)
        cams.append(SemanticCamera(
            t(mv.w2v[v]), t(mv.full_proj[v]), t(mv.campos[v]), seg, seg, b,
            pack, pack, vis, int(pack[-1]), int(pack[-1]), int(vis[-1])))
    return cams


def port_step_config(merged=False, sparse=False, batch=BATCH):
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines.train_semantic import (
        SemanticStepConfig)
    return SemanticStepConfig(raster=RasterizeConfig(W, H,
                                                     bwd_extras_only=True),
                              batch=batch, max_labels=MAX_LABELS,
                              mv_merged=merged, sparse_px=sparse)


def test_merged_loss_matches_jax_and_per_view():
    """With JAX's draw: the port's merged loss at rtol 1e-4 of JAX's and
    its feature gradient within 3e-3 of the largest |value| (the step's
    bar); against the port's per-view loss (done masks, one render per
    view) the loss is equal and the gradient within rtol 1e-5 (the JAX
    suite's bar between its merged and per-view paths)."""
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.pipelines.train_semantic import _mv_full_loss_merged
    from instascene_tpu.semantic.contrastive import sample_valid_pixels
    from instascene_tpu_torch.pipelines import train_semantic as ts
    params, mv, tp, bins = scene()
    jcfg = JCfg(width=W, height=H, impl="pallas", bwd_extras_only=True,
                extras_dim=E)
    key = jax.random.PRNGKey(3)
    jl, jg = jax.value_and_grad(lambda f: _mv_full_loss_merged(
        params, f, mv, key, None, BATCH, MAX_LABELS, jcfg))(
        params.seg_feature)
    jg = np.asarray(jg)
    idx = torch.as_tensor(np.asarray(sample_valid_pixels(
        key, mv.segmaps.reshape(-1) > 0, BATCH)[0])).long()

    lab3d = np.ones(params.capacity, np.int32)
    window = ts.SemanticMVBlock(port_cams(mv, bins, lab3d))
    hyp = ts.SemanticHypers(bg=torch.zeros(3), lrs={}, lam_sv=1.0,
                            lam_mv=1.0, lam_3d=1.0,
                            seg3d_labels=torch.as_tensor(lab3d))
    scfg = port_step_config(merged=True)
    got = {}
    for name, fn in (("merged", ts._mv_full_loss_merged),
                     ("per-view", ts._mv_full_loss)):
        seg = tp.seg_feature.clone().requires_grad_(True)
        loss = fn(tp, seg, window, hyp, scfg, idx)
        (g,) = torch.autograd.grad(loss, [seg])
        got[name] = (float(loss.detach()), g.numpy())
    tl, tg = got["merged"]
    np.testing.assert_allclose(tl, float(jl), rtol=1e-4)
    scale = np.abs(jg).max()
    assert scale > 0 and np.isfinite(tg).all()
    assert np.abs(tg - jg).max() <= 3e-3 * scale
    assert got["per-view"][0] == tl
    np.testing.assert_allclose(tg, got["per-view"][1], rtol=1e-5,
                               atol=1e-7)
