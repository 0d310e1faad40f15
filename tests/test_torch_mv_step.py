"""The semantic step with each multi-view flag — --mv_tile_subsample (K3/K4),
--mv_merged (K1/K2 tiles_per_view), --sparse_px (K5/K6, the window too),
and tile-subsample with sparse pixels — against the JAX package's step on
test_mv_merged's scene, with JAX's draws and tiles injected; and the port's
CLI with each flag on the CPU. JAX's loss is its semantic_train_step's
loss_fn (pipelines/train_semantic.py:545-682) for visit caches, composed
from its own functions, Pallas in interpret mode."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_mv_merged import (E, H, MAX_LABELS, W, port_cams,
                                  port_step_config, scene)

BATCH = 256
LAM = dict(sv=1.0, mv=0.7, d3=0.5)
VARIANTS = {            # (sparse_px, mv_merged, window, class anchors)
    "tiles": (False, False, "tiles", False),
    "merged": (False, True, "full", False),
    "sparse": (True, False, None, True),
    "sparse-window": (True, False, "full", False),
    "tiles-sparse": (True, False, "tiles", True),
}


def _jax_loss(params, cam, mv, hyp, cfg, key, sparse, merged, cf):
    """JAX's step loss as a function of seg_feature (no overflow at these
    sizes: asserted), and the JAX draws of the same keys."""
    from instascene_tpu.ops.blend_sparse import pick_sparse_s, spix_from_idx
    from instascene_tpu.ops.rasterize import CameraMats
    from instascene_tpu.pipelines import train_semantic as jts
    from instascene_tpu.semantic.contrastive import sample_valid_pixels
    T = ((W + 15) // 16) * ((H + 15) // 16)
    tiles = mv is not None and mv.sel_tiles is not None
    mv_full = mv is not None and not tiles
    cam_m = CameraMats(cam.w2v, cam.full_proj, cam.campos)
    k, k_sv = jax.random.split(key)
    sv_draws, _ = jts._draw_sv_pixel_idx(
        k_sv, cam.segmap, cam.sorted_segmap, cf, BATCH, False, True,
        cam.seg_samp, cam.sorted_samp)
    sv_idx = [d[0] for d in sv_draws]
    _, sub = jax.random.split(k)
    common = (hyp.seg3d_labels, cf, hyp.lam_sv, hyp.lam_3d, BATCH,
              MAX_LABELS, False, True, cam.seg_samp, cam.sorted_samp,
              cam.vis3d_samp)
    args = (cam.segmap, cam.sorted_segmap) + common

    def dense(f):
        done0 = jts._done0_from_idx(sv_idx, W, H, 16)
        out = jts.render_features(params, cam_m, hyp.bg, cfg, f, cam.binning,
                                  done0=done0)
        total = jts.single_view_and_3d_losses(params, f, out, k_sv, *args,
                                              tile=16, sv_draws=sv_draws)
        if mv_full:
            cl = (jts._mv_full_loss_merged(params, f, mv, sub, cf, BATCH,
                                           MAX_LABELS, cfg) if merged
                  else jts._mv_full_loss(params, f, mv, sub, cf, hyp.bg,
                                         BATCH, MAX_LABELS, cfg,
                                         sampled_done=True))
            total = total + cl * hyp.lam_mv
        return total

    idx_all = jnp.concatenate(sv_idx)
    S_sv = pick_sparse_s(int(idx_all.shape[0]), T)
    spix_sv, t_of, slot_of, overflow = spix_from_idx(idx_all, W, H, 16, S_sv)
    mv_draw = sample_valid_pixels(sub, mv.segmaps.reshape(-1) > 0, BATCH) \
        if mv_full else None
    if mv_full and sparse:
        view_of, pix = mv_draw[0] // (H * W), mv_draw[0] % (H * W)
        S_mv = pick_sparse_s(BATCH, mv.w2v.shape[0] * T)
        spix_l, tl, sl = [], None, None
        for v in range(mv.w2v.shape[0]):
            sp_v, t_v, s_v, ov = spix_from_idx(pix, W, H, 16, S_mv,
                                               valid=view_of == v)
            overflow = overflow | ov
            spix_l.append(sp_v)
            tl = t_v if tl is None else jnp.where(view_of == v, t_v, tl)
            sl = s_v if sl is None else jnp.where(view_of == v, s_v, sl)
    assert not bool(overflow)

    def sparse_branch(f):
        featn = f / (jnp.linalg.norm(f, axis=1, keepdims=True) + 1e-6)
        feat_sv, visible = jts._sparse_view_feats(
            params, featn, cam.w2v, cam.full_proj, cam.campos, cam.binning,
            cfg, spix_sv, S_sv)

        def fetch(si, _idx):
            s_ = slice(si * BATCH, (si + 1) * BATCH)
            return feat_sv[t_of[s_], slot_of[s_], :]

        total = jts.single_view_and_3d_losses(
            params, f, None, k_sv, *args, tile=16, sv_draws=sv_draws,
            fetch_override=fetch, visible_override=visible)
        if mv_full:
            total = total + jts._mv_full_loss_sparse(
                params, f, featn, mv, mv_draw, cf, BATCH, MAX_LABELS, cfg,
                spix_l, tl, sl, S_mv) * hyp.lam_mv
        return total

    def loss(f):
        total = sparse_branch(f) if sparse else dense(f)
        if tiles:
            cl, n_trunc = jts._mv_tile_subsample_loss(
                params, f, mv, sub, cf, BATCH, MAX_LABELS, cfg)
            total = total + cl * hyp.lam_mv
        return total

    k3 = k_sv
    for _ in sv_draws:
        k3, _ = jax.random.split(k3)
    _, sub3 = jax.random.split(k3)
    from instascene_tpu.semantic.contrastive import sample_from_ids
    draws = {"sv": [np.asarray(i) for i in sv_idx],
             "d3": np.asarray(sample_from_ids(sub3, cam.vis3d_samp,
                                              BATCH)[0])}
    return loss, draws, sub


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_semantic_step_variant_matches_jax(variant):
    """With JAX's draws (and selected tiles) injected: the loss at rtol
    1e-4 and the feature gradient within 3e-3 of its largest |value| (slice
    3's bar); the step reports that loss and moves only the features. The
    launch of the path's dense fallback never happens here."""
    from instascene_tpu.config import OptimizationParams as JOpt
    from instascene_tpu.models.optimizer import semantic_lrs as jlrs
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.pipelines import train_semantic as jts
    from instascene_tpu.semantic.contrastive import (sample_valid_pixels,
                                                     valid_ids_pack)
    from instascene_tpu_torch.config import OptimizationParams
    from instascene_tpu_torch.models.optimizer import (init_adam_state,
                                                       semantic_lrs)
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.pipelines import train_semantic as ts
    sparse, merged, window, anchors = VARIANTS[variant]
    params, mv, tp, bins = scene()
    rng = np.random.default_rng(21)
    lab3d = rng.integers(0, 6, params.capacity).astype(np.int32)
    cf = rng.random((MAX_LABELS, E)).astype(np.float32)
    cf /= np.linalg.norm(cf, axis=1, keepdims=True)
    sel = np.stack([np.sort(rng.choice(12, 5, replace=False))
                    for _ in range(2)]).astype(np.int32)

    # JAX: camera 0, the window of views 1-2
    pick = lambda a, v: jax.tree.map(lambda x: x[v], a)
    seg0 = mv.segmaps[0]
    pk = valid_ids_pack(seg0.reshape(-1) > 0)
    jcam = jts.SemanticCamera(
        w2v=mv.w2v[0], full_proj=mv.full_proj[0], campos=mv.campos[0],
        segmap=seg0, sorted_segmap=seg0, binning=pick(mv.binning, 0),
        seg_samp=pk, sorted_samp=pk,
        vis3d_samp=valid_ids_pack(jnp.asarray(lab3d) > 0))
    jmv = None
    if window:
        w = slice(1, 3)
        jmv = jts.SemanticMVBlock(
            w2v=mv.w2v[w], full_proj=mv.full_proj[w], campos=mv.campos[w],
            segmaps=mv.segmaps[w],
            binning=jax.tree.map(lambda x: x[w], mv.binning),
            sel_tiles=jnp.asarray(sel) if window == "tiles" else None)
    jhyp = jts.SemanticHypers(
        bg=jnp.zeros(3), lrs=jlrs(JOpt()), lam_sv=jnp.float32(LAM["sv"]),
        lam_mv=jnp.float32(LAM["mv"]), lam_3d=jnp.float32(LAM["d3"]),
        seg3d_labels=jnp.asarray(lab3d),
        class_feat=jnp.asarray(cf) if anchors else None)
    jcfg = JCfg(width=W, height=H, impl="pallas", bwd_extras_only=True,
                extras_dim=E)
    loss, draws, sub = _jax_loss(params, jcam, jmv, jhyp, jcfg,
                                 jax.random.PRNGKey(7), sparse, merged,
                                 jhyp.class_feat)
    jl, jg = jax.value_and_grad(loss)(params.seg_feature)
    jg = np.asarray(jg)

    cams = port_cams(mv, bins, lab3d)
    tmv = None
    if window:
        tmv = ts.SemanticMVBlock(cams[1:3], torch.as_tensor(sel)
                                 if window == "tiles" else None)
        valid = (ts._tile_labels(tmv) if window == "tiles"
                 else ts._window_labels(tmv)) > 0
        draws["mv"] = np.asarray(sample_valid_pixels(
            sub, jnp.asarray(valid.numpy()), BATCH)[0])
    hyp = ts.SemanticHypers(
        bg=torch.zeros(3), lrs=semantic_lrs(OptimizationParams()),
        lam_sv=LAM["sv"], lam_mv=LAM["mv"], lam_3d=LAM["d3"],
        seg3d_labels=torch.as_tensor(lab3d),
        class_feat=torch.as_tensor(cf) if anchors else None)
    scfg = port_step_config(merged=merged, sparse=sparse, batch=BATCH)
    idraws = {"sv": [torch.as_tensor(np.array(a)).long()
                     for a in draws["sv"]],
              **{k: torch.as_tensor(np.array(v)).long()
                 for k, v in draws.items() if k != "sv"}}
    fallbacks = LAUNCHES["sparse_fallback"]
    seg = tp.seg_feature.clone().requires_grad_(True)
    tl = ts.semantic_loss(tp, seg, cams[0], tmv, hyp, scfg, idraws)
    (tg,) = torch.autograd.grad(tl, [seg])
    assert LAUNCHES["sparse_fallback"] == fallbacks
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    scale = np.abs(jg).max()
    assert scale > 0 and np.isfinite(tg.numpy()).all()
    assert np.abs(tg.numpy() - jg).max() <= 3e-3 * scale

    state = init_adam_state(tp)
    p1, s1, l1 = ts.semantic_train_step(tp, state, cams[0], tmv, hyp, scfg,
                                        draws=draws)
    assert float(l1) == float(tl.detach()) and s1.count == 1
    assert torch.equal(p1.xyz, tp.xyz)
    assert not torch.equal(p1.seg_feature, tp.seg_feature)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    from scene_builder import build_e2e_scene
    d = tmp_path_factory.mktemp("mvcli") / "parent" / "scene"
    build_e2e_scene(str(d))
    return str(d)


@pytest.mark.parametrize("flags", [
    ["--mv_tile_subsample", "4"], ["--mv_merged", "1"], ["--sparse_px", "1"],
    ["--mv_tile_subsample", "4", "--sparse_px", "1"]],
    ids=["tiles", "merged", "sparse", "tiles-sparse"])
def test_cli_runs_with_each_flag(e2e, tmp_path, flags):
    """python -m instascene_tpu_torch.train_semantic with each flag on the
    CPU (20 iterations: two windows): a finite loss, the PLY with
    segfeat_0..15 at the last iteration, the HDBSCAN export. At 64 draws
    per set no tile overflows its slots, so --sparse_px takes the sparse
    path on every step (at 1024 on this 12-tile frame every step would
    fall back to the dense one)."""
    from instascene_tpu_torch import train_semantic
    from instascene_tpu_torch.data.ply import read_ply
    from instascene_tpu_torch.cuda_build import LAUNCHES
    src = shutil.copytree(e2e, str(tmp_path / "data" / "parent" / "scene"))
    out = str(tmp_path / "out")
    fallbacks = LAUNCHES["sparse_fallback"]
    seg = train_semantic.main(["-s", src, "-m", out, "--use_seg_feature",
                               "--device", "cpu", "--iterations", "20",
                               "--sample_batchsize", "64", *flags])
    assert LAUNCHES["sparse_fallback"] == fallbacks
    assert np.isfinite(seg.last_loss)
    f = seg.params.seg_feature
    assert torch.isfinite(f).all()
    ply = os.path.join(out, "point_cloud", "iteration_20", "point_cloud.ply")
    names = read_ply(ply)["vertex"].dtype.names
    assert all(f"segfeat_{i}" in names for i in range(16))
    assert os.path.exists(os.path.join(out, "point_cloud",
                                       "iteration_20_hdbscan",
                                       "point_cloud_labels.ply"))
