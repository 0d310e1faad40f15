"""Feature widths other than 16: the semantic step at --seg_feat_dim 8
(ModelParams.seg_feat_dim, the root CLI's flag) against the JAX package's,
with JAX's draws injected, on test_torch_semantic_step's e2e scene. On the
card every kernel takes the width (test_torch_kernel.py's
test_cuda_runtime_width_matches_plain); this is its reference."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_torch_semantic_step import BATCH, MAX_LABELS, e2e  # noqa: F401

E = 8


def test_semantic_step_at_feat_dim_8_matches_jax(e2e, tmp_path):
    """The single-view, 3D and multi-view losses of one step with 8-channel
    features: the loss at rtol 1e-4 of JAX's and the feature gradient
    within 3e-3 of its largest |value|."""
    from instascene_tpu.config import ModelParams as JModel
    from instascene_tpu.config import OptimizationParams as JOpt
    from instascene_tpu.config import PipelineParams as JPipe
    from instascene_tpu.models.optimizer import semantic_lrs as jlrs
    from instascene_tpu.ops.rasterize import CameraMats as JCam
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.pipelines import train_semantic as jts
    from instascene_tpu.semantic.contrastive import (sample_from_ids,
                                                     sample_valid_pixels)
    from instascene_tpu_torch.config import (ModelParams,
                                             OptimizationParams,
                                             PipelineParams)
    from instascene_tpu_torch.models.optimizer import semantic_lrs
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines import train_semantic as ts

    src, labels, _, _ = e2e
    feat = np.random.default_rng(9).random((len(labels), E)).astype(
        np.float32)
    jseg = jts.SegSplatting(JModel(source_path=src, use_seg_feature=True,
                                   seg_feat_dim=E), JOpt(), JPipe(),
                            output_root=str(tmp_path / "j"))
    jseg._load_scene()
    jseg.params = jseg.params.replace(seg_feature=jnp.asarray(feat))
    jseg.seg3d_labels_padded = jnp.asarray(labels)
    jseg._precompute_binning()
    jseg._precompute_sampling()
    jb = jseg._camera_bundles()
    tseg = ts.SegSplatting(ModelParams(source_path=src, use_seg_feature=True,
                                       seg_feat_dim=E), OptimizationParams(),
                           PipelineParams(), output_root=str(tmp_path / "t"),
                           device="cpu")
    tseg._load_scene()
    tseg.params = tseg.params.replace(seg_feature=torch.as_tensor(feat))
    tseg.seg3d_labels_padded = torch.as_tensor(labels)
    tseg._precompute_binning()
    tseg._precompute_sampling()
    tb = tseg._camera_bundles()

    opt = OptimizationParams(lambda_singview_contras=1.0,
                             lambda_multiview_contras=0.7,
                             lambda_3D_contras=0.5)
    W, H = int(tseg.cam_objs[0].width), int(tseg.cam_objs[0].height)
    ci, window = 3, [1, 2, 3, 4, 5]
    jhyp = jts.SemanticHypers(
        bg=jseg.bg, lrs=jlrs(JOpt()), lam_sv=jnp.float32(1.0),
        lam_mv=jnp.float32(0.7), lam_3d=jnp.float32(0.5),
        seg3d_labels=jnp.asarray(labels), class_feat=None)
    jcfg = JCfg(width=W, height=H, bwd_extras_only=True, extras_dim=E)
    jmv = jts.SemanticMVBlock(
        w2v=jnp.stack([jb[v].w2v for v in window]),
        full_proj=jnp.stack([jb[v].full_proj for v in window]),
        campos=jnp.stack([jb[v].campos for v in window]),
        segmaps=jnp.stack([jb[v].sorted_segmap for v in window]),
        binning=jax.tree.map(lambda *xs: jnp.stack(xs),
                             *[jb[v].binning for v in window]))
    cam = jb[ci]
    key = jax.random.PRNGKey(6)

    def jloss(seg_feature):
        k, k_sv = jax.random.split(key)
        out = jts.render_features(
            jseg.params, JCam(cam.w2v, cam.full_proj, cam.campos), jhyp.bg,
            jcfg, seg_feature, cam.binning)
        total = jts.single_view_and_3d_losses(
            jseg.params, seg_feature, out, k_sv, cam.segmap,
            cam.sorted_segmap, jhyp.seg3d_labels, None, jhyp.lam_sv,
            jhyp.lam_3d, BATCH, MAX_LABELS, False, True, cam.seg_samp,
            cam.sorted_samp, cam.vis3d_samp)
        _, sub = jax.random.split(k)
        return total + jts._mv_full_loss(
            jseg.params, seg_feature, jmv, sub, None, jhyp.bg, BATCH,
            MAX_LABELS, jcfg) * jhyp.lam_mv

    jl, jg = jax.value_and_grad(jloss)(jseg.params.seg_feature)
    jg = np.asarray(jg)
    assert jg.shape == (len(labels), E)

    # JAX's draws, replayed from the same key splits
    k, k_sv = jax.random.split(key)
    sv, _ = jts._draw_sv_pixel_idx(k_sv, cam.segmap, cam.sorted_segmap, None,
                                   BATCH, False, True, cam.seg_samp,
                                   cam.sorted_samp)
    k3 = k_sv
    for _ in sv:
        k3, _ = jax.random.split(k3)
    _, sub = jax.random.split(k3)
    _, sub_mv = jax.random.split(k)
    long = lambda a: torch.as_tensor(np.array(a)).long()
    draws = {"sv": [long(d[0]) for d in sv],
             "d3": long(sample_from_ids(sub, cam.vis3d_samp, BATCH)[0]),
             "mv": long(sample_valid_pixels(
                 sub_mv, jmv.segmaps.reshape(-1) > 0, BATCH)[0])}

    hyp = ts.SemanticHypers(
        bg=tseg.bg, lrs=semantic_lrs(opt), lam_sv=1.0, lam_mv=0.7,
        lam_3d=0.5, seg3d_labels=torch.as_tensor(labels), class_feat=None)
    scfg = ts.SemanticStepConfig(
        raster=RasterizeConfig(W, H, bwd_extras_only=True), batch=BATCH,
        max_labels=MAX_LABELS)
    mv = ts.SemanticMVBlock([tb[v] for v in window])
    seg = tseg.params.seg_feature.clone().requires_grad_(True)
    tl = ts.semantic_loss(tseg.params, seg, tb[ci], mv, hyp, scfg, draws)
    (tg,) = torch.autograd.grad(tl, [seg])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    scale = np.abs(jg).max()
    assert scale > 0 and np.isfinite(tg.numpy()).all()
    assert np.abs(tg.numpy() - jg).max() <= 3e-3 * scale
