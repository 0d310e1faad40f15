"""The semantic step: ProtoNCE and its samplers, and the whole contrastive
step (render with cached binning, sampled-pixel masks, single-view, 3D and
multi-view losses, Adam on the features) against the JAX package's on the
synthetic e2e scene, with JAX's pixel draws injected. JAX runs its CPU
path (the XLA blend over its padded cache, no done masks); the port runs
K1/K2 extras_only's plain versions with done masks."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scene_builder import build_e2e_scene

MAX_LABELS = 8
BATCH = 512


def _proto_inputs(seed, b=300, d=16, max_labels=MAX_LABELS):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(b, d)).astype(np.float32)
    # labels 0..5 only: clusters 6, 7 (and after the shift, 5) are absent
    lab = rng.integers(0, 6, b).astype(np.int32)
    u = rng.normal(size=(max_labels, d)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return f, lab, u


@pytest.mark.parametrize("predef,neg", [(False, False), (True, False),
                                        (False, True), (True, True)],
                         ids=["mean", "anchors", "negative",
                              "anchors-negative"])
def test_contrastive_loss_matches_jax(predef, neg):
    """Loss and its gradient at rtol 1e-5 (gradients within 1e-5 of the
    largest), with and without predefined anchors and label 0 kept or
    dropped, with absent clusters."""
    from instascene_tpu.semantic.contrastive import contrastive_loss as jcl
    from instascene_tpu_torch.semantic.contrastive import contrastive_loss
    f, lab, u = _proto_inputs(int(predef) + 2 * int(neg))
    ju = jnp.asarray(u) if predef else None
    jl, jg = jax.value_and_grad(lambda x: jcl(
        x, jnp.asarray(lab), MAX_LABELS, predef_u=ju,
        consider_negative=neg))(jnp.asarray(f))
    tf = torch.as_tensor(f).requires_grad_(True)
    tl = contrastive_loss(tf, torch.as_tensor(lab), MAX_LABELS,
                          predef_u=torch.as_tensor(u) if predef else None,
                          consider_negative=neg)
    (tg,) = torch.autograd.grad(tl, [tf])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


def test_samplers():
    """valid_ids_pack equals JAX's; sample_from_ids draws only valid
    indices, uniformly (chi-square), and the window pack maps each draw r to
    the index JAX's prefix-sum search gives for it."""
    from instascene_tpu.semantic.contrastive import valid_ids_pack as jpack
    from instascene_tpu_torch.pipelines.train_semantic import (
        SemanticMVBlock, _mv_pack)
    from instascene_tpu_torch.semantic.contrastive import (sample_from_ids,
                                                           valid_ids_pack)
    rng = np.random.default_rng(0)
    valid = rng.random(500) < 0.3
    pack = valid_ids_pack(torch.as_tensor(valid))
    np.testing.assert_array_equal(pack.numpy(),
                                  np.asarray(jpack(jnp.asarray(valid))))
    nv = int(valid.sum())
    gen = torch.Generator().manual_seed(1)
    idx, ok = sample_from_ids(gen, pack, 200_000, nv)
    assert ok and valid[idx.numpy()].all()
    counts = np.bincount(idx.numpy(), minlength=500)[valid]
    expect = 200_000 / nv
    chi2 = ((counts - expect) ** 2 / expect).sum()
    assert chi2 < nv + 5 * np.sqrt(2 * nv), chi2

    class Cam:
        def __init__(self, m):
            self.sorted_segmap = torch.as_tensor(m)
            self.sorted_samp = valid_ids_pack(self.sorted_segmap.reshape(-1)
                                              > 0)
            self.sorted_nv = int((m > 0).sum())

    maps = rng.integers(0, 3, (3, 6, 7)) * (rng.random((3, 6, 7)) < 0.5)
    wpack, wnv = _mv_pack(SemanticMVBlock([Cam(m) for m in maps]))
    csum = np.cumsum(maps.reshape(-1) > 0)
    r = np.arange(wnv)
    np.testing.assert_array_equal(wpack[:-1].numpy(),
                                  np.searchsorted(csum, r, side="right"))
    assert int(wpack[-1]) == wnv == csum[-1]


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The e2e scene, with sam/mask_sorted = sam/mask (so the sorted-segmap
    loss has labels), random unit features and the blobs' 3D labels."""
    d = tmp_path_factory.mktemp("step") / "parent" / "scene"
    _, labels, _ = build_e2e_scene(str(d))
    shutil.copytree(os.path.join(d, "sam", "mask"),
                    os.path.join(d, "sam", "mask_sorted"))
    rng = np.random.default_rng(8)
    feat = rng.random((len(labels), 16)).astype(np.float32)
    cf = rng.random((MAX_LABELS, 16)).astype(np.float32)
    cf /= np.linalg.norm(cf, axis=1, keepdims=True)
    return str(d), labels.astype(np.int32), feat, cf


def _jax_setup(src, labels, feat, out):
    from instascene_tpu.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from instascene_tpu.pipelines.train_semantic import SegSplatting
    seg = SegSplatting(ModelParams(source_path=src, use_seg_feature=True),
                       OptimizationParams(), PipelineParams(),
                       output_root=out)
    seg._load_scene()
    seg.params = seg.params.replace(seg_feature=jnp.asarray(feat))
    seg.seg3d_labels_padded = jnp.asarray(labels)
    seg._precompute_binning()
    seg._precompute_sampling()
    return seg, seg._camera_bundles()


def _port_setup(src, labels, feat, out):
    from instascene_tpu_torch.config import (ModelParams,
                                             OptimizationParams,
                                             PipelineParams)
    from instascene_tpu_torch.pipelines.train_semantic import SegSplatting
    seg = SegSplatting(ModelParams(source_path=src, use_seg_feature=True),
                       OptimizationParams(), PipelineParams(),
                       output_root=out, device="cpu")
    seg._load_scene()
    seg.params = seg.params.replace(seg_feature=torch.as_tensor(feat))
    seg.seg3d_labels_padded = torch.as_tensor(labels)
    seg._precompute_binning()
    seg._precompute_sampling()
    return seg, seg._camera_bundles()


@pytest.mark.parametrize("with_mv,with_cf,neg", [
    (False, False, False), (True, False, True), (False, True, False),
    (True, True, False)], ids=["sv", "mv-negative", "anchors", "mv-anchors"])
def test_semantic_step_matches_jax(e2e, tmp_path, with_mv, with_cf, neg):
    """With JAX's draws injected: the loss at rtol 1e-4 and the feature
    gradient within 3e-3 of its largest |value|; the port's step then
    moves only the features, by Adam on that gradient."""
    from instascene_tpu.models.optimizer import semantic_lrs as jlrs
    from instascene_tpu.ops.rasterize import CameraMats as JCam
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.pipelines import train_semantic as jts
    from instascene_tpu.semantic.contrastive import (sample_from_ids,
                                                     sample_valid_pixels)
    from instascene_tpu_torch.config import OptimizationParams
    from instascene_tpu_torch.models.optimizer import (init_adam_state,
                                                       semantic_lrs)
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines import train_semantic as ts

    src, labels, feat, cf = e2e
    jseg, jb = _jax_setup(src, labels, feat, str(tmp_path / "j"))
    tseg, tb = _port_setup(src, labels, feat, str(tmp_path / "t"))
    opt = OptimizationParams(lambda_singview_contras=1.0,
                             lambda_multiview_contras=0.7,
                             lambda_3D_contras=0.5)
    W, H = int(tseg.cam_objs[0].width), int(tseg.cam_objs[0].height)
    ci, window = 3, [1, 2, 3, 4, 5]
    jcf = jnp.asarray(cf) if with_cf else None
    jhyp = jts.SemanticHypers(
        bg=jseg.bg, lrs=jlrs(opt), lam_sv=jnp.float32(1.0),
        lam_mv=jnp.float32(0.7), lam_3d=jnp.float32(0.5),
        seg3d_labels=jnp.asarray(labels), class_feat=jcf)
    jcfg = JCfg(width=W, height=H, bwd_extras_only=True, extras_dim=16)
    jmv = None
    if with_mv:
        jmv = jts.SemanticMVBlock(
            w2v=jnp.stack([jb[v].w2v for v in window]),
            full_proj=jnp.stack([jb[v].full_proj for v in window]),
            campos=jnp.stack([jb[v].campos for v in window]),
            segmaps=jnp.stack([jb[v].sorted_segmap for v in window]),
            binning=jax.tree.map(lambda *xs: jnp.stack(xs),
                                 *[jb[v].binning for v in window]))
    cam = jb[ci]
    key = jax.random.PRNGKey(5)

    def jloss(seg_feature):
        # semantic_train_step's loss_fn on the CPU (XLA) path
        k, k_sv = jax.random.split(key)
        out = jts.render_features(
            jseg.params, JCam(cam.w2v, cam.full_proj, cam.campos), jhyp.bg,
            jcfg, seg_feature, cam.binning)
        total = jts.single_view_and_3d_losses(
            jseg.params, seg_feature, out, k_sv, cam.segmap,
            cam.sorted_segmap, jhyp.seg3d_labels, jcf, jhyp.lam_sv,
            jhyp.lam_3d, BATCH, MAX_LABELS, neg, True, cam.seg_samp,
            cam.sorted_samp, cam.vis3d_samp)
        if jmv is not None:
            _, sub = jax.random.split(k)
            total = total + jts._mv_full_loss(
                jseg.params, seg_feature, jmv, sub, jcf, jhyp.bg, BATCH,
                MAX_LABELS, jcfg) * jhyp.lam_mv
        return total

    jl, jg = jax.value_and_grad(jloss)(jseg.params.seg_feature)
    jg = np.asarray(jg)

    # JAX's draws, replayed from the same key splits
    k, k_sv = jax.random.split(key)
    sv, _ = jts._draw_sv_pixel_idx(k_sv, cam.segmap, cam.sorted_segmap, jcf,
                                   BATCH, neg, True, cam.seg_samp,
                                   cam.sorted_samp)
    k3 = k_sv
    for _ in sv:
        k3, _ = jax.random.split(k3)
    _, sub = jax.random.split(k3)
    draws = {"sv": [np.asarray(d[0]) for d in sv],
             "d3": np.asarray(sample_from_ids(sub, cam.vis3d_samp,
                                              BATCH)[0])}
    if with_mv:
        _, sub = jax.random.split(k)
        draws["mv"] = np.asarray(sample_valid_pixels(
            sub, jmv.segmaps.reshape(-1) > 0, BATCH)[0])

    hyp = ts.SemanticHypers(
        bg=tseg.bg, lrs=semantic_lrs(opt), lam_sv=1.0, lam_mv=0.7,
        lam_3d=0.5, seg3d_labels=torch.as_tensor(labels),
        class_feat=torch.as_tensor(cf) if with_cf else None)
    scfg = ts.SemanticStepConfig(
        raster=RasterizeConfig(W, H, bwd_extras_only=True), batch=BATCH,
        max_labels=MAX_LABELS, consider_negative=neg)
    mv = ts.SemanticMVBlock([tb[v] for v in window]) if with_mv else None
    idraws = {"sv": [torch.as_tensor(np.array(a)).long() for a in draws["sv"]],
              **{k_: torch.as_tensor(np.array(v)).long()
                 for k_, v in draws.items()
                 if k_ != "sv"}}
    seg = tseg.params.seg_feature.clone().requires_grad_(True)
    tl = ts.semantic_loss(tseg.params, seg, tb[ci], mv, hyp, scfg, idraws)
    (tg,) = torch.autograd.grad(tl, [seg])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    scale = np.abs(jg).max()
    assert scale > 0 and np.isfinite(tg.numpy()).all()
    assert np.abs(tg.numpy() - jg).max() <= 3e-3 * scale

    state = init_adam_state(tseg.params)
    p1, s1, l1 = ts.semantic_train_step(tseg.params, state, tb[ci], mv, hyp,
                                        scfg, draws=draws)
    assert float(l1) == float(tl) and s1.count == 1
    for f in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
        assert torch.equal(getattr(p1, f), getattr(tseg.params, f)), f
        assert torch.equal(s1.m[f], state.m[f]), f
    g = tg
    want = tseg.params.seg_feature - hyp.lrs["seg_feature"] * (
        (0.1 * g) / 0.1) / (torch.sqrt(0.001 * g * g / 0.001) + 1e-15)
    torch.testing.assert_close(p1.seg_feature, want, rtol=1e-5, atol=1e-6)


def test_jax_step_loss_is_the_composed_loss(e2e, tmp_path):
    """The loss the test above composes from the JAX package's functions
    is the one its jitted semantic_train_step reports (plain step, no
    anchors), so the comparison holds the port to JAX's step."""
    from instascene_tpu.models.optimizer import init_adam_state, semantic_lrs
    from instascene_tpu.ops.rasterize import CameraMats as JCam
    from instascene_tpu.ops.rasterize import RasterizeConfig as JCfg
    from instascene_tpu.pipelines import train_semantic as jts
    from instascene_tpu_torch.config import OptimizationParams
    src, labels, feat, _ = e2e
    jseg, jb = _jax_setup(src, labels, feat, str(tmp_path / "j"))
    W, H = int(jseg.cam_objs[0].width), int(jseg.cam_objs[0].height)
    hyp = jts.SemanticHypers(
        bg=jseg.bg, lrs=semantic_lrs(OptimizationParams()),
        lam_sv=jnp.float32(1.0), lam_mv=jnp.float32(0.7),
        lam_3d=jnp.float32(0.5), seg3d_labels=jnp.asarray(labels))
    cfg = JCfg(width=W, height=H, bwd_extras_only=True, extras_dim=16)
    scfg = jts.SemanticStepConfig(raster=cfg, batch=BATCH,
                                  max_labels=MAX_LABELS)
    key = jax.random.PRNGKey(5)
    cam = jb[3]
    _, _, loss, _ = jts.semantic_train_step(
        jseg.params, init_adam_state(jseg.params), key, cam, None, hyp, scfg)
    k, k_sv = jax.random.split(key)
    out = jts.render_features(jseg.params, JCam(cam.w2v, cam.full_proj,
                                                cam.campos), hyp.bg, cfg,
                              jseg.params.seg_feature, cam.binning)
    want = jts.single_view_and_3d_losses(
        jseg.params, jseg.params.seg_feature, out, k_sv, cam.segmap,
        cam.sorted_segmap, hyp.seg3d_labels, None, hyp.lam_sv, hyp.lam_3d,
        BATCH, MAX_LABELS, False, True, cam.seg_samp, cam.sorted_samp,
        cam.vis3d_samp)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
