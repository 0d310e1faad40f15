"""The semantic stage's per-view exports (SegSplatting.render_views), the
feature map's own-PCA colours (feature_to_rgb without a projection) and
instance_miou, against the JAX package on the same numpy inputs."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scene_builder import build_e2e_scene


@pytest.mark.parametrize("seed,shape", [(0, (12, 10, 16)), (1, (48, 64, 16)),
                                        (2, (40, 30, 8))])
def test_feature_to_rgb_own_pca_matches_jax(seed, shape):
    """Without a projection both fit a PCA on the map (sklearn's in the
    JAX package, the port's own): uint8 within 1 LSB."""
    from instascene_tpu.semantic.export import feature_to_rgb as jf2rgb
    from instascene_tpu_torch.semantic.export import feature_to_rgb
    rng = np.random.default_rng(seed)
    fmap = rng.normal(size=shape).astype(np.float32)
    if seed:     # a few dominant directions, as trained features have
        fmap += 3 * rng.normal(size=(1, 1, shape[2])).astype(np.float32) * (
            rng.random(shape[:2] + (1,)) > 0.5)
    a = feature_to_rgb(fmap).astype(int)
    b = jf2rgb(fmap).astype(int)
    assert a.shape == b.shape == shape[:2] + (3,)
    assert np.abs(a - b).max() <= 1
    assert a.std() > 10


@pytest.mark.parametrize("seed,n,k_true,k_pred,ignore", [
    (0, 500, 4, 5, 0), (1, 2000, 8, 6, 0), (2, 300, 3, 3, -1),
    (3, 100, 1, 0, 0), (4, 50, 0, 2, 0), (5, 50, 0, 0, 0)])
def test_instance_miou_matches_jax(seed, n, k_true, k_pred, ignore):
    """Seeded random labels, with a true instance partly matched: the same
    float, exactly; and the shape check."""
    from instascene_tpu.semantic.metrics import instance_miou as jmiou
    from instascene_tpu_torch.semantic.metrics import instance_miou
    rng = np.random.default_rng(seed)
    true = rng.integers(0, k_true + 1, n) if k_true else np.zeros(n, int)
    pred = rng.integers(0, k_pred + 1, n) if k_pred else np.zeros(n, int)
    if k_true and k_pred:
        sel = rng.random(n) < 0.6
        pred[sel] = true[sel]
    got = instance_miou(pred, true, ignore_label=ignore)
    assert got == jmiou(pred, true, ignore_label=ignore)
    assert 0.0 <= got <= 1.0
    with pytest.raises(ValueError, match="shape"):
        instance_miou(pred[:-1], true)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The e2e scene, features one unit vector per blob plus noise, and
    the blobs as the 3D instance masks."""
    d = tmp_path_factory.mktemp("views") / "parent" / "scene"
    _, labels, _ = build_e2e_scene(str(d))
    rng = np.random.default_rng(3)
    feat = (np.eye(16, dtype=np.float32)[labels]
            + rng.normal(0, 0.1, (len(labels), 16)).astype(np.float32))
    masks = np.stack([labels == k for k in np.unique(labels)], axis=1)
    return str(d), feat, masks


def _seg(pkg, src, feat, masks, out):
    cfg = __import__(f"{pkg}.config", fromlist=["ModelParams"])
    ts = __import__(f"{pkg}.pipelines.train_semantic",
                    fromlist=["SegSplatting"])
    kw = {"device": "cpu"} if pkg == "instascene_tpu_torch" else {}
    seg = ts.SegSplatting(cfg.ModelParams(source_path=src,
                                          use_seg_feature=True),
                          cfg.OptimizationParams(), cfg.PipelineParams(),
                          output_root=out, **kw)
    seg.params = seg.params.replace(
        seg_feature=(torch.as_tensor(feat) if kw else jnp.asarray(feat)))
    seg.seg3d_masks = masks
    return seg


def test_render_views_match_jax(e2e, tmp_path, monkeypatch):
    """render_views(save_mask=True) on every view: the features' npy
    within atol 3e-4 of JAX's, each PNG within 1 LSB after decode_png;
    a second call reads the npy files instead of rendering."""
    from instascene_tpu_torch import render as trender
    from instascene_tpu_torch.utils.image import decode_png
    src, feat, masks = e2e
    js = _seg("instascene_tpu", src, feat, masks, str(tmp_path / "j"))
    ts = _seg("instascene_tpu_torch", src, feat, masks, str(tmp_path / "t"))
    js.render_views(save_mask=True)
    ts.render_views(save_mask=True)
    names = [c.image_name for c in ts.cam_objs]
    assert names == [c.image_name for c in js.cam_objs] and len(names) == 8
    jr = os.path.join(js.model_path, "render")
    tr = os.path.join(ts.model_path, "render")
    lit = 0
    for name in names:
        a = np.load(os.path.join(tr, "segfeat", f"{name}.npy"))
        b = np.load(os.path.join(jr, "segfeat", f"{name}.npy"))
        assert a.shape == b.shape == (48, 64, 16) and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=3e-4)
        for sub in ("segfeat", "segmask"):
            pa = decode_png(open(os.path.join(tr, sub, f"{name}.png"),
                                 "rb").read()).astype(int)
            pb = decode_png(open(os.path.join(jr, sub, f"{name}.png"),
                                 "rb").read()).astype(int)
            assert pa.shape == pb.shape == (48, 64, 3)
            assert np.abs(pa - pb).max() <= 1, (name, sub)
            if sub == "segmask":
                lit += int((pa > 0).any(-1).sum())
    assert lit > 100     # some pixels matched an instance

    def boom(*a, **k):
        raise AssertionError("render_views re-rendered a memoised view")
    monkeypatch.setattr(trender, "render", boom)
    ts.render_views(save_mask=False, view_idx=(0, 2))
