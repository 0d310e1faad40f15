"""The spatial track (priors stage): the port's tracker renders (K1 track's
plain version) and its numpy/scipy GausCluster against the JAX package's on
the synthetic 3-instance e2e scene — output_dict.npy and the rewritten
mask_sorted / mask_filtered label maps equal — and the csgraph components
against networkx's order."""

import os
import shutil

import numpy as np
import pytest

from scene_builder import build_e2e_scene


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("st") / "parent" / "scene"
    _, labels, _ = build_e2e_scene(str(d))
    return str(d), labels


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _jax_priors(src, out):
    from instascene_tpu.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from instascene_tpu.pipelines.train_semantic import SegSplatting
    seg = SegSplatting(ModelParams(source_path=src, use_seg_feature=True),
                       OptimizationParams(), PipelineParams(),
                       output_root=out)
    seg.robust_semantic_priors()
    return seg


def _port_priors(src, out):
    from instascene_tpu_torch.config import (ModelParams,
                                             OptimizationParams,
                                             PipelineParams)
    from instascene_tpu_torch.pipelines.train_semantic import SegSplatting
    seg = SegSplatting(ModelParams(source_path=src, use_seg_feature=True),
                       OptimizationParams(), PipelineParams(),
                       output_root=out, device="cpu")
    seg.robust_semantic_priors()
    return seg


def test_priors_match_jax(scene, tmp_path):
    """Tracker renders: contributor ids equal to JAX's XLA tracker (the
    JAX package's CPU path) but for at most 1e-4 of the entries (XLA sums
    the blend per 32-slot chunk, so a weight at the 0.1 threshold or a
    done latch can fall the other way; against the TPU kernel the ids are
    exact, test_torch_semantic_blend.py); then output_dict.npy
    (3D labels, undersegmented masks, the 2D clusters in their order) and
    the sam/mask_sorted and sam/mask_filtered maps equal; the priors and
    set_3d_feat's initial features equal too."""
    from PIL import Image
    src, _ = scene
    jsrc = _copy(src, str(tmp_path / "j" / "parent" / "scene"))
    tsrc = _copy(src, str(tmp_path / "t" / "parent" / "scene"))
    jseg = _jax_priors(jsrc, str(tmp_path / "jout"))
    tseg = _port_priors(tsrc, str(tmp_path / "tout"))

    from instascene_tpu.ops.rasterize import CameraMats, RasterizeConfig
    from instascene_tpu.pipelines.train_semantic import render_features
    differ = total = 0
    for v in range(len(tseg.cam_objs)):
        ct = jseg.cams[v]
        c = jseg.cam_objs[v]
        jb = render_features(jseg.params, CameraMats(ct.w2v, ct.full_proj,
                                                     ct.campos), jseg.bg,
                             RasterizeConfig(width=c.width, height=c.height,
                                             track_contrib=True)).blend
        ids, _ = tseg.tracker_view(v)
        differ += int((ids != np.asarray(jb.contrib_ids)).sum())
        total += ids.size
    assert differ <= 1e-4 * total, (differ, total)

    def load(seg):
        return np.load(os.path.join(seg.model_path, "semantic_association",
                                    "output_dict.npy"),
                       allow_pickle=True).item()

    jd, td = load(jseg), load(tseg)
    assert jd.keys() == td.keys()
    np.testing.assert_array_equal(td["mask_3d_labels"], jd["mask_3d_labels"])
    np.testing.assert_array_equal(np.asarray(td["underseg_mask_ids"]),
                                  np.asarray(jd["underseg_mask_ids"]))
    assert td["mask_2d_clusters"] == jd["mask_2d_clusters"]
    assert jd["mask_3d_labels"].shape[1] >= 2
    for sub in ("mask_sorted", "mask_filtered", "mask_undersegment"):
        jdir = os.path.join(jsrc, "sam", sub)
        tdir = os.path.join(tsrc, "sam", sub)
        assert os.path.isdir(jdir) == os.path.isdir(tdir), sub
        if not os.path.isdir(jdir):
            continue
        assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
        for name in os.listdir(jdir):
            a = np.array(Image.open(os.path.join(jdir, name)))
            b = np.array(Image.open(os.path.join(tdir, name)))
            assert a.dtype == b.dtype, (sub, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{sub}/{name}")
    np.testing.assert_array_equal(tseg.seg3d_labels, jseg.seg3d_labels)
    np.testing.assert_array_equal(tseg.params.seg_feature.numpy(),
                                  np.asarray(jseg.params.seg_feature))
    for tc, jc in zip(tseg.cam_objs, jseg.cam_objs):
        np.testing.assert_array_equal(tc.segmap, jc.segmap)
        np.testing.assert_array_equal(tc.sorted_segmap, jc.sorted_segmap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_follow_networkx(seed):
    """Components by smallest node, members in the order networkx's sets
    iterate (Node.merge concatenates mask lists in that order)."""
    import networkx as nx
    from instascene_tpu_torch.semantic.cluster import connected_components
    rng = np.random.default_rng(seed)
    for _ in range(30):
        n = int(rng.integers(1, 120))
        a = rng.random((n, n)) < rng.random() * 0.06
        a = a | a.T
        np.fill_diagonal(a, False)
        want = [list(c) for c in nx.connected_components(
            nx.from_numpy_array(a))]
        assert connected_components(a) == want


def test_set_3d_feat_matches_jax():
    """gram_feat: the anchors and every feature equal JAX's (same numpy
    draws); without it the random unit features equal too."""
    import jax.numpy as jnp
    from instascene_tpu.models.gaussians import GaussianParams
    from instascene_tpu.models.gaussians import set_3d_feat as jset
    from instascene_tpu_torch.models.gaussians import from_numpy, set_3d_feat
    rng = np.random.default_rng(3)
    n, k = 70, 4
    masks = np.zeros((n, k), bool)
    masks[np.arange(60), rng.integers(0, k, 60)] = True
    alive = np.ones(n, bool)
    alive[65:] = False
    st = dict(xyz=rng.normal(size=(n, 3)).astype(np.float32),
              features_dc=np.zeros((n, 1, 3), np.float32),
              features_rest=np.zeros((n, 15, 3), np.float32),
              scaling=np.zeros((n, 2), np.float32),
              rotation=np.ones((n, 4), np.float32),
              opacity=np.zeros((n, 1), np.float32), alive=alive)
    jp = GaussianParams(**{f: jnp.asarray(v) for f, v in st.items()})
    for gram in (False, True):
        tp, tcf = set_3d_feat(from_numpy(st, device="cpu"), masks, 16,
                              gram_feat=gram)
        jpp, jcf = jset(jp, masks, 16, gram_feat=gram)
        np.testing.assert_array_equal(tp.seg_feature.numpy(),
                                      np.asarray(jpp.seg_feature))
        if gram:
            np.testing.assert_array_equal(tcf, jcf)
        else:
            assert tcf is None and jcf is None
