"""The instance export and the semantic stage end to end on the CPU: the
port's HDBSCAN against sklearn's, the port's SegSplatting on the synthetic
3-instance scene against the JAX package's own e2e bars, and the port's
CLI writing a PLY that the JAX package reads."""

import os

import numpy as np
import pytest
import torch

from scene_builder import build_e2e_scene


def _blobs(seed, n=400, d=16):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 6))
    centers = rng.normal(0, 1, (k, d))
    x = centers[rng.integers(0, k, n)] + rng.normal(
        0, rng.uniform(0.05, 0.4), (n, d))
    x[:20] = rng.normal(0, 2, (20, d))       # scattered points: noise
    return x


def _same_partition(a, b):
    """Equal noise sets and equal clusters up to their numbering."""
    if not np.array_equal(a == -1, b == -1):
        return False
    pairs = set(zip(a[a >= 0].tolist(), b[b >= 0].tolist()))
    return (len(pairs) == len(set(a[a >= 0].tolist()))
            == len(set(b[b >= 0].tolist())))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mcs,ms,eps,single", [(30, 30, 0.1, True),
                                               (10, 5, 0.0, False),
                                               (20, 10, 0.5, True)],
                         ids=["export", "plain", "eps"])
def test_hdbscan_matches_sklearn(seed, mcs, ms, eps, single):
    """~400 points in 16-D: the same partition and the same noise set as
    sklearn.cluster.HDBSCAN (no distance ties in these data)."""
    from sklearn.cluster import HDBSCAN
    from instascene_tpu_torch.semantic.export import hdbscan
    x = _blobs(seed)
    want = HDBSCAN(min_cluster_size=mcs, min_samples=ms,
                   cluster_selection_epsilon=eps, allow_single_cluster=single,
                   copy=True).fit(x).labels_
    got = hdbscan(x, mcs, ms, eps, single, device="cpu")
    assert _same_partition(got, want), (np.unique(got, return_counts=True),
                                        np.unique(want, return_counts=True))


def test_hdbscan_labels_match_jax():
    """hdbscan_labels (voxel downsample, HDBSCAN, nearest-neighbour
    relabels) gives the JAX package's (sklearn's) partition of a scene of
    feature blobs, every point labelled."""
    from instascene_tpu.semantic.export import hdbscan_labels as jlabels
    from instascene_tpu_torch.semantic.export import hdbscan_labels
    rng = np.random.default_rng(5)
    feats = _blobs(5, n=600)
    pos = rng.normal(0, 1, (600, 3))
    pos[:50] = pos[50:100] + 1e-3              # some share a voxel
    want = jlabels(pos, feats)
    got = hdbscan_labels(pos, feats, device="cpu")
    assert (got >= 0).all()
    assert _same_partition(got, want)


def test_png_16bit_matches_pil(tmp_path):
    """uint16 label maps: written as PIL writes them and read back."""
    from PIL import Image
    from instascene_tpu_torch.utils.image import read_image, write_png
    a = np.random.default_rng(0).integers(0, 60000, (13, 17)).astype(
        np.uint16)
    Image.fromarray(a).save(tmp_path / "pil.png")
    np.testing.assert_array_equal(read_image(str(tmp_path / "pil.png"))[
        ..., 0], a)
    write_png(str(tmp_path / "port.png"), a)
    b = np.array(Image.open(tmp_path / "port.png"))
    assert b.dtype == np.uint16
    np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("ex") / "parent" / "scene"
    _, labels, _ = build_e2e_scene(str(d))
    return str(d), labels


def test_segsplatting_meets_e2e_bars(scene, tmp_path):
    """The port's semantic stage on the CPU, as the JAX e2e test drives
    JAX's (tests/test_train_e2e.py:108-196): priors recover >= 2 pure
    instances with 3D mIoU > 0.5, 30 contrastive iterations make
    same-instance features closer than cross-instance by > 0.1, and the
    export writes point_cloud_labels.ply."""
    import shutil
    from instascene_tpu.semantic.metrics import instance_miou
    from instascene_tpu_torch.config import (ModelParams,
                                             OptimizationParams,
                                             PipelineParams)
    from instascene_tpu_torch.pipelines.train_semantic import SegSplatting
    src, labels = scene
    src = shutil.copytree(src, str(tmp_path / "data" / "parent" / "scene"))
    seg = SegSplatting(
        ModelParams(source_path=src, use_seg_feature=True, seg_feat_dim=16),
        OptimizationParams(iterations=30, sample_batchsize=2048,
                           gram_feat_3d=True, consider_negative_labels=True),
        PipelineParams(), output_root=str(tmp_path / "out"), device="cpu")
    seg.robust_semantic_priors()
    m3d = seg.seg3d_masks
    assert m3d.shape[1] >= 2
    pure = sum(np.bincount(labels[m3d[:, k]], minlength=4).max()
               / max(m3d[:, k].sum(), 1) > 0.8 for k in range(m3d.shape[1]))
    assert pure >= 2
    pred = np.where(m3d.any(axis=1), seg.seg3d_labels + 1, 0)
    miou = instance_miou(pred, labels, ignore_label=0)
    assert miou > 0.5, miou

    seg.train_segfeat(iterations=30, progress=False, save_every=10_000)
    feats = seg.params.seg_feature_normed().numpy()[:len(labels)]
    assert np.isfinite(feats).all()
    intra, inter = [], []
    rng = np.random.default_rng(0)
    for _ in range(300):
        i, j = rng.integers(0, len(labels), 2)
        (intra if labels[i] == labels[j] else inter).append(
            float(feats[i] @ feats[j]))
    assert np.mean(intra) > np.mean(inter) + 0.1
    out_dir = os.path.join(seg.model_path, "point_cloud",
                           "iteration_30_hdbscan")
    assert os.path.exists(os.path.join(out_dir, "point_cloud_labels.ply"))
    assert os.path.exists(os.path.join(src, "sam", "mask_sorted"))


def test_cli_writes_a_ply_jax_reads(scene, tmp_path):
    """python -m instascene_tpu_torch.train_semantic on the CPU: 10
    iterations into an absolute -m, with the save at the last; JAX
    load_ply(..., load_seg_feat=True) reads the features back;
    --profile_trace writes its trace."""
    import shutil
    from instascene_tpu.models.gaussians import load_ply
    from instascene_tpu_torch import train_semantic
    src = shutil.copytree(scene[0],
                          str(tmp_path / "data" / "parent" / "scene"))
    out = str(tmp_path / "out")
    common = ["-s", src, "-m", out, "--use_seg_feature", "--device", "cpu",
              "--sample_batchsize", "1024"]
    seg = train_semantic.main(common + ["--iterations", "10"])
    assert seg.model_path == out
    ply = os.path.join(out, "point_cloud", "iteration_10", "point_cloud.ply")
    p = load_ply(ply, seg_feat_dim=16, load_seg_feat=True)
    np.testing.assert_allclose(np.asarray(p.seg_feature),
                               seg.params.seg_feature.numpy(), rtol=0,
                               atol=0)
    # the multi-view flags run since slice 4
    # (tests/test_torch_mv_step.py::test_cli_runs_with_each_flag)
    trace = tmp_path / "trace"
    train_semantic.main(common + ["--iterations", "3", "--profile_trace",
                                  str(trace), "--profile_window", "1", "3"])
    assert (trace / "trace_1_3.json").exists()
