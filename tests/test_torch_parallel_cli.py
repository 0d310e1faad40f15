"""The training CLIs' --dp on the CPU (gloo), on the 64x48 end-to-end test
scene (tests/scene_builder.py): --dp 2 trains on two spawned ranks whose
replicas stay bit for bit equal and writes what the plain CLI writes, and
--dp 1 is the plain CLI bit for bit."""

import os
import shutil

import numpy as np
import pytest


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from scene_builder import build_e2e_scene
    d = tmp_path_factory.mktemp("dpcli") / "parent" / "scene"
    build_e2e_scene(str(d))
    return str(d)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


GEOMETRY = ["--device", "cpu", "--disable_viewer", "--quiet",
            "--iterations", "12", "--densify_from_iter", "5",
            "--densification_interval", "5", "--densify_grad_threshold",
            "2e-5", "--test_iterations", "12", "--position_lr_max_steps",
            "12"]


def test_geometry_cli_dp(scene, tmp_path):
    """--dp 2: a densification at iteration 10, a report and a save at 12
    by rank 0; the PLY loads in the JAX package with rank 0's gaussians,
    and both ranks end with the same state digest. --dp 1 (one rank over
    gloo) writes the plain CLI's PLY byte for byte."""
    from instascene_tpu.models.gaussians import load_ply
    from instascene_tpu_torch import train
    ply = os.path.join("point_cloud", "iteration_12", "point_cloud.ply")
    out2 = str(tmp_path / "dp2")
    s = train.main(["-s", scene, "-m", out2, "--dp", "2"] + GEOMETRY)
    assert s["model_path"] == out2
    (a, b) = s["ranks"]
    assert a["digest"] == b["digest"] and (a["rank"], b["rank"]) == (0, 1)
    assert s["adam_count"] == 12 and s["reports"][12]["train"]["psnr"] > 0
    assert int(load_ply(os.path.join(out2, ply)).n_alive()) == s["n_alive"]

    out1, plain = str(tmp_path / "dp1"), str(tmp_path / "plain")
    s1 = train.main(["-s", scene, "-m", out1, "--dp", "1"] + GEOMETRY)
    tr = train.main(["-s", scene, "-m", plain] + GEOMETRY)
    assert s1["n_alive"] == tr.params.n_alive()
    with open(os.path.join(out1, ply), "rb") as f1, \
            open(os.path.join(plain, ply), "rb") as f2:
        assert f1.read() == f2.read()
    # the same outputs, but for TensorBoard's events file (its name holds
    # the host and the time)
    ev = lambda fs: [f for f in fs if "tfevents" not in f]
    assert ev(_files(out2)) == ev(_files(plain))


def test_semantic_cli_dp(scene, tmp_path):
    """--dp 2, 10 iterations: rank 0 computes the priors once and rank 1
    loads them, the ranks end with the same features, and the outputs are
    the plain CLI's files."""
    from instascene_tpu_torch import train_semantic
    common = ["--use_seg_feature", "--device", "cpu", "--iterations", "10",
              "--sample_batchsize", "1024"]
    runs = {}
    for tag, dp in (("plain", []), ("dp2", ["--dp", "2"])):
        src = shutil.copytree(scene, str(tmp_path / tag / "parent" /
                                         "scene"))
        out = str(tmp_path / f"out_{tag}")
        runs[tag] = (src, out, train_semantic.main(
            ["-s", src, "-m", out] + common + dp))
    src, out, s = runs["dp2"]
    assert s["model_path"] == out
    assert [r["priors"] for r in s["ranks"]] == ["computed", "loaded"]
    assert s["ranks"][0]["digest"] == s["ranks"][1]["digest"]
    assert s["instances"] >= 2 and np.isfinite(s["last_loss"])
    assert _files(out) == _files(runs["plain"][1])
    assert _files(src) == _files(runs["plain"][0])
