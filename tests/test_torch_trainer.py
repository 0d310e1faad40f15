"""The port's GeometryTrainer, checkpoints and training CLI against the JAX
package on the 64x48 end-to-end test scene (tests/scene_builder.py): an
8-step trajectory through one densify/prune with JAX's split noise handed
in, checkpoints read across the two packages in both directions, and the
CLI on the CPU writing a PLY that the JAX package loads."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RASTER_OPTS = {"chunk": 16, "pair_cap": 65536, "tile_cap": 256}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from scene_builder import build_e2e_scene
    d = tmp_path_factory.mktemp("data") / "parent" / "scene"
    build_e2e_scene(str(d), with_segmaps=False)
    return str(d)


def _opt(pkg, **kw):
    cfg = __import__(f"{pkg}.config", fromlist=["OptimizationParams"])
    return cfg.OptimizationParams(**kw)


def _trainers(scene_dir, tmp_path, opt_kw):
    """(JAX trainer, port trainer) on the same scene and options, the
    port's split noise drawn as the JAX trainer draws it."""
    from instascene_tpu.config import ModelParams as JModel
    from instascene_tpu.config import PipelineParams as JPipe
    from instascene_tpu.data.dataset import Scene as JScene
    from instascene_tpu.pipelines.train import GeometryTrainer as JTrainer
    from instascene_tpu_torch.config import ModelParams, PipelineParams
    from instascene_tpu_torch.data.dataset import Scene
    from instascene_tpu_torch.pipelines.train import GeometryTrainer
    jd = JModel(source_path=scene_dir, sh_degree=3)
    jt = JTrainer(jd, _opt("instascene_tpu", **opt_kw), JPipe(),
                  JScene(jd, output_root=str(tmp_path / "j")),
                  rasterize_opts=dict(RASTER_OPTS))
    td = ModelParams(source_path=scene_dir, sh_degree=3)
    tt = GeometryTrainer(td, _opt("instascene_tpu_torch", **opt_kw),
                         PipelineParams(),
                         Scene(td, output_root=str(tmp_path / "t")),
                         device="cpu")
    key = [jax.random.PRNGKey(0)]

    def jax_split_noise(capacity):
        key[0], sub = jax.random.split(key[0])
        return torch.as_tensor(np.array(jax.random.normal(
            sub, (2, capacity, 3), dtype=jnp.float32)))

    tt.split_noise = jax_split_noise
    return jt, tt


def test_trajectory_matches_jax(scene_dir, tmp_path):
    """Same init (numpy rng), same camera order (random.Random), 8 steps
    with one densify/prune at step 5: per-step loss at rtol 1e-3 and the
    same n_alive after every step."""
    opt_kw = dict(iterations=8, densify_from_iter=2, densification_interval=5,
                  densify_until_iter=8, opacity_reset_interval=10_000,
                  densify_grad_threshold=2e-5, position_lr_max_steps=8)
    jt, tt = _trainers(scene_dir, tmp_path, opt_kw)
    for f in ("xyz", "features_dc", "rotation", "opacity", "alive"):
        np.testing.assert_array_equal(getattr(tt.params, f).numpy(),
                                      np.asarray(getattr(jt.params, f)), f)
    # the initial scales carry the KNN distances' cancellation
    # (test_torch_train_host.test_knn_matches)
    np.testing.assert_allclose(tt.params.scaling.numpy(),
                               np.asarray(jt.params.scaling), atol=1e-5)
    n0 = tt.params.n_alive()
    assert n0 == int(jt.params.n_alive())
    for it in range(1, 9):
        jm, tm = jt.step(it), tt.step(it)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3, err_msg=f"step {it}")
        assert tt.params.n_alive() == int(jt.params.n_alive()), it
    assert tt.params.n_alive() != n0, "densify/prune changed nothing"
    assert np.isfinite(tt.evaluate([0, 1])["psnr"])


def test_checkpoints_cross_packages(scene_dir, tmp_path):
    """A JAX checkpoint resumes in the port (and takes a step); a port
    checkpoint loads in the JAX package with every array equal."""
    from instascene_tpu.pipelines import checkpoint as jck
    from instascene_tpu_torch.pipelines import checkpoint as tck
    opt_kw = dict(iterations=20, densify_from_iter=1000,
                  position_lr_max_steps=20)
    jt, tt = _trainers(scene_dir, tmp_path, opt_kw)
    for it in range(1, 4):
        jt.step(it, cam_idx=it % 4)
        tt.step(it, cam_idx=it % 4)
    jpath = jck.save_checkpoint(jt, str(tmp_path / "jck"), 3)
    params, opt_state, stats, it0 = tck.load_checkpoint(jpath, "cpu")
    assert it0 == 3 and opt_state.count == 3
    for f in ("xyz", "features_rest", "opacity", "alive"):
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(jt.params, f)), f)
        if f != "alive":
            np.testing.assert_array_equal(opt_state.v[f].numpy(), np.asarray(
                getattr(jt.opt_state.v, f)), f)
    np.testing.assert_array_equal(stats.denom.numpy(),
                                  np.asarray(jt.stats.denom))
    tt.params, tt.opt_state, tt.stats = params, opt_state, stats
    m = tt.step(4, cam_idx=0)
    assert np.isfinite(float(m["loss"])) and tt.opt_state.count == 4

    tpath = tck.save_checkpoint(tt, str(tmp_path / "tck"), 4)
    jp, jopt, jst, jit0 = jck.load_checkpoint(tpath)
    assert jit0 == 4 and int(jopt.count) == 4
    assert jp.active_sh_degree == tt.params.active_sh_degree
    for f in ("xyz", "features_dc", "scaling", "rotation", "alive"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tt.params, f).numpy(), f)
        if f != "alive":
            np.testing.assert_array_equal(np.asarray(getattr(jopt.m, f)),
                                          tt.opt_state.m[f].numpy(), f)
    np.testing.assert_array_equal(np.asarray(jst.xyz_gradient_accum),
                                  tt.stats.xyz_gradient_accum.numpy())
    jt.params, jt.opt_state, jt.stats = jp, jopt, jst
    assert np.isfinite(float(jt.step(5, cam_idx=1)["loss"]))


def test_cli_on_cpu(scene_dir, tmp_path, monkeypatch, capsys):
    """python -m instascene_tpu_torch.train --device cpu: 20 iterations
    with a densify, a test report, a save and a checkpoint; the PLY loads
    in the JAX package with the trainer's alive count; a resume from the
    checkpoint takes one more step; --profile_trace writes its trace."""
    from instascene_tpu.models.gaussians import load_ply
    from instascene_tpu_torch import train
    monkeypatch.chdir(tmp_path)
    common = ["-s", scene_dir, "--device", "cpu", "--disable_viewer",
              "--quiet"]
    tr = train.main(common + [
        "--iterations", "20", "--densify_from_iter", "5",
        "--densification_interval", "10", "--densify_grad_threshold", "2e-5",
        "--test_iterations", "10", "20", "--save_iterations", "20",
        "--checkpoint_iterations", "20", "--position_lr_max_steps", "20"])
    out = capsys.readouterr().out
    assert "[ITER 20] Evaluating train" in out
    model = os.path.join("output", "parent", "scene", tr.scene.model_path
                         .split(os.sep)[-1])
    assert os.path.samefile(tr.scene.model_path, model)
    ply = os.path.join(model, "point_cloud", "iteration_20", "point_cloud.ply")
    back = load_ply(ply)
    assert int(back.n_alive()) == tr.params.n_alive() > 0
    assert os.path.exists(os.path.join(model, "cfg_args"))
    ck = os.path.join(model, "chkpnt20.npz")
    tr2 = train.main(common + ["--iterations", "21", "--start_checkpoint",
                               ck, "--test_iterations", "21"])
    assert tr2.opt_state.count == 21
    assert "Resumed from" in capsys.readouterr().out
    trace = tmp_path / "trace"
    train.main(common + ["--iterations", "3", "--test_iterations", "3",
                         "--profile_trace", str(trace), "--profile_window",
                         "1", "3"])
    assert (trace / "trace_1_3.json").exists()
