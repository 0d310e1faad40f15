"""The port's profiler (torch.profiler) and TensorBoard logging against the
JAX package: the trace window opens and closes at the same iterations as
JAX's jax.profiler window, the CPU trace holds only the window's steps, the
step profiler's summary, the TensorBoard events of both packages' writers
read back equal, and the geometry CLI's --profile_trace on a tiny COLMAP
scene on the CPU."""

import json
import os
import time

import numpy as np
import pytest
import torch


def _window_events(make, ticks, close_twice=True):
    """Run a window over `ticks` and close it; the (event, iteration)
    sequence its start/stop hooks saw."""
    log, cur = [], {"it": None}

    def hooks(kind):       # a stand-in profiler object for the port's
        return lambda *a, **k: log.append((kind, cur["it"])) or object()

    tw = make(hooks)
    for it in ticks:
        cur["it"] = it
        tw.tick(it)
    cur["it"] = "close"
    tw.close()
    if close_twice:
        tw.close()
    return log


@pytest.mark.parametrize("window,ticks", [
    ((3, 6), range(1, 11)),          # a whole window
    ((3, 6), range(1, 5)),           # the run ends mid-window
    ((5, 8), range(5, 9)),           # a resumed run starting at `start`
    ((6, 6), range(1, 11)),          # an empty window
    ((12, 14), range(1, 11)),        # a window past the run
])
@pytest.mark.parametrize("log_dir", ["trace", None])
def test_trace_window_matches_jax(monkeypatch, tmp_path, window, ticks,
                                  log_dir):
    import jax
    from instascene_tpu.utils.profiling import TraceWindow as JaxWindow
    from instascene_tpu_torch.utils import profiling
    d = str(tmp_path / log_dir) if log_dir else None

    def make_jax(hooks):
        monkeypatch.setattr(jax.profiler, "start_trace", hooks("start"))
        monkeypatch.setattr(jax.profiler, "stop_trace", hooks("stop"))
        return JaxWindow(d, *window)

    def make_port(hooks):
        monkeypatch.setattr(profiling, "_start", hooks("start"))
        monkeypatch.setattr(profiling, "_stop", hooks("stop"))
        return profiling.TraceWindow(d, *window)

    want = _window_events(make_jax, ticks)
    assert _window_events(make_port, ticks) == want
    if log_dir and window == (3, 6) and ticks == range(1, 11):
        assert want == [("start", 3), ("stop", 6)]


def _trace_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events]


def test_trace_window_cpu_trace_holds_the_window(tmp_path):
    """A real CPU trace of iterations 2..4 of 1..7: its file holds those
    steps' ranges and no other's."""
    from instascene_tpu_torch.utils.profiling import TraceWindow, trace
    tw = TraceWindow(str(tmp_path), 2, 5)
    x = torch.randn(64, 64)
    for it in range(1, 8):
        tw.tick(it)
        with torch.profiler.record_function(f"step_{it}"):
            x = torch.tanh(x @ x)
    tw.close()
    assert tw.path == str(tmp_path / "trace_2_5.json")
    steps = {n for n in _trace_names(tw.path) if n.startswith("step_")}
    assert steps == {"step_2", "step_3", "step_4"}
    with trace(str(tmp_path / "block")) as d:
        with torch.profiler.record_function("inside"):
            torch.relu(x)
    assert "inside" in _trace_names(os.path.join(d, "trace.json"))


def test_step_profiler_and_memory_stats(monkeypatch):
    """StepProfiler's summary equals JAX's over the same clock readings
    (the port's clock reads ns)."""
    from instascene_tpu.utils.profiling import StepProfiler as JaxProfiler
    from instascene_tpu_torch.utils.profiling import StepProfiler
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 4.0, 4.0, 4.001]
    clock = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    clock_ns = iter(round(t * 1e9) for t in ticks)
    out = {}
    for name, prof in (("jax", JaxProfiler()),
                       ("port", StepProfiler(clock=lambda: next(clock_ns)))):
        for section in ("render", "loss", "render", "adam"):
            with prof.section(section):
                pass
        out[name] = prof.summary()
    assert out["port"] == out["jax"]
    assert list(out["port"]) == ["render", "loss", "adam"]


def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0,
                                                   "images": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)]
               for t in tags["scalars"]}
    images = {t: [(e.step, e.width, e.height, e.encoded_image_string)
                  for e in acc.Images(t)] for t in tags["images"]}
    return scalars, images


def test_tensorboard_events_match(tmp_path):
    """The same scalars and evaluation maps through both packages' tb
    helpers: the same tags, values and encoded images."""
    import instascene_tpu.utils.tb as J
    import instascene_tpu_torch.utils.tb as P
    rng = np.random.default_rng(11)
    h, w = 20, 28
    maps = {"image": rng.random((h, w, 3)) * 1.2 - 0.1,
            "surf_depth": rng.random((h, w, 1)) * 4,
            "rend_normal": rng.random((h, w, 3)) * 2 - 1,
            "surf_normal": rng.random((h, w, 3)) * 2 - 1,
            "rend_alpha": rng.random((h, w, 1)),
            "rend_dist": rng.random((h, w)) * 0.01,
            "gt": rng.random((h, w, 3))}
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    metrics = {"ll1": 0.25, "loss": 0.5, "dist": 0.125, "normal": 0.0625}
    dirs = {}
    for name, mod, conv in (
            ("jax", J, lambda a: a),
            ("port", P, lambda a: torch.as_tensor(a))):
        d = str(tmp_path / name)
        writer = mod.maybe_summary_writer(d)
        assert writer is not None
        for it in (10, 20):
            mod.log_train_scalars(writer, it, {k: conv(np.float32(v)) for k, v
                                               in metrics.items()}, 0.015)
        mod.log_eval_scalars(writer, 20, "test", 0.0321, 24.5, 1234)
        tmaps = {k: conv(v) for k, v in maps.items()}
        mod.log_eval_images(writer, 20, "test", "r_0", tmaps, with_gt=True)
        mod.log_eval_images(writer, 30, "train", "r_1", tmaps)
        writer.close()
        dirs[name] = _events(d)
    scalars, images = dirs["port"]
    assert len(scalars) == 8 and len(images) == 13
    assert dirs["port"] == dirs["jax"]
    assert np.array_equal(P._colormap(maps["rend_dist"]),
                          J._colormap(maps["rend_dist"]))


def _colmap_scene(root, rng, n_cams=4, width=32, height=24, n_points=150):
    """A tiny COLMAP scene written with the port's writers: orbit cameras,
    random images, random points."""
    from instascene_tpu_torch.cameras import fov2focal
    from instascene_tpu_torch.data import colmap
    from instascene_tpu_torch.data.synthetic import look_at
    from instascene_tpu_torch.utils.image import write_png
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    images = {}
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        R, t = look_at(np.array([3 * np.cos(ang), 3 * np.sin(ang), 1.0]),
                       np.zeros(3))
        name = f"{i:03d}.png"
        write_png(os.path.join(root, "images", name),
                  rng.integers(0, 256, (height, width, 3)).astype(np.uint8))
        images[i + 1] = colmap.ColmapImage(
            id=i + 1, qvec=colmap.rotmat2qvec(R), tvec=t, camera_id=1,
            name=name, xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64))
    f = fov2focal(0.9, width)
    colmap.write_cameras_binary({1: colmap.ColmapCamera(
        id=1, model="PINHOLE", width=width, height=height,
        params=np.array([f, f, width / 2, height / 2]))},
        os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    colmap.write_points3D_binary(
        rng.normal(0, 0.5, (n_points, 3)),
        rng.integers(0, 256, (n_points, 3)).astype(np.uint8),
        os.path.join(sparse, "points3D.bin"))


def test_train_cli_profile_trace_and_tensorboard(tmp_path):
    """--profile_trace through the geometry CLI on the CPU no longer
    raises: the trace of iterations 2..3 is written, and the report at
    iteration 4 reaches TensorBoard with its images."""
    from instascene_tpu_torch import train
    root = str(tmp_path / "data" / "tiny" / "scene")
    _colmap_scene(root, np.random.default_rng(2))
    trace_dir, out = str(tmp_path / "trace"), str(tmp_path / "out")
    tr = train.main(["-s", root, "-m", out, "--device", "cpu",
                     "--iterations", "4", "--test_iterations", "4",
                     "--profile_trace", trace_dir, "--profile_window", "2",
                     "4", "--disable_viewer", "--quiet"])
    path = os.path.join(trace_dir, "trace_2_4.json")
    assert os.path.exists(path) and len(_trace_names(path)) > 0
    assert np.isfinite(tr.reports[4]["train"]["psnr"])
    scalars, images = _events(out)
    assert [s for s, _ in scalars["train/loss_viewpoint - psnr"]] == [4]
    assert any(t.startswith("train_view_") and t.endswith("/render")
               for t in images)
