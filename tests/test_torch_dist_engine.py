"""The port on what the benchmark cell barn.geometry-dist adds, and the
viewer engine's count of its copies to the host, on the CPU.

barn.geometry-dist through the benchmark's tiny run: the geometry step with
depth distortion on (λ_dist 100, depth_ratio 1.0, as 2DGS trains its Tanks
and Temples scenes), so the blend runs its full mode, held against the
plain reference (benchmark/reference/train.py). The same recipe is held
against the JAX package in tests/test_torch_train_step.py.
"""

import pytest
import torch

from benchmark.loops import common
from benchmark.scene import make_scene
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: a thread pool only adds contention while the suite's
    other files run beside this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", ["barn.geometry-dist"])
def test_new_cell_tiny_run(cell):
    out = tiny.tiny_run(cell)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] >= 1
    res = tiny.tiny_res(cell)
    assert set(out["metrics"]) == {m["name"] for m in res["end_to_end"]}


@pytest.mark.parametrize("need_aux", [False, True])
def test_engine_counts_its_copies_to_the_host(need_aux):
    """One render_view adds the nbytes of every array it returns to
    d2h_bytes and times them under "copy", in a span of that name; a
    repeated pose is served from the cache and adds nothing."""
    from instascene_tpu_torch.utils.profiling import StepProfiler, recording
    from instascene_tpu_torch.viewer.gui import OrbitCamera, SegmentationEngine
    cfg = tiny.tiny_res("waldo.frame-1080p")["config"]
    eng = SegmentationEngine(common.program_model(
        make_scene(cfg, SEED, CPU), with_features=True), None)
    orbit = OrbitCamera(40, 24, r=4.0)
    cams = [orbit.minicam()]
    orbit.orbit(200.0, 0.0)
    cams.append(orbit.minicam())
    assert eng.d2h_bytes == 0
    prof = StepProfiler()
    with recording(prof):
        frame = eng.render_view(cams[0], need_aux=need_aux)
    assert len(frame) == (6 if need_aux else 3)
    one = sum(a.nbytes for a in frame.values())
    assert eng.d2h_bytes == one
    assert prof.counts["copy"] == 1 and eng.timings["copy"] >= 0
    copy_s = eng.timings["copy"]
    with recording(prof):
        assert eng.render_view(cams[0], need_aux=need_aux) is frame
    assert eng.d2h_bytes == one and prof.counts["copy"] == 1
    assert eng.timings["copy"] == copy_s
    eng.render_view(cams[1], need_aux=need_aux)
    assert eng.d2h_bytes == 2 * one
