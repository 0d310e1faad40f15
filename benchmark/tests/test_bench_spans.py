"""The join of the program's spans with the traced device timeline
(benchmark/spans.py): idle time and launches put down to the innermost
span on synthetic intervals, the layer readings, a tiny traced run on the
CPU (no device trace: no readings), and on the card every blend kernel's
launch inside a `raster` span."""

import argparse
import time

import pytest
import torch

from benchmark import spans as S
from benchmark.tests import tiny
from instascene_tpu_torch.utils.profiling import Span


def _span(name, start, end, parent, thread=1, ordinal=0):
    return Span(name, start, end, parent, thread, ordinal)


# two steps; the second step's raster runs on thread 2 (autograd's device
# thread) while thread 1 waits in backward, then adam
SPANS = [
    _span("step", 0, 100, None),
    _span("render", 5, 40, 0),
    _span("preprocess", 10, 20, 1),
    _span("raster", 25, 35, 1),
    _span("backward", 50, 80, 0),
    _span("raster", 55, 70, 4, thread=2),
    _span("adam", 85, 95, 0),
    _span("step", 200, 260, None, ordinal=1),
    _span("loss", 210, 230, 7, ordinal=1),
    None,                                   # a span left open: skipped
]
# device busy 0-8, 12-30, 33-52, 60-90, 150-205, 300-310: gaps 8-12,
# 30-33, 52-60, 90-150, 205-300
DEVICE = [("k", 0, 8, True), ("k", 12, 30, True), ("k", 28, 30, True),
          ("m", 33, 52, False), ("k", 60, 90, True), ("k", 150, 205, True),
          ("k", 300, 310, True)]
HOST = [(6, 7, "cudaLaunchKernel"), (11, 12, "cudaLaunchKernel"),
        (26, 27, "cudaLaunchKernelExC"), (56, 57, "cudaLaunchKernel"),
        (60, 61, "cudaMemcpyAsync"), (86, 87, "cudaLaunchKernel"),
        (150, 151, "cudaLaunchKernel"), (215, 216, "cudaLaunchKernel")]


def test_join_on_synthetic_intervals():
    j = S.join(SPANS, DEVICE, HOST)
    # 8-10 render, 10-12 preprocess; 30-33 raster; 52-55 backward, 55-60
    # the device thread's raster; 90-95 adam, 95-100 step, 100-150 none;
    # 205-210 step, 210-230 loss, 230-260 step, 260-300 none
    assert j["idle_ns_by_span"] == {"render": 2, "preprocess": 2,
                                    "raster": 3 + 5, "backward": 3,
                                    "adam": 5, "step": 5 + 5 + 30,
                                    "loss": 20}
    assert j["idle_ns"] == 4 + 3 + 8 + 60 + 95
    assert j["idle_in_spans_ns"] == sum(j["idle_ns_by_span"].values()) == 80
    assert j["launches"] == 7
    assert j["launches_by_span"] == {"render": 1, "preprocess": 1,
                                     "raster": 2, "adam": 1, "loss": 1}
    r = S.readings(j, "geometry", 2)
    assert r["geometry_idle_ms.raster"] == pytest.approx((8 + 2) / 1e6 / 2)
    assert r["geometry_idle_ms.loss"] == pytest.approx(20 / 1e6 / 2)
    assert r["geometry_idle_ms.binning"] == 0
    assert r["geometry_launches.raster"] == (2 + 1) / 2
    assert r["idle_in_spans_pct.geometry"] == pytest.approx(100 * 80 / 170)
    layers = sum(r[f"geometry_idle_ms.{x}"] for x in S.LAYERS["geometry"])
    assert layers <= r["idle_ms_per_step"]
    assert sum(r[f"geometry_launches.{x}"]
               for x in S.LAYERS["geometry"]) <= r["launches_per_step"]
    assert set(S.readings(j, "semantic", 2)) == {
        f"semantic_{m}.{x}" for m in ("idle_ms", "launches")
        for x in S.LAYERS["semantic"]} | {"idle_in_spans_pct.semantic",
                                          "idle_ms_per_step",
                                          "launches_per_step"}


def test_no_device_trace_no_readings():
    j = S.join(SPANS, [], HOST)
    assert j["idle_ns"] == 0 and S.readings(j, "frame", 3) == {}


def test_tiny_traced_run_on_the_cpu():
    """The tiny frame cell through spans.measure on the CPU: run.py's
    traced line, the spans recorded and released, no readings (the CPU
    has no device trace)."""
    from instascene_tpu_torch.utils import profiling
    args = argparse.Namespace(workload="waldo.frame-1080p", seed=tiny.SEED,
                              seconds=1.0, trace=1)
    out = S.measure(args, tiny.tiny_res("waldo.frame-1080p"),
                    torch.device("cpu"),
                    t_start=time.perf_counter())
    assert profiling._ACTIVE is None
    assert out["correct"] is True and "breakdown" in out
    assert out["spans"] == {}
    assert out["spans_by_name"] == {}


@pytest.mark.cuda
def test_blend_launches_inside_raster_spans(cuda_device):
    """A tiny geometry cell on the card under torch.profiler with the
    spans recorded: the runtime call of every K1, K2 and segment-sum
    launch (matched by correlation id) lies inside a `raster` span."""
    from torch.profiler import ProfilerActivity, profile
    from benchmark import run
    from benchmark.trace import own_kernel
    from instascene_tpu_torch.utils.profiling import StepProfiler, recording
    res = tiny.tiny_res("waldo.geometry")
    cell = run.loop(res["mix"]["loop"]).setup(res["config"], res["mix"],
                                              tiny.SEED, cuda_device)
    prof = StepProfiler()
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        with recording(prof):
            window = cell.run_window(0.5, traced=False)
        torch.cuda.synchronize()
    events = list(tp.profiler.kineto_results.events())
    own = {e.correlation_id(): own_kernel(e.name()) for e in events
           if not str(e.device_type()).endswith("CPU")
           and own_kernel(e.name()) in ("K1", "K2", "segment_sum")}
    calls = [e for e in events if str(e.device_type()).endswith("CPU")
             and e.correlation_id() in own]
    raster = [s for s in prof.closed() if s.name == "raster"]
    kinds = {own[e.correlation_id()] for e in calls}
    assert kinds == {"K1", "K2", "segment_sum"}, kinds
    assert len(calls) == len(own) >= 3 * window["n"]
    for e in calls:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        assert any(s.start_ns <= a and b <= s.end_ns for s in raster), (
            own[e.correlation_id()], e.name())
