"""The port's span recorder (utils/profiling.py): the shared do-nothing
span while no profiler is active, the active profiler's scope, nesting
and self time on a fake clock, spans of another thread, the clock against
torch.profiler's own, the span tree of a geometry step, a semantic step
with its 5-view window and a viewer frame on tiny scenes, and the spans
in a TraceWindow's Chrome trace."""

import dataclasses
import json
import sys
import threading
import time

import pytest
import torch

from instascene_tpu_torch.utils import profiling
from instascene_tpu_torch.utils.profiling import (SPAN_TRACK, StepProfiler,
                                                  TraceWindow, recording,
                                                  span)

SCALE = 16          # bench.py's sizes / 16: 61x45 training views
N = 300


def _fake_clock(step=10):
    t = iter(range(0, 10 ** 9, step))
    return lambda: next(t)


def test_span_off_is_the_shared_noop(monkeypatch):
    """No profiler active: span() hands back one shared object, reads no
    clock, allocates nothing, and records into no profiler."""
    assert profiling._ACTIVE is None
    prof = StepProfiler()

    def no_clock():
        raise AssertionError("a clock was read")
    monkeypatch.setattr(time, "time_ns", no_clock)
    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    a, b = span("step"), span("raster")
    assert a is b is profiling._NO_SPAN
    for _ in range(10):          # warm every code path once
        with span("step"):
            pass
    before = sys.getallocatedblocks()
    for _ in range(20000):
        with span("step"):
            with span("raster"):
                pass
    assert sys.getallocatedblocks() - before < 50
    assert prof.spans == [] and prof.totals == {}


@pytest.mark.parametrize("raises", [False, True], ids=["exits", "raises"])
def test_recording_restores_the_profiler_before(raises):
    outer, inner = StepProfiler(), StepProfiler()
    with recording(outer):
        try:
            with recording(inner) as active:
                assert active is inner and profiling._ACTIVE is inner
                with span("a"):
                    if raises:
                        raise KeyError("inside")
        except KeyError:
            assert raises
        assert profiling._ACTIVE is outer
        with span("b"):
            pass
    assert profiling._ACTIVE is None
    assert span("c") is profiling._NO_SPAN
    assert [s.name for s in inner.closed()] == ["a"]
    assert [s.name for s in outer.closed()] == ["b"]


def test_nesting_and_self_time_on_a_fake_clock():
    """step(render(model, raster), adam), then a second step: parents,
    ordinals, stamps, each name's totals, and self times (a span's
    duration less its children's) from the records."""
    prof = StepProfiler(clock=_fake_clock())
    with recording(prof):
        for _ in range(2):
            with span("step"):
                with span("render"):
                    with span("model"):
                        pass
                    with span("raster"):
                        pass
                with span("adam"):
                    pass
    s = prof.closed()
    assert len(s) == len(prof.spans) == 10
    names = [x.name for x in s]
    assert names == ["step", "render", "model", "raster", "adam"] * 2
    parents = [x.parent for x in s]
    assert parents == [None, 0, 1, 1, 0, None, 5, 6, 6, 5]
    assert [x.ordinal for x in s] == [0] * 5 + [1] * 5
    # clock reads 0, 10, ...: step 0-90, render 10-60, model 20-30,
    # raster 40-50, adam 70-80
    assert [(x.start_ns, x.end_ns) for x in s[:5]] == [
        (0, 90), (10, 60), (20, 30), (40, 50), (70, 80)]
    own = [x.end_ns - x.start_ns for x in s]
    for x in s:
        if x.parent is not None:
            own[x.parent] -= x.end_ns - x.start_ns
    assert own[:5] == [30, 30, 10, 10, 10]
    assert prof.counts == {"step": 2, "render": 2, "model": 2, "raster": 2,
                           "adam": 2}
    assert prof.totals["step"] == pytest.approx(2 * 90e-9)


def test_a_threads_first_span_nests_in_the_recording_thread():
    """A span opened on a thread with none of its own takes the recording
    thread's innermost open span as parent (autograd's device thread
    running the blend's backward while the step waits in backward)."""
    prof = StepProfiler()
    with recording(prof):
        with span("step"):
            with span("backward"):
                def device_thread():
                    with span("raster"):
                        with span("inner"):
                            pass
                    with span("second"):
                        pass
                t = threading.Thread(target=device_thread)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        with span("later"):
            pass
    by = {s.name: s for s in prof.closed()}
    assert by["raster"].parent == by["second"].parent == 1
    assert by["inner"].parent == 2
    assert by["raster"].thread == by["inner"].thread != by["step"].thread
    assert {by[k].ordinal for k in ("step", "backward", "raster", "inner",
                                    "second")} == {0}
    assert by["later"].parent is None and by["later"].ordinal == 1


def test_spans_from_many_threads_lose_nothing():
    """More threads than cores open and close spans at once, at a short
    switch interval: every span is recorded once, closed, with its own
    index, and the counts add up."""
    prof = StepProfiler()
    threads, per = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording(prof):
            def work():
                for _ in range(per):
                    with span("outer"):
                        with span("inner"):
                            pass
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    s = prof.spans
    assert len(s) == 2 * threads * per and None not in s
    assert prof.counts == {"outer": threads * per, "inner": threads * per}
    for x in s:
        if x.name == "inner":
            up = s[x.parent]
            assert up.name == "outer" and up.thread == x.thread
            assert up.start_ns <= x.start_ns <= x.end_ns <= up.end_ns
    assert len({x.ordinal for x in s}) == threads * per


def test_span_stamps_are_on_the_profilers_clock():
    """Under a CPU torch.profiler profile, a span around torch.mm encloses
    the trace's aten::mm event: both clocks are the profiler's own."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256)
    prof = StepProfiler()
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        with recording(prof):
            with span("mm"):
                torch.mm(x, x)
    (s,) = prof.closed()
    mm = [e for e in tp.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    e = mm[0]
    assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() \
        <= s.end_ns


def _tree(prof):
    """The closed spans as nested (name, children) tuples, outermost
    first."""
    s = prof.closed()
    kids = {i: [] for i in range(len(s))}
    roots = []
    for i, x in enumerate(s):
        (roots if x.parent is None else kids[x.parent]).append(i)

    def node(i):
        return (s[i].name, tuple(node(k) for k in kids[i]))
    return tuple(node(i) for i in roots)


def _geometry():
    from instascene_tpu_torch import bench
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.pipelines.train import train_step
    st, mk = make_bench_scene(n=N, seed=0)
    p, opt, stats, cams, lrs, kw = bench.geometry_inputs(
        st, mk, torch.device("cpu"), SCALE, dist=False)
    return lambda mark: train_step(p, opt, stats, cams[0],
                                   torch.zeros(3), lrs, on_stage=mark,
                                   **kw)


def _semantic():
    from instascene_tpu_torch import bench
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.optimizer import init_adam_state
    from instascene_tpu_torch.pipelines.train_semantic import (
        semantic_train_step)
    st, mk = make_bench_scene(n=N, seed=0)
    dev = torch.device("cpu")
    p, cams, hyp, scfg, _ = bench.semantic_inputs(st, mk, dev, SCALE)
    scfg = dataclasses.replace(scfg, batch=256)
    mv = bench.semantic_windows(cams, SCALE, dev)["semantic_mv"]
    gen = torch.Generator().manual_seed(3)
    return lambda mark: semantic_train_step(
        p, init_adam_state(p), cams[0], mv, hyp, scfg, generator=gen,
        on_stage=mark)


def _frame():
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.render import render
    st, mk = make_bench_scene(n=N, seed=0)
    p = from_numpy(st, "cpu")
    cam = mk(0, 1920 // SCALE, 1080 // SCALE)
    return lambda mark: render(cam, p, None, torch.zeros(3), viewer=True)


_VIEW = (("model", ()), ("preprocess", ()), ("raster", ()))
PATHS = {
    "geometry": (_geometry, ["render", "loss", "backward", "adam"], (
        ("step", (
            ("render", (("model", ()), ("preprocess", ()), ("binning", ()),
                        ("raster", ()))),
            ("loss", ()),
            ("backward", (("raster", ()),)),
            ("adam", ()))),)),
    # binning cached; the window's five renders under the loss, the six
    # blends' backward under backward
    "semantic": (_semantic, ["draws", "render", "loss", "backward", "adam"], (
        ("step", (
            ("draws", ()),
            ("render", _VIEW),
            ("loss", _VIEW * 5),
            ("backward", (("raster", ()),) * 6),
            ("adam", ()))),)),
    "frame": (_frame, [], (
        ("render", (("model", ()), ("preprocess", ()), ("binning", ()),
                    ("raster", ()))),)),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_span_tree_of_each_hot_path(path):
    """One geometry train_step, one semantic_train_step with the 5-view
    window and one render(viewer=True) on tiny scenes on the CPU: the span
    tree of each, and the steps' on_stage marks as before."""
    make, marks, want = PATHS[path]
    run = make()
    got_marks = []
    prof = StepProfiler()
    with recording(prof):
        run(got_marks.append)
    assert got_marks == marks
    assert _tree(prof) == want
    assert None not in prof.spans


def test_trace_window_writes_the_spans(tmp_path):
    """A two-step window of geometry steps on the CPU: the Chrome trace
    holds the spans of those steps on their own track, on the trace's time
    base (each inside the window's host events)."""
    step = _geometry()
    tw = TraceWindow(str(tmp_path), 1, 3)
    for it in range(4):
        tw.tick(it)
        step(lambda name: None)
    tw.close()
    assert profiling._ACTIVE is None
    with open(tw.path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("tid") == SPAN_TRACK
             and e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    assert {"step", "render", "preprocess", "binning", "raster",
            "adam"} <= names
    assert sum(e["name"] == "step" for e in spans) == 2
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    lo = min(e["ts"] for e in ops)
    hi = max(e["ts"] + e["dur"] for e in ops)
    first = min(e["ts"] for e in spans)
    last = max(e["ts"] + e["dur"] for e in spans)
    assert lo - 1e4 <= first <= last <= hi + 1e4     # within 10 ms
