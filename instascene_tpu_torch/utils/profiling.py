"""Profiling: torch.profiler traces of a training window, and the port's
own spans of its layers.

Port of instascene_tpu/utils/profiling.py (`trace`, `TraceWindow`,
`StepProfiler`) on torch.profiler in place of jax.profiler. A trace
records the host's operators and, where CUDA is available, the card's
kernels and copies with their device times (CUPTI), the port's
ctypes-launched kernels included; no stacks and no shapes, to keep its
cost small. It is written as a Chrome trace JSON into the trace's
directory: open it in Perfetto (ui.perfetto.dev) or chrome://tracing.

Spans: the port marks each layer boundary of its hot paths with
`with span(name):` (the step and its stages, the render, the model's
activations, preprocess, binning, raster). With no StepProfiler active,
span() hands back one shared object that does nothing: no allocation, no
clock, no device. Inside `with recording(profiler):` each span is kept in
that profiler's memory, stamped on torch.profiler's host clock (Unix-epoch
ns: CLOCK_REALTIME, which time.time_ns reads), so a profiler trace's
device idle gaps and CUDA runtime calls can be put inside the span the
host was in. A TraceWindow records them for its window and writes them
into its Chrome trace on a track of their own.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

# the Chrome trace's thread id of the spans' track
SPAN_TRACK = 0x5350414E


# seconds of tiny kernels a trace's warm-up step runs on the card
WARMUP_S = 0.05


def _start():
    """A torch.profiler recording from here on, past a warm-up step (its
    events dropped) of tiny kernels for WARMUP_S: CUPTI can record no device
    activity for ms after it starts (on an H100 late in a long process:
    3.5 ms; one warm-up launch did not help, 20 ms of them did)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   schedule=schedule(wait=0, warmup=1, active=1))
    prof.start()
    if torch.cuda.is_initialized():
        x = torch.zeros(1, device="cuda")
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARMUP_S:
            x.add_(1)
            torch.cuda.synchronize()
    prof.step()
    return prof


def _stop(prof, path: str, profiler: Optional["StepProfiler"] = None
          ) -> None:
    """Stop once the card's queue has drained (so the window's kernels are
    in the trace) and write the Chrome trace to `path`, with `profiler`'s
    spans when given."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)
    if profiler is not None:
        _write_spans(path, profiler)


def _write_spans(path: str, profiler: "StepProfiler") -> None:
    """Add the profiler's closed spans to the Chrome trace at `path` as
    complete events on the track SPAN_TRACK of this process, on the
    trace's own time base."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid,
               "tid": SPAN_TRACK,
               "args": {"name": "instascene_tpu_torch spans"}}]
    for s in profiler.closed():
        events.append({"ph": "X", "cat": "span", "name": s.name,
                       "pid": pid, "tid": SPAN_TRACK,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"ordinal": s.ordinal,
                                "thread": s.thread}})
    doc["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str = "instascene_trace"):
    """Trace the block into <log_dir>/trace.json; yields log_dir."""
    os.makedirs(log_dir, exist_ok=True)
    prof = _start()
    try:
        yield log_dir
    finally:
        _stop(prof, os.path.join(log_dir, "trace.json"))


class TraceWindow:
    """Iteration-windowed trace for training loops: call `tick(it)` at the
    top of each iteration and `close()` after the loop. The trace starts at
    tick(start) and stops at tick(end), so it holds iterations start..end-1,
    in <log_dir>/trace_<start>_<end>.json (`path`), with the port's spans
    of those iterations (a StepProfiler made active for the window). close()
    is idempotent and also stops a trace left open by a run that ended
    mid-window."""

    def __init__(self, log_dir: str, start: int, end: int):
        self.log_dir = log_dir
        self.start = int(start)
        self.end = int(end)
        self.path = (os.path.join(log_dir, f"trace_{self.start}_{self.end}"
                                  ".json") if log_dir else None)
        self._prof = None
        self._recording = None

    def tick(self, it: int) -> None:
        if self.log_dir is None or self.end <= self.start:
            return
        if it == self.start and self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._recording = recording(StepProfiler())
            self._recording.__enter__()
            self._prof = _start()
        elif it == self.end and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            try:
                _stop(self._prof, self.path, self._recording.profiler)
            finally:
                self._prof = None
                self._recording.__exit__(None, None, None)
                self._recording = None
            print(f"\nprofiler trace -> {self.path}", flush=True)


class Span(NamedTuple):
    """One closed span: its name, its start and end on the profiler's
    clock, the index of its parent span (None for an outermost one), the
    thread it ran on, and the ordinal of its outermost span (the step or
    frame it belongs to)."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    ordinal: int


class StepProfiler:
    """The spans of named sections, and each name's wall-clock total and
    count. It measures host time: a section's span is the time the host
    spent in it, device work enqueued but not waited for, never the
    device's own time.

    `spans[i]` is the i-th span opened, a Span once it has closed (None
    while it is open). A span's parent is the innermost span open on its
    thread when it opened; a thread with none open takes the innermost
    span open on the profiler's home thread (the thread that made it, or
    made it active by recording()), so the backward that autograd's device
    thread runs nests in the step that waits for it. `clock` returns ns,
    time.time_ns by default (torch.profiler's host clock)."""

    def __init__(self, clock=None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.spans: List[Optional[Span]] = []
        self._clock = clock or time.time_ns
        self._lock = threading.Lock()
        self._open: Dict[int, "_Section"] = {}   # thread → innermost span
        self._home = threading.get_ident()
        self._outermost = 0

    def section(self, name: str) -> "_Section":
        return _Section(self, name)

    def closed(self) -> List[Span]:
        return [s for s in self.spans if s is not None]

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 3),
                    "mean_ms": round(v / max(self.counts[k], 1) * 1000, 2),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1])}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


class _Section:
    __slots__ = ("prof", "name", "index", "parent", "ordinal", "thread",
                 "outer", "start")

    def __init__(self, prof: StepProfiler, name: str):
        self.prof, self.name = prof, name

    def __enter__(self):
        p = self.prof
        self.thread = tid = threading.get_ident()
        with p._lock:
            self.outer = up = p._open.get(tid)
            if up is None and tid != p._home:
                up = p._open.get(p._home)
            if up is None:
                self.parent, self.ordinal = None, p._outermost
                p._outermost += 1
            else:
                self.parent, self.ordinal = up.index, up.ordinal
            self.index = len(p.spans)
            p.spans.append(None)
            p._open[tid] = self
        self.start = p._clock()
        return self

    def __exit__(self, et, ev, tb):
        p = self.prof
        end = p._clock()
        with p._lock:
            p.spans[self.index] = Span(self.name, self.start, end,
                                       self.parent, self.thread,
                                       self.ordinal)
            p._open[self.thread] = self.outer
            p.totals[self.name] = (p.totals.get(self.name, 0.0)
                                   + (end - self.start) / 1e9)
            p.counts[self.name] = p.counts.get(self.name, 0) + 1
        return False


class _NoSpan:
    """What span() gives with no profiler active: enters and exits doing
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


_NO_SPAN = _NoSpan()
_ACTIVE: Optional[StepProfiler] = None


def span(name: str):
    """`with span(name):` records a span into the active StepProfiler, and
    is the shared do-nothing _NoSpan when none is active."""
    prof = _ACTIVE
    if prof is None:
        return _NO_SPAN
    return _Section(prof, name)


class recording:
    """`with recording(profiler):` makes `profiler` the process's active
    one, whose home thread is the caller's, and on exit (or a raise)
    restores the one active before."""

    def __init__(self, profiler: StepProfiler):
        self.profiler = profiler
        self._before = None

    def __enter__(self) -> StepProfiler:
        global _ACTIVE
        self._before = _ACTIVE
        self.profiler._home = threading.get_ident()
        _ACTIVE = self.profiler
        return self.profiler

    def __exit__(self, et, ev, tb):
        global _ACTIVE
        _ACTIVE = self._before
        return False


class stage:
    """`with stage(name, mark):` is a step's stage: a span named `name`
    whose end calls mark(name), so the stage boundary a step's on_stage
    hook sees and the span's end are one place. mark is not called when
    the stage raises."""
    __slots__ = ("name", "mark", "_span")

    def __init__(self, name: str, mark):
        self.name, self.mark = name, mark
        prof = _ACTIVE
        self._span = None if prof is None else _Section(prof, name)

    def __enter__(self):
        if self._span is not None:
            self._span.__enter__()

    def __exit__(self, et, ev, tb):
        if self._span is not None:
            self._span.__exit__(et, ev, tb)
        if et is None:
            self.mark(self.name)
        return False
