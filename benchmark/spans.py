"""The program's spans joined with a traced run's device timeline: each
step's or frame's device idle time and kernel launches, put down to the
port's layers.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as `python3 -m benchmark.run ... --trace 1` does, with the
program's span recorder (instascene_tpu_torch/utils/profiling.py) made
active just before the trace starts and released just after it stops,
and prints that run's result line with one key more, `spans`: the layer
readings below. The spans are stamped on torch.profiler's host clock, so
nothing is fitted between the two.

join(): each nanosecond of each device idle gap (between the union of the
device's operations, as benchmark/trace.py finds them) goes to the
innermost span open at that instant on any thread, the deepest in the
span tree (a span on autograd's device thread nests in the step's
`backward`), the latest started among equals; each CUDA kernel launch the
host made goes to the innermost span open at its start. So a span's idle
time is its own, outside its children, and nothing is counted twice.

readings(), per step or frame (the window's count), for the layers of
the cell's kind: `<kind>_idle_ms.<layer>` and `<kind>_launches.<layer>`
(model, preprocess and binning: their spans; raster: `raster` and the
`render` spans' own time; loss: `loss` and `draws`; backward and adam:
their stage spans), and `idle_in_spans_pct.<kind>`, the share of the idle
time inside any span. Nothing where the run has no device trace (the
CPU).
"""

from __future__ import annotations

import bisect
import heapq
import json
import sys
from collections import defaultdict

from benchmark import run, trace

LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"))
# each layer's spans, whose own idle time and launches it takes
LAYER_SPANS = {"model": ("model",), "preprocess": ("preprocess",),
               "binning": ("binning",), "raster": ("raster", "render"),
               "loss": ("loss", "draws"), "backward": ("backward",),
               "adam": ("adam",)}
# the layers read in each kind of cell (its traffic's loop); the semantic
# cell bins every view in set-up, so its steps have no binning
LAYERS = {"semantic": ("model", "preprocess", "raster", "loss", "backward",
                       "adam"),
          "geometry": ("model", "preprocess", "binning", "raster", "loss",
                       "backward", "adam"),
          "frame": ("model", "preprocess", "binning", "raster")}


def idle_gaps(device_ops) -> list:
    """The gaps [(start_ns, end_ns)] between the union of the device
    operations' intervals (name, start_ns, end_ns, is_kernel)."""
    gaps, cur_e = [], None
    for _, s, e, _ in sorted(device_ops, key=lambda o: o[1]):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def segments(spans) -> tuple:
    """(starts, owner): from starts[k] until starts[k + 1] the innermost
    open span is spans[owner[k]], or none where owner[k] is -1. `spans`
    is a StepProfiler's list (None for a span left open, which is
    skipped)."""
    depth = [0] * len(spans)
    events = []
    for i, s in enumerate(spans):
        if s is None:
            continue
        if s.parent is not None:
            depth[i] = depth[s.parent] + 1
        if s.end_ns > s.start_ns:
            events.append((s.start_ns, 1, i))
            events.append((s.end_ns, 0, i))
    events.sort()
    starts, owner, heap, live = [], [], [], set()
    k = 0
    while k < len(events):
        t = events[k][0]
        while k < len(events) and events[k][0] == t:
            _, opens, i = events[k]
            if opens:
                live.add(i)
                heapq.heappush(heap, (-depth[i], -spans[i].start_ns, -i))
            else:
                live.discard(i)
            k += 1
        while heap and -heap[0][2] not in live:
            heapq.heappop(heap)
        starts.append(t)
        owner.append(-heap[0][2] if heap else -1)
    return starts, owner


def join(spans, device_ops, host_ops) -> dict:
    """Idle ns and kernel launches by span name: idle_ns (every gap's),
    idle_in_spans_ns, idle_ns_by_span, launches (every launch call's),
    launches_by_span. host_ops: (start_ns, end_ns, name) of the CUDA
    runtime calls."""
    starts, owner = segments(spans)
    idle_by = defaultdict(int)
    idle = inside = 0
    for gs, ge in idle_gaps(device_ops):
        idle += ge - gs
        k = bisect.bisect_right(starts, gs) - 1
        t = gs
        while t < ge:
            nxt = starts[k + 1] if k + 1 < len(starts) else ge
            end = min(ge, nxt)
            if k >= 0 and owner[k] >= 0:
                idle_by[spans[owner[k]].name] += end - t
                inside += end - t
            t, k = end, k + 1
    launches_by = defaultdict(int)
    launches = 0
    for s, _, name in host_ops:
        if name not in LAUNCH_CALLS:
            continue
        launches += 1
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and owner[k] >= 0:
            launches_by[spans[owner[k]].name] += 1
    return {"idle_ns": idle, "idle_in_spans_ns": inside,
            "idle_ns_by_span": dict(idle_by), "launches": launches,
            "launches_by_span": dict(launches_by)}


def readings(joined: dict, kind: str, steps: int) -> dict:
    """The layer readings of a cell of `kind` per step or frame, and the
    window's idle ms and launches per step beside them; {} without a
    device trace."""
    if not joined["idle_ns"] or steps <= 0 or kind not in LAYERS:
        return {}
    out = {}
    for layer in LAYERS[kind]:
        names = LAYER_SPANS[layer]
        out[f"{kind}_idle_ms.{layer}"] = sum(
            joined["idle_ns_by_span"].get(n, 0) for n in names) / 1e6 / steps
        out[f"{kind}_launches.{layer}"] = sum(
            joined["launches_by_span"].get(n, 0) for n in names) / steps
    out[f"idle_in_spans_pct.{kind}"] = (100.0 * joined["idle_in_spans_ns"]
                                        / joined["idle_ns"])
    out["idle_ms_per_step"] = joined["idle_ns"] / 1e6 / steps
    out["launches_per_step"] = joined["launches"] / steps
    return out


def measure(args, res: dict, dev, t_start: float = run.T_START) -> dict:
    """benchmark.run's traced measure() with the program's spans recorded
    over the traced window → its result with `spans` (the readings) and
    `spans_by_name` (the join's idle ms and launches per step of every
    span name)."""
    from instascene_tpu_torch.utils.profiling import StepProfiler, recording
    made = []

    class SpanTracer(trace.Tracer):
        def start(self):
            self.profiler = StepProfiler()
            self.recording = recording(self.profiler)
            self.recording.__enter__()
            made.append(self)
            super().start()

        def stop(self):
            try:
                super().stop()
            finally:
                self.recording.__exit__(None, None, None)

    plain = trace.Tracer
    trace.Tracer = SpanTracer      # run.measure imports it when it runs
    try:
        out = run.measure(args, res, dev, t_start)
    finally:
        trace.Tracer = plain
    (tr,) = made
    joined = join(tr.profiler.spans, tr.device_ops, tr.host_ops)
    n = out["attempted"]
    out["spans"] = readings(joined, res["mix"]["loop"], n)
    out["spans_by_name"] = {
        name: {"idle_ms": joined["idle_ns_by_span"].get(name, 0) / 1e6 / n,
               "launches": joined["launches_by_span"].get(name, 0) / n}
        for name in sorted(set(joined["idle_ns_by_span"])
                           | set(joined["launches_by_span"]))} if n else {}
    return out


def main(argv=None) -> int:
    args = run.parse(sys.argv[1:] if argv is None else argv)
    args.trace = 1
    res = run.resolve(run.load_spec(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print(f"benchmark.spans: the cell {args.workload} needs a CUDA "
              f"device; none is visible", file=sys.stderr)
        return 2
    out = measure(args, res, torch.device("cuda", 0))
    bad = run.forbidden_modules()
    if bad:
        print(f"benchmark.spans: the process loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
