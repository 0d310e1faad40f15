"""Profiling: torch.profiler traces of a training window, per-section wall
clocks, and the device's memory counters.

Port of instascene_tpu/utils/profiling.py (`trace`, `TraceWindow`,
`StepProfiler`, `device_memory_stats`) on torch.profiler in place of
jax.profiler. A trace records the host's operators and, where CUDA is
available, the card's kernels and copies with their device times (CUPTI),
the port's ctypes-launched kernels included; no stacks and no shapes, to
keep its cost small. It is written as a Chrome trace JSON into the
trace's directory: open it in Perfetto (ui.perfetto.dev) or
chrome://tracing.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import torch


def _start():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False, with_stack=False)
    prof.start()
    return prof


def _stop(prof, path: str) -> None:
    """Stop once the card's queue has drained (so the window's kernels are
    in the trace) and write the Chrome trace to `path`."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)


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
    in <log_dir>/trace_<start>_<end>.json (`path`). close() is idempotent
    and also stops a trace left open by a run that ended mid-window."""

    def __init__(self, log_dir: str, start: int, end: int):
        self.log_dir = log_dir
        self.start = int(start)
        self.end = int(end)
        self.path = (os.path.join(log_dir, f"trace_{self.start}_{self.end}"
                                  ".json") if log_dir else None)
        self._prof = None

    def tick(self, it: int) -> None:
        if self.log_dir is None or self.end <= self.start:
            return
        if it == self.start and self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = _start()
        elif it == self.end and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            _stop(self._prof, self.path)
            self._prof = None
            print(f"\nprofiler trace -> {self.path}", flush=True)


class StepProfiler:
    """Per-section wall-clock accounting across training steps."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 3),
                    "mean_ms": round(v / max(self.counts[k], 1) * 1000, 2),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1])}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


def device_memory_stats() -> dict:
    """The card's allocator counters in bytes or sizes
    (torch.cuda.memory_stats); {} without a card."""
    if not torch.cuda.is_available():
        return {}
    return {k: v for k, v in torch.cuda.memory_stats().items()
            if "bytes" in k or "size" in k}
