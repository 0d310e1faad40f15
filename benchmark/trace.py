"""The traced run's device timeline: torch.profiler over the measured
window, read in memory, never written to disk.

It records the CUDA activity alone: the device's operations and the CUDA
runtime calls the host makes. Recording the host's PyTorch operators too
halves the pace of these host-bound steps, and the window would no longer
be the one the end-to-end metrics measure. An idle gap is named by the
runtime call open at its start (a synchronize: the host waits for the
device) or else by the next call the host made (the host was in Python
before it).

What it gives the per-layer readers: every device operation's name and
interval, the union of those intervals (the device's busy time), the
kernels that are the program's own (csrc/*.cu) apart from the rest.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

# the program's own CUDA kernels by a part of their names; the rest of the
# kernels in a trace are PyTorch's
OWN_KERNELS = {"K1": "blend_fwd_kernel", "K2": "blend_bwd_kernel",
               "segment_sum": "segment_sum_kernel",
               "K5": "sparse_fwd_kernel", "K6": "sparse_bwd_kernel"}


def own_kernel(name: str):
    """The key of one of the program's kernels in a traced name, or None."""
    for key, part in OWN_KERNELS.items():
        if part in name:
            return key
    return None


class Tracer:
    """start() before the window, stop() after its closing synchronize;
    then the records."""

    def __init__(self):
        self._prof = None
        self.device_ops = []          # (name, start_ns, end_ns, is_kernel)
        self.host_ops = []            # (start_ns, end_ns, name)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
        self._prof = profile(activities=acts,
                             record_shapes=False, with_stack=False)
        self._prof.start()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        for e in self._prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if dur <= 0:
                continue
            if str(e.device_type()).endswith("CPU"):
                self.host_ops.append((start, start + dur, e.name()))
            else:
                kind = str(e.activity_type()).lower() if hasattr(
                    e, "activity_type") else "kernel"
                self.device_ops.append((e.name(), start, start + dur,
                                        "kernel" in kind))
        self._prof = None

    def records(self) -> dict:
        """busy_s (the union of device intervals), kernel seconds and counts
        by name, the top device operations and the idle gaps named by the
        innermost host operation open at the gap's start."""
        ops = sorted(self.device_ops, key=lambda o: o[1])
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for _, s, e, _ in ops:
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        kernels = defaultdict(lambda: [0, 0.0])
        by_name = defaultdict(float)
        for name, s, e, is_kernel in ops:
            by_name[name] += (e - s) * 1e-9
            if is_kernel:
                kernels[name][0] += 1
                kernels[name][1] += (e - s) * 1e-9
        host = sorted(self.host_ops)
        starts = [h[0] for h in host]
        gap_by = defaultdict(float)
        for gs, ge in gaps:
            i = bisect.bisect_right(starts, gs) - 1
            nxt = i + 1
            name = None
            # the innermost open host op: the latest start still open
            while i >= 0 and i > nxt - 400:
                if host[i][1] >= gs:
                    name = host[i][2]
                    break
                i -= 1
            if name is None:
                name = ("(python) before " + host[nxt][2]
                        if nxt < len(host) else "(python)")
            gap_by[name] += (ge - gs) * 1e-9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        top = [(short(n), s) for n, s in top]
        idle = sorted(gap_by.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy * 1e-9,
                "kernels": {k: tuple(v) for k, v in kernels.items()},
                "breakdown": {"device_ops": [[n, s] for n, s in top],
                              "idle_gaps": [[n, s] for n, s in idle]}}


def short(name: str) -> str:
    """A kernel's name without its return type and argument list, at most
    120 characters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:120]


def split_kernels(kernels: dict) -> dict:
    """Kernel (count, seconds) summed by the program's kernel key, and
    "torch" for every other kernel."""
    out = defaultdict(lambda: [0, 0.0])
    for name, (n, s) in kernels.items():
        key = own_kernel(name) or "torch"
        out[key][0] += n
        out[key][1] += s
    return {k: tuple(v) for k, v in out.items()}
