"""What the metric readers (benchmark/metrics/<metric>.py) share. Each
reader takes the run's record: the set-up's seconds, the window (steps or
frames, seconds, latencies, stage times), and in a traced run the trace's
records and the work counts. A reader that finds nothing to read returns
None, and the metric is left out of the line."""

from __future__ import annotations

import numpy as np

from benchmark.counts import PEAK_FLOPS
from benchmark.trace import split_kernels


def rate(rec):
    w = rec["window"]
    return w["n"] / w["window_s"]


def p95_ms(rec):
    lat = rec["window"].get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None


def stage_ms(rec, name: str):
    sm = rec["window"].get("stage_ms")
    return sm.get(name) if sm else None


def mean_ms(rec, key: str):
    v = rec["window"].get(key)
    return float(np.mean(v)) if v else None


def _kernels(rec):
    tr = rec.get("trace")
    return split_kernels(tr["kernels"]) if tr and tr["kernels"] else None


def torch_launches(rec):
    """PyTorch's kernels per step or frame (the kernels that are not the
    program's own)."""
    k = _kernels(rec)
    if not k or "torch" not in k:
        return None
    return k["torch"][0] / rec["window"]["n"]


def torch_ops_ms(rec):
    """PyTorch's kernels' device ms per step or frame."""
    k = _kernels(rec)
    if not k or "torch" not in k:
        return None
    return k["torch"][1] * 1e3 / rec["window"]["n"]


def roofline(rec, keys):
    """100 · Σ least time ÷ Σ traced device time over the window's launches
    of the kernels `keys`."""
    k = _kernels(rec)
    counts = rec.get("counts")
    if not k or not counts or not all(x in k for x in keys):
        return None
    t = sum(k[x][1] for x in keys)
    b = sum(counts["bound_s"].get(x, 0.0) for x in keys)
    return 100.0 * b / t if t > 0 and b > 0 else None


def idle_pct(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / rec["window"]["window_s"])


def mfu(rec):
    """100 · the window's counted FP32 operations ÷ (its seconds · the
    FP32 peak)."""
    counts = rec.get("counts")
    if not counts or not rec.get("trace") or counts["flops"] <= 0:
        return None
    return 100.0 * counts["flops"] / (rec["window"]["window_s"]
                                      * PEAK_FLOPS)
