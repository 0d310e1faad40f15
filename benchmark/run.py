"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything is found by name from BENCHMARK.json at the checkout's root: the
cell names its configuration (benchmark/configs/<config>.json) and its
traffic mix (benchmark/traffic/<mix>.json), whose "loop" names the code
that runs it (benchmark/loops/<loop>.py); each metric is a reader of
its own (benchmark/metrics/<metric>.py) and each cell's correctness limits
are a file of their own (benchmark/limits/<cell>.json).

A run: set-up (imports, the kernels' build when the checkout has none yet,
the scene from the seed, the program's objects, the first steps that the
check compares, warm-up over every shape the mix uses), then the measured
window of --seconds, closed by a synchronize; then the device's peak
memory is read, the program's state freed, and the plain reference
(benchmark/reference/) checks what the window's own entry produced. With
--trace 1 the window runs under torch.profiler and the line carries the
per-layer metrics instead of the end-to-end ones. The result is the last
line of standard output; the compared numbers and their limits are the
last lines of standard error and the last key of the result.

Beside the metrics each line says what the run could see of its host's
pace, so that a drift of the host can be told from a change of the
program: `host` holds a fixed pure-Python loop's ms before set-up and
after the window, set-up's seconds (host-bound work, so a slower host
reads higher; the traced line has no setup_s metric), and the process's
CPU seconds over the window's seconds; `device` holds the window's own
rate (steps or frames a second, the traced rate in a traced run).

It refuses to run without a CUDA device (or with fewer than the cell asks
for), and it exits with an error if JAX, its libraries or the JAX package
were loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "instascene_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix, limits and the
    metrics it reports (end-to-end and per-layer), by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"cells: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    applies = lambda m: workload in m.get("workloads", [workload])
    return {"cell": cell,
            "config": load_json(root / conf["file"]),
            "mix": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
            "per_layer": [m for m in spec["per_layer"] if applies(m)]}


def reader(name: str):
    """The read(rec) function of benchmark/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    return out[0].rsplit(",", 1)[-1].strip() if out else "not measured"


def host_loop_ms(reps: int = 5, n: int = 100000) -> float:
    """The median ms of a fixed pure-Python loop: the host's pace as this
    process sees it (a slower or busier core reads higher)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        acc = 0
        for i in range(n):
            acc = (acc + i * i) % 1000003
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, res: dict, dev, t_start: float = T_START) -> dict:
    """Set-up, window, check and metrics of one run on `dev` → the result
    dict (without printing)."""
    import torch
    host = {"loop_ms_before": host_loop_ms()}
    cell = loop(res["mix"]["loop"]).setup(
        res["config"], res["mix"], args.seed, dev)
    tracer = None
    if args.trace:
        from benchmark.trace import Tracer
        tracer = Tracer()
    setup_s = time.perf_counter() - t_start
    host["setup_s"] = setup_s
    if tracer:
        tracer.start()
    cpu0 = time.process_time()
    window = cell.run_window(args.seconds, traced=bool(args.trace))
    host["window_cpu_s"] = time.process_time() - cpu0
    host["window_s"] = window["window_s"]
    if tracer:
        tracer.stop()
    host["loop_ms_after"] = host_loop_ms()
    cell.finish()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    cell.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = cell.compare()
    rec = {"setup_s": setup_s, "window": window, "cell": res["cell"],
           "config": res["config"], "mix": res["mix"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": res["cell"]["chips"], "memory_peak_bytes": int(peak),
              "power_limit": (power_limit() if dev.type == "cuda"
                              else "not measured"),
              "window_rate": window["n"] / window["window_s"]}
    out = {"correct": None, "attempted": window["n"],
           "failed": window.get("failed", 0)}
    if tracer:
        rec["trace"] = tracer.records()
        rec["counts"] = cell.counts(window)
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = window["window_s"]
        metrics = res["per_layer"]
    else:
        metrics = res["end_to_end"]
    vals = {}
    for m in metrics:
        v = reader(m["name"])(rec)
        if v is not None and math.isfinite(v):
            vals[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # a number that is not finite prints as null (JSON has no infinity)
    checks = {k: {"value": float(v) if math.isfinite(v) else None,
                  "limit": float(res["limits"][k])}
              for k, v in compared.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values()) and set(checks) == set(res["limits"])
    out.update(correct=bool(ok and out["failed"] == 0), metrics=vals,
               device=device)
    if tracer:
        out["breakdown"] = rec["trace"]["breakdown"]
    out["host"] = host
    out["compared"] = checks
    return out


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    spec = load_spec()
    res = resolve(spec, args.workload)
    import torch
    chips = res["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {args.workload} needs {chips} CUDA "
              f"device(s); {seen} visible", file=sys.stderr)
        return 2
    out = measure(args, res, torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}", file=sys.stderr)
        return 3
    for k, c in out["compared"].items():
        print(f"compared {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
