"""A short run of each cell at the tiny size on the CPU prints the result
keys the contract asks for, with the reference agreeing with the program;
without a card the command refuses; nothing loaded is JAX or the JAX
package."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests import tiny
from benchmark.tests.test_bench_layout import CELLS, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_end_to_end(cell):
    out = tiny.tiny_run(cell, trace=0)
    assert list(out)[:5] == KEYS and list(out)[-1] == "compared"
    assert "breakdown" not in out
    assert out["correct"] is True and out["attempted"] >= 1
    res = tiny.tiny_res(cell)
    assert set(out["metrics"]) == {m["name"] for m in res["end_to_end"]}
    for c in out["compared"].values():
        assert c["value"] <= c["limit"]
    assert set(out["host"]) == {"loop_ms_before", "loop_ms_after",
                                "setup_s", "window_cpu_s", "window_s"}
    assert out["device"]["window_rate"] > 0


@pytest.mark.parametrize("cell", ["waldo.semantic", "waldo.frame-1080p"])
def test_traced_run_reports_per_layer_and_breakdown(cell):
    out = tiny.tiny_run(cell, trace=1)
    assert list(out)[:5] == KEYS and "breakdown" in out
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    res = tiny.tiny_res(cell)
    per_layer = {m["name"] for m in res["per_layer"]}
    assert out["metrics"] and set(out["metrics"]) <= per_layer
    assert out["correct"] is True


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.mark.skipif(
    torch.cuda.is_available(),
    reason="a machine with a card runs the cell; this checks the refusal")
def test_refuses_without_a_card():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], "--seed", "7", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env=_env())
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_refuses_in_a_tree_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], "--seed", "7", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_loads_no_jax_and_not_the_jax_package():
    """A whole tiny run in a fresh process: the top-level names in
    sys.modules, compared whole, hold none of jax, jaxlib, flax or
    instascene_tpu (instascene_tpu_torch is the program and passes)."""
    r = subprocess.run([sys.executable, "-m", "benchmark.tests.tiny",
                        "waldo.semantic", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900,
                       env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["forbidden"] == []
    assert line["result"]["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_on_the_card(cell, cuda_device):
    """The same tiny run through the program's CUDA kernels: the reference
    agrees and the traced line reads the kernels' shares."""
    import argparse
    import time
    from benchmark import run
    args = argparse.Namespace(workload=cell, seed=tiny.SEED, seconds=1.0,
                              trace=1)
    out = run.measure(args, tiny.tiny_res(cell), cuda_device,
                      t_start=time.perf_counter())
    assert out["correct"] is True, out["compared"]
    assert out["device"]["busy_s"] > 0
    assert any("roofline" in k for k in out["metrics"])
