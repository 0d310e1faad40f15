"""A tiny size of every cell, for the benchmark's CPU tests: the same
loops, readers and reference on a few hundred gaussians at a few dozen
pixels, with the program's plain PyTorch kernels."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import run

TINY = dict(n_gaussians=800, train_width=48, train_height=32,
            viewer_width=64, viewer_height=48, n_cameras=7)
SEED = 2 ** 31 + 4321


def tiny_res(cell: str) -> dict:
    res = run.resolve(run.load_spec(), cell)
    res["config"].update(TINY)
    if res["mix"]["loop"] == "semantic":
        res["mix"]["batch"] = 256
    if res["mix"]["loop"] == "frame":
        res["mix"].update(poses=3, sample_among=3, samples=2)
    return res


def tiny_run(cell: str, trace: int = 0, seconds: float = 1.5,
             seed: int = SEED) -> dict:
    """One run of the cell at the tiny size on the CPU, past the harness's
    look for a card."""
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return run.measure(args, tiny_res(cell), torch.device("cpu"),
                       t_start=time.perf_counter())


if __name__ == "__main__":
    torch.set_num_threads(2)
    out = tiny_run(sys.argv[1], int(sys.argv[2]))
    print(json.dumps({"result": out, "forbidden": run.forbidden_modules()}))
