"""The readings that the correctness limits are set from, on the chip, at the
cell's own size, for many seeds in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3
        [--upper_seeds 4] [--seconds 2] [--sample_among 100]

For each seed it builds the cell's inputs, runs the program's checked
steps (a training cell's first three steps) and a short window of
--seconds at the cell's own load (for training, on until its drawn step
has run), frees the program's state and runs
the plain reference in float32: the numbers the run compares, as the
benchmark's runs compare them (the lower readings). On the first
--upper_seeds seeds the reference in bfloat16 also takes the program's
place (the control), and a training cell's reference with half of each
step's pixels left out, the mean taken over the rest (the half-batch
fault); both are compared with the float32 reference the same way (the
upper readings).
One JSON line per seed, then one with each number's largest program
reading and smallest control and fault readings. The benchmark's own runs
do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import run


def half_mask(shape, seed: int, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) + 99)
    return torch.rand(shape, generator=gen, device=dev) < 0.5


def readings(res: dict, seed: int, dev, seconds: float, upper: bool) -> dict:
    import time
    cell = run.loop(res["mix"]["loop"]).setup(res["config"], res["mix"],
                                              seed, dev, warm=False)
    cell.run_window(seconds, traced=False)
    cell.finish()
    got = cell.readings()
    cell.release()
    t0 = time.perf_counter()
    ref = cell.reference()
    out = {"seed": seed, "program": cell.gaps(got, ref),
           "reference_s": time.perf_counter() - t0}
    if upper:
        out["control"] = cell.gaps(cell.reference(torch.bfloat16), ref)
    if upper and res["mix"]["loop"] in ("geometry", "semantic"):
        if res["mix"]["loop"] == "geometry":
            shape = (res["config"]["train_height"],
                     res["config"]["train_width"])
        else:
            shape = (res["mix"]["batch"],)
        keep = half_mask(shape, seed, dev)
        out["half_batch"] = cell.gaps(cell.reference(keep=keep), ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--upper_seeds", type=int, default=4,
                    help="the control and the faults on the first N seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sample_among", type=int, default=0,
                    help="frames: draw the kept frames among the first N")
    args = ap.parse_args(argv)
    res = run.resolve(run.load_spec(), args.workload)
    if args.sample_among:
        res["mix"]["sample_among"] = args.sample_among
    dev = torch.device("cuda", 0)
    rows = []
    for j, s in enumerate(args.seeds.split(",")):
        r = readings(res, int(s), dev, args.seconds, j < args.upper_seeds)
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for kind, pick in (("program", max), ("control", min),
                       ("half_batch", min)):
        have = [r[kind] for r in rows if kind in r]
        if have:
            summary[kind] = {k: pick(h[k] for h in have) for k in have[0]}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    sys.exit(main())
