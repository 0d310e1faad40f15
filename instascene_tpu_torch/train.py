"""2DGS geometry training CLI, flag-compatible with the root train.py:

    python -m instascene_tpu_torch.train -s <colmap scene> [-m out] [--eval]
        [--device cpu] ...

Port of train.py:18-137. The same flags; `--device` (default CUDA) picks
where it trains. Not served yet, and refused with the item that brings
them: --dp and --profile_trace (ROADMAP A12). The network viewer (A10) is
skipped, with or without --disable_viewer; TensorBoard logging waits for
A12 (losses and evaluations are printed).
"""

from __future__ import annotations

import random
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from .config import (ModelParams, OptimizationParams, PipelineParams,
                     save_cfg_args)


def parser() -> ArgumentParser:
    ap = ArgumentParser(description="Training script parameters")
    ModelParams.add_to_parser(ap)
    OptimizationParams.add_to_parser(ap)
    PipelineParams.add_to_parser(ap)
    ap.add_argument("--ip", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6009)
    ap.add_argument("--detect_anomaly", action="store_true", default=False)
    ap.add_argument("--test_iterations", nargs="+", type=int,
                    default=[7_000, 15_000, 30_000])
    ap.add_argument("--save_iterations", nargs="+", type=int,
                    default=[7_000, 15_000, 30_000])
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--checkpoint_iterations", nargs="+", type=int,
                    default=[])
    ap.add_argument("--start_checkpoint", type=str, default=None)
    ap.add_argument("--disable_viewer", action="store_true", default=False)
    ap.add_argument("--dp", type=int, default=0)
    ap.add_argument("--profile_trace", type=str, default=None)
    ap.add_argument("--profile_window", nargs=2, type=int,
                    default=[100, 120])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to train on (default: cuda)")
    return ap


def main(argv=None):
    """Train; returns the GeometryTrainer."""
    args = parser().parse_args(argv if argv is not None else sys.argv[1:])
    if args.dp:
        raise NotImplementedError("--dp (camera-batch data parallelism) is "
                                  "not ported yet: ROADMAP A12")
    if args.profile_trace:
        raise NotImplementedError("--profile_trace is not ported yet: "
                                  "ROADMAP A12")
    args.save_iterations.append(args.iterations)
    dataset = ModelParams.extract(args)
    opt = OptimizationParams.extract(args)
    pipe = PipelineParams.extract(args)
    random.seed(0)
    np.random.seed(0)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)

    from .data.dataset import Scene
    from .pipelines.train import GeometryTrainer

    scene = Scene(dataset)
    print(f"Output folder: {scene.model_path}", flush=True)
    save_cfg_args(scene.model_path, args)
    if not args.disable_viewer:
        print("network viewer not ported yet (ROADMAP A10): training "
              "without it", flush=True)

    trainer = GeometryTrainer(dataset, opt, pipe, scene, device=args.device)
    first_iter = 0
    if args.start_checkpoint:
        from .pipelines.checkpoint import load_checkpoint
        (trainer.params, trainer.opt_state, trainer.stats,
         first_iter) = load_checkpoint(args.start_checkpoint, trainer.device)
        print(f"Resumed from {args.start_checkpoint} at iter {first_iter}",
              flush=True)
    trainer.train(opt.iterations, test_iterations=args.test_iterations,
                  save_iterations=args.save_iterations,
                  checkpoint_iterations=args.checkpoint_iterations,
                  first_iter=first_iter, progress=not args.quiet)
    print("\nTraining complete.", flush=True)
    return trainer


if __name__ == "__main__":
    main()
