"""2DGS geometry training CLI, flag-compatible with the root train.py:

    python -m instascene_tpu_torch.train -s <COLMAP or Blender scene>
        [-m out] [--eval] [--profile_trace DIR] [--device cpu] ...

Port of train.py:18-137. The same flags; `--device` (default CUDA) picks
where it trains. --dp N trains on N ranks, one camera each per step
(parallel/): the CLI spawns them itself, rank r on cuda:r over NCCL (N
must not exceed the visible GPUs), or with --device cpu every rank on the
CPU over gloo. Rank 0 alone writes the outputs, logs, reports, traces and
serves the viewer; main then returns rank 0's summary (a dict) instead of
the trainer. Without --disable_viewer the SIBR network viewer listens on
--ip:--port and is served once per iteration (viewer/network_gui.py); when
the address cannot be bound, training goes on without it. Losses and
evaluations are printed, and logged to TensorBoard in the output folder
when tensorboard is installed. --profile_trace DIR writes a torch.profiler
trace of iterations [start, end) of --profile_window to
DIR/trace_<start>_<end>.json (utils/profiling.py).
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
    """Train; returns the GeometryTrainer, or with --dp N rank 0's summary
    of the N ranks' training (_dp_rank)."""
    args = parser().parse_args(argv if argv is not None else sys.argv[1:])
    args.save_iterations.append(args.iterations)
    if args.dp:
        from .parallel.launch import launch
        return launch(_dp_rank, args.dp, args, device=args.device)[0]
    return _train(args)


def _dp_rank(rank: int, world: int, device, args) -> dict:
    """One rank of --dp: train, then rank 0's summary with every rank's
    state digest (equal digests: the replicas stayed bit for bit equal)
    and kernel launches (cuda_build.LAUNCHES of its process)."""
    from .cuda_build import LAUNCHES
    from .parallel.data_parallel import gather_notes, state_digest
    args.device = str(device)
    tr = _train(args, dp=world)
    notes = gather_notes({"rank": rank, "digest": state_digest(
        tr.params, tr.opt_state, tr.stats), "launches": LAUNCHES.copy()})
    return {"model_path": tr.scene.model_path, "n_alive": tr.params.n_alive(),
            "capacity": tr.params.capacity, "adam_count": tr.opt_state.count,
            "reports": tr.reports, "ranks": notes}


def _train(args, dp: int = 0):
    import contextlib
    dataset = ModelParams.extract(args)
    opt = OptimizationParams.extract(args)
    pipe = PipelineParams.extract(args)
    random.seed(0)
    np.random.seed(0)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)

    from .data.dataset import Scene
    from .parallel.launch import rank0_first
    from .pipelines.train import GeometryTrainer
    from .utils.profiling import TraceWindow
    from .utils.tb import maybe_summary_writer

    # a Blender scene without points3d.ply gets one written: by rank 0
    with rank0_first() if dp else contextlib.nullcontext(True) as first:
        scene = Scene(dataset)
    if first:
        print(f"Output folder: {scene.model_path}", flush=True)
        save_cfg_args(scene.model_path, args)

    trainer = GeometryTrainer(dataset, opt, pipe, scene, device=args.device,
                              dp=dp)
    first_iter = 0
    if args.start_checkpoint:
        from .pipelines.checkpoint import load_checkpoint
        (trainer.params, trainer.opt_state, trainer.stats,
         first_iter) = load_checkpoint(args.start_checkpoint, trainer.device)
        if first:
            print(f"Resumed from {args.start_checkpoint} at iter "
                  f"{first_iter}", flush=True)
    gui = tb = None
    if first and not args.disable_viewer:
        from .viewer.network_gui import NetworkGUI
        try:
            gui = NetworkGUI(args.ip, args.port)
        except OSError:
            pass        # the address is taken: train without the viewer
    if first:
        tb = maybe_summary_writer(scene.model_path)
    try:
        trainer.train(
            opt.iterations, test_iterations=args.test_iterations,
            save_iterations=args.save_iterations,
            checkpoint_iterations=args.checkpoint_iterations,
            first_iter=first_iter, progress=not args.quiet,
            on_iteration=(lambda it: gui.tick(trainer, pipe, dataset))
            if gui is not None else None, tb=tb,
            tracer=TraceWindow(args.profile_trace if first else None,
                               *args.profile_window))
    finally:
        if gui is not None:
            gui.close()
        if tb is not None:
            tb.close()
    if first:
        print("\nTraining complete.", flush=True)
    return trainer


if __name__ == "__main__":
    main()
