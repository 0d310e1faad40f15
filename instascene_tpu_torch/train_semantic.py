"""Semantic feature-lifting CLI, flag-compatible with the root
train_semantic.py:

    python -m instascene_tpu_torch.train_semantic -s <scene> --use_seg_feature
        [--gram_feat_3d] [--iterations N] [--device cpu] ...

Port of train_semantic.py:15-47. The scene holds a trained point_cloud.ply
and COLMAP cameras with images and sam/mask/<image>.png instance maps; the
priors stage (tracker renders, spatial track) runs first, then contrastive
training, then the HDBSCAN instance export, under
output/<parent>/<scene>/<model_path> (or at -m when it is absolute).
`--device` (default CUDA) picks where it runs. The multi-view variants
take the root CLI's values: --mv_tile_subsample K (K random tiles per view
of the every-10th-step window, K3/K4), --mv_merged 1 (the window in one
merged launch each way) and --sparse_px 1 (only the drawn pixels blend,
K5/K6). --profile_trace DIR writes a torch.profiler trace of contrastive
iterations [start, end) of --profile_window to DIR/trace_<start>_<end>.json
(utils/profiling.py). --dp N trains on N ranks, one camera each per
contrastive step, as the geometry CLI's --dp does (spawned by the CLI;
NCCL over N GPUs, or gloo with --device cpu): rank 0 computes and writes
the priors, the others load them; rank 0 saves and runs the HDBSCAN
export, and main returns its summary (a dict) instead of the
SegSplatting.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

from .config import ModelParams, OptimizationParams, PipelineParams


def parser() -> ArgumentParser:
    ap = ArgumentParser(description="Training script parameters")
    ModelParams.add_to_parser(ap)
    OptimizationParams.add_to_parser(ap)
    PipelineParams.add_to_parser(ap)
    ap.add_argument("--dp", type=int, default=0)
    ap.add_argument("--profile_trace", type=str, default=None)
    ap.add_argument("--profile_window", nargs=2, type=int,
                    default=[100, 120])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to train on (default: cuda)")
    return ap


def main(argv=None):
    """Priors, contrastive training and the export; returns the
    SegSplatting, or with --dp N rank 0's summary of the N ranks
    (_dp_rank)."""
    args = parser().parse_args(argv if argv is not None else sys.argv[1:])
    if args.dp:
        from .parallel.launch import launch
        return launch(_dp_rank, args.dp, args, device=args.device)[0]
    return _train(args)


def _dp_rank(rank: int, world: int, device, args) -> dict:
    """One rank of --dp: train, then rank 0's summary with every rank's
    state digest, kernel launches and whether it computed or loaded the
    priors."""
    from .cuda_build import LAUNCHES
    from .parallel.data_parallel import gather_notes, state_digest
    args.device = str(device)
    seg = _train(args, dp=world)
    notes = gather_notes({"rank": rank, "priors": seg.priors,
                          "digest": state_digest(seg.params),
                          "launches": LAUNCHES.copy()})
    return {"model_path": seg.model_path,
            "instances": int(seg.seg3d_masks.shape[1]),
            "last_loss": seg.last_loss, "timings": seg.timings,
            "ranks": notes}


def _train(args, dp: int = 0):
    from .pipelines.train_semantic import SegSplatting

    segsplat = SegSplatting(ModelParams.extract(args),
                            OptimizationParams.extract(args),
                            PipelineParams.extract(args),
                            dp=dp, device=args.device)
    if args.profile_trace:
        segsplat.profile_trace = args.profile_trace
        segsplat.profile_window = tuple(args.profile_window)
    segsplat.robust_semantic_priors()
    segsplat.train_segfeat()
    if segsplat.rank == 0:
        print("\nTraining complete.", flush=True)
    return segsplat


if __name__ == "__main__":
    main()
