"""One-command scene evaluation: geometry, then semantics, then one table
and one JSON line.

    python -m instascene_tpu_torch.scripts.eval_scene -s <scene>
        [--geometry_iters 7000] [--semantic_iters 10000]
        [--gt_instances labels.npy] [--device cpu] ...

Port of scripts/eval_scene.py (`run_geometry`, `run_semantic`, `main`),
with the same flags and `results` keys, plus `--device` (default CUDA).
Given a COLMAP scene (sparse/0 + images, with sam/mask label maps for the
semantic stage, or point_cloud.ply to skip geometry), it runs

  1. 2DGS geometry training with the every-8th held-out split, reporting
     train/test PSNR and it/s, and copies the PLY to
     <scene>/point_cloud.ply, which the semantic stage loads;
  2. the semantic stage (spatial-track priors, contrastive iterations and
     the HDBSCAN export), reporting it/s and, with --gt_instances (an npy
     of one ground-truth instance label per initial gaussian), the
     Hungarian-matched 3D instance mIoU of the priors.

Walls end with the card's queue drained. --rasterizer_impl is accepted for
the JAX script's command lines; the port has one rasterizer.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_geometry(dataset, opt, pipe, iters, device=None):
    from ..data.dataset import Scene
    from ..pipelines.train import GeometryTrainer
    scene = Scene(dataset)
    trainer = GeometryTrainer(dataset, opt, pipe, scene, device=device)
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        trainer.step(it)
    _sync(trainer.device)
    wall = time.perf_counter() - t0
    res = {"geometry_iters": iters,
           "geometry_its": round(iters / wall, 2),
           "geometry_wall_s": round(wall, 1),
           "n_gaussians": int(trainer.params.n_alive())}
    res["train_psnr"] = round(trainer.evaluate(split="train")["psnr"], 2)
    if trainer.test_cams:
        res["test_psnr"] = round(trainer.evaluate(split="test")["psnr"], 2)
    res["ply"] = trainer.save(iters)
    return res, trainer


def run_semantic(dataset, opt, pipe, iters, gt_instances=None, device=None):
    from ..pipelines.train_semantic import SegSplatting
    seg = SegSplatting(dataset, opt, pipe, device=device)
    t0 = time.perf_counter()
    seg.robust_semantic_priors()
    priors_wall = time.perf_counter() - t0
    res = {"priors_wall_s": round(priors_wall, 1),
           "n_instances": int(seg.seg3d_masks.shape[1])}
    if gt_instances is not None:
        from ..semantic.metrics import instance_miou
        gt = np.load(gt_instances)
        pred = seg.seg3d_labels[:len(gt)]
        res["instance_miou"] = round(instance_miou(pred, gt), 3)
    t0 = time.perf_counter()
    seg.train_segfeat(iterations=iters, progress=True)
    _sync(seg.device)
    wall = time.perf_counter() - t0
    res["semantic_iters"] = iters
    res["semantic_its"] = round(iters / wall, 2)
    res["semantic_wall_s"] = round(wall, 1)
    return res


def main(argv=None):
    from ..config import ModelParams, OptimizationParams, PipelineParams
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--model_path", "-m", type=str, default="eval_run")
    parser.add_argument("--geometry_iters", type=int, default=7000)
    parser.add_argument("--semantic_iters", type=int, default=10000)
    parser.add_argument("--skip_geometry", action="store_true",
                        help="scene dir already contains point_cloud.ply")
    parser.add_argument("--skip_semantic", action="store_true")
    parser.add_argument("--no_eval_split", action="store_true",
                        help="train on all cameras (no every-8th hold-out)")
    parser.add_argument("--resolution", "-r", type=int, default=-1)
    parser.add_argument("--sample_batchsize", type=int, default=32 * 1024)
    parser.add_argument("--gt_instances", type=str, default="",
                        help="npy of ground-truth instance labels per "
                             "initial gaussian (synthetic scenes) for mIoU")
    parser.add_argument("--rasterizer_impl", type=str, default="auto")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    results = {"scene": args.source_path}

    if not args.skip_geometry:
        dataset = ModelParams(source_path=args.source_path,
                              model_path=args.model_path,
                              resolution=args.resolution,
                              eval=not args.no_eval_split)
        opt = OptimizationParams(iterations=args.geometry_iters)
        pipe = PipelineParams(rasterizer_impl=args.rasterizer_impl)
        geo, _ = run_geometry(dataset, opt, pipe, args.geometry_iters,
                              args.device)
        results.update(geo)
        # the semantic stage loads <source>/point_cloud.ply
        # (reference train_semantic.py:27)
        shutil.copy(geo["ply"],
                    os.path.join(args.source_path, "point_cloud.ply"))

    if not args.skip_semantic and os.path.isdir(
            os.path.join(args.source_path, "sam", "mask")):
        dataset = ModelParams(source_path=args.source_path,
                              model_path=args.model_path,
                              resolution=args.resolution,
                              use_seg_feature=True, seg_feat_dim=16)
        opt = OptimizationParams(iterations=args.semantic_iters,
                                 sample_batchsize=args.sample_batchsize,
                                 gram_feat_3d=True,
                                 consider_negative_labels=True)
        pipe = PipelineParams(rasterizer_impl=args.rasterizer_impl)
        results.update(run_semantic(dataset, opt, pipe, args.semantic_iters,
                                    gt_instances=args.gt_instances or None,
                                    device=args.device))

    print("\n=== scene evaluation ===")
    for k, v in results.items():
        print(f"  {k:<18s} {v}")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
