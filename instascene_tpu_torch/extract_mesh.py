"""TSDF mesh extraction CLI, flag-compatible with the root extract_mesh.py:

    python -m instascene_tpu_torch.extract_mesh -s <colmap scene> \\
        [--ply_path <trained point_cloud.ply>] [--unbounded] [--device cpu]

Port of extract_mesh.py:13-56: renders every training view of a trained
model (K1 `full` on the card), fuses the depth maps into a TSDF volume on
the device, extracts the surface by marching tetrahedra on the device,
keeps the largest clusters and writes <model_path>/<output> as a binary
PLY. The same flags; `--device` (default CUDA, no CPU fallback) picks
where it runs. Prints the seconds of each stage.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

STAGES = ("load", "render", "fusion", "marching", "post-process", "write")


def parser() -> ArgumentParser:
    from .config import ModelParams, PipelineParams
    ap = ArgumentParser()
    ModelParams.add_to_parser(ap)
    PipelineParams.add_to_parser(ap)
    ap.add_argument("--ply_path", type=str, default="",
                    help="trained point_cloud.ply (default: "
                         "<source_path>/point_cloud.ply)")
    ap.add_argument("--voxel_size", type=float, default=0.004)
    ap.add_argument("--sdf_trunc", type=float, default=0.02)
    ap.add_argument("--depth_trunc", type=float, default=3.0)
    ap.add_argument("--unbounded", action="store_true")
    ap.add_argument("--mesh_res", type=int, default=512)
    ap.add_argument("--num_clusters", type=int, default=1000)
    ap.add_argument("--output", type=str, default="fuse.ply")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: cuda)")
    return ap


def main(argv=None) -> dict:
    """Extract and write the mesh; returns {"path", "n_verts", "n_faces",
    "seconds" (by stage, STAGES), "grid" (the TSDF volume's X, Y, Z),
    "voxel"}."""
    import torch

    from . import resolve_device
    from .config import ModelParams, PipelineParams
    from .data.dataset import Scene
    from .mesh.extractor import (GaussianExtractor, post_process_mesh,
                                 write_mesh_ply)
    from .mesh.tsdf import add_seconds, sync_clock
    from .models.gaussians import load_ply

    args = parser().parse_args(argv if argv is not None else sys.argv[1:])
    dataset = ModelParams.extract(args)
    pipe = PipelineParams.extract(args)
    dev = resolve_device(args.device)
    stats = dict.fromkeys(STAGES, 0.0)

    t0 = sync_clock(dev)
    ply = args.ply_path or os.path.join(dataset.source_path,
                                        "point_cloud.ply")
    params = load_ply(ply, device=dev)
    scene = Scene(dataset)
    t0 = add_seconds(stats, "load", t0, dev)
    extractor = GaussianExtractor(params, pipe)
    with torch.no_grad():
        extractor.reconstruction(scene.get_train_cameras())
        t0 = add_seconds(stats, "render", t0, dev)
        if args.unbounded:
            verts, faces, cols = extractor.extract_mesh_unbounded(
                args.mesh_res, stats=stats)
        else:
            verts, faces, cols = extractor.extract_mesh_bounded(
                voxel_size=args.voxel_size, sdf_trunc=args.sdf_trunc,
                depth_trunc=args.depth_trunc, stats=stats)
    t0 = sync_clock(dev)
    verts, faces, cols = post_process_mesh(verts, faces, cols,
                                           args.num_clusters)
    t0 = add_seconds(stats, "post-process", t0, dev)
    out = os.path.join(scene.model_path, args.output)
    write_mesh_ply(out, verts, faces, cols)
    add_seconds(stats, "write", t0, dev)
    print(f"mesh saved: {out} ({len(verts)} verts, {len(faces)} faces)",
          flush=True)
    seconds = {k: stats[k] for k in STAGES}
    print(f"TSDF grid {stats['grid']}, voxel {stats['voxel']:.6g}; stage "
          "seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()),
          flush=True)
    return {"path": out, "n_verts": len(verts), "n_faces": len(faces),
            "seconds": seconds, "grid": stats["grid"],
            "voxel": stats["voxel"]}


if __name__ == "__main__":
    main()
