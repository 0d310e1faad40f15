"""Click-to-segment CLI.

Port of the root semantic_gui.py:17-100 (`main`), run as

    python -m instascene_tpu_torch.semantic_gui -p scene.ply [--headless \
        --click 320,240[,x2,y2...]] [--width 800 --height 600] \
        [--use_colmap_camera -s <colmap scene>]

Same flags. Without --headless it opens the dearpygui window
(viewer/gui.py::run_gui; dearpygui must be installed). With --headless and
--click it renders the view (the orbit camera, or the scene's first COLMAP
training camera with --use_colmap_camera), picks the feature under each
click, segments the matching gaussians and saves
<out_dir>/<interactive_note>/segment_0.ply; without clicks it writes
preview PNGs of --render_mode. `--device` picks the device (default cuda;
there is no CPU fallback).
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--ply_path", "-p", type=str, required=True)
    parser.add_argument("--seg_feat_dim", type=int, default=16)
    parser.add_argument("--interactive_note", type=str, default="default")
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=600)
    parser.add_argument("--score_threshold", type=float, default=0.7)
    parser.add_argument("--headless", action="store_true")
    parser.add_argument("--click", type=str, default="",
                        help="headless: comma-separated pixel coords x,y,...")
    parser.add_argument("--camera_radius", type=float, default=2.0)
    parser.add_argument("--out_dir", type=str,
                        default="interactive_segmentation")
    parser.add_argument("--use_colmap_camera", action="store_true",
                        help="browse the scene's COLMAP training cameras "
                             "(requires --source_path)")
    parser.add_argument("--source_path", "-s", type=str, default="",
                        help="scene dir for --use_colmap_camera")
    parser.add_argument("--downscale_ratio", "-r", type=int, default=1)
    parser.add_argument("--render_mode", type=str, default="rgb",
                        choices=["rgb", "feature", "depth", "normal",
                                 "alpha"],
                        help="headless preview mode")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    from .config import PipelineParams
    from .models.gaussians import load_ply
    from .utils.image import write_png
    from .viewer.gui import (OrbitCamera, SegmentationEngine, compose_frame,
                             run_gui)

    params = load_ply(args.ply_path, max_sh_degree=3,
                      seg_feat_dim=args.seg_feat_dim, load_seg_feat=True,
                      device=args.device)
    if params.seg_feature is None:
        raise SystemExit("PLY has no segfeat_* attributes — run "
                         "train_semantic.py first")
    engine = SegmentationEngine(params, PipelineParams(),
                                score_threshold=args.score_threshold)

    train_cameras = None
    if args.use_colmap_camera:
        if not args.source_path:
            raise SystemExit("--use_colmap_camera requires --source_path")
        # the scene's COLMAP cameras, without their images
        from .config import ModelParams
        from .data.dataset import Scene
        scene = Scene(ModelParams(source_path=args.source_path,
                                  resolution=args.downscale_ratio),
                      load_images=False)
        train_cameras = scene.get_train_cameras()

    if not args.headless:
        run_gui(engine, args.width, args.height, args.interactive_note,
                train_cameras=train_cameras)
        return engine
    if train_cameras:
        mini = train_cameras[0]
    else:
        mini = OrbitCamera(args.width, args.height,
                           r=args.camera_radius).minicam()
    coords = [float(x) for x in args.click.split(",") if x]
    for i in range(0, len(coords) - 1, 2):
        engine.click(mini, int(coords[i]), int(coords[i + 1]))
        print(f"click at ({coords[i]}, {coords[i+1]})")
    if engine.chosen_features:
        save_dir = os.path.join(args.out_dir, args.interactive_note)
        mask = engine.segment_3d(save_dir, 0)
        print(f"segmented {int(mask.sum())} gaussians → {save_dir}")
    else:
        need_aux = args.render_mode in ("depth", "normal", "alpha")
        frame = engine.render_view(mini, need_aux=need_aux)
        buf = compose_frame(engine, frame, args.render_mode)
        os.makedirs(args.out_dir, exist_ok=True)
        to8 = lambda a: (np.clip(a, 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(args.out_dir, "preview_rgb.png"),
                  to8(frame["rgb"]))
        write_png(os.path.join(args.out_dir, "preview_feat.png"),
                  to8(frame["feat_rgb"]))
        write_png(os.path.join(args.out_dir,
                               f"preview_{args.render_mode}.png"), to8(buf))
        print(f"wrote previews to {args.out_dir}")
    return engine


if __name__ == "__main__":
    main()
