"""TensorBoard logging, used when torch.utils.tensorboard is importable.

Port of instascene_tpu/utils/tb.py (`maybe_summary_writer`,
`log_train_scalars`, `log_eval_scalars`, `_colormap`, `log_eval_images`):
the same tags, values and images, the depth and distortion maps coloured
by utils/colormaps.py's turbo table in place of matplotlib. The writer is
optional exactly as in the reference (train.py:26-31): without tensorboard
the CLI logs to stdout only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def maybe_summary_writer(log_dir: str):
    """A torch SummaryWriter on `log_dir`, or None when unavailable."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("Tensorboard not available: not logging progress")
        return None
    return SummaryWriter(log_dir)


def log_train_scalars(writer: Optional[object], it: int, metrics: dict,
                      elapsed_s: float) -> None:
    """Per-iteration scalars (reference train.py:218-221)."""
    if writer is None:
        return
    writer.add_scalar("train_loss_patches/l1_loss", float(metrics["ll1"]), it)
    writer.add_scalar("train_loss_patches/total_loss",
                      float(metrics["loss"]), it)
    writer.add_scalar("train_loss_patches/dist_loss",
                      float(metrics["dist"]), it)
    writer.add_scalar("train_loss_patches/normal_loss",
                      float(metrics["normal"]), it)
    writer.add_scalar("iter_time", elapsed_s * 1e3, it)


def log_eval_scalars(writer: Optional[object], it: int, split: str,
                     l1: float, psnr: float, n_points: int) -> None:
    """Evaluation scalars (reference train.py:254-272)."""
    if writer is None:
        return
    writer.add_scalar(f"{split}/loss_viewpoint - l1_loss", l1, it)
    writer.add_scalar(f"{split}/loss_viewpoint - psnr", psnr, it)
    writer.add_scalar("total_points", n_points, it)


def _colormap(img) -> np.ndarray:
    """[H,W] → [H,W,3] float32: min-max normalized, through turbo."""
    from .colormaps import TURBO, lookup
    img = np.asarray(img, dtype=np.float32)
    lo, hi = float(img.min()), float(img.max())
    return lookup(TURBO, (img - lo) / (hi - lo + 1e-12)).astype(np.float32)


def log_eval_images(writer: Optional[object], it: int, split: str,
                    view_name: str, maps: dict, with_gt: bool = False) -> None:
    """Per-view evaluation images (reference train.py:236-267): render,
    turbo depth and distortion, rendered and surface normals, alpha (and
    the ground truth with with_gt). `maps` is an eval_step result
    (channels-last tensors)."""
    if writer is None:
        return
    from .image import as_numpy

    def chw(x):   # [H,W,C] float → [1,C,H,W] for add_images
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 2:
            x = x[..., None]
        return np.clip(np.transpose(x, (2, 0, 1))[None], 0.0, 1.0)

    m = {k: as_numpy(v) for k, v in maps.items() if v is not None}
    base = f"{split}_view_{view_name}"
    writer.add_images(f"{base}/render", chw(m["image"]), global_step=it)
    depth = m["surf_depth"][..., 0]
    writer.add_images(f"{base}/depth",
                      chw(_colormap(depth / (depth.max() + 1e-12))),
                      global_step=it)
    writer.add_images(f"{base}/rend_normal",
                      chw(m["rend_normal"] * 0.5 + 0.5), global_step=it)
    writer.add_images(f"{base}/surf_normal",
                      chw(m["surf_normal"] * 0.5 + 0.5), global_step=it)
    writer.add_images(f"{base}/rend_alpha", chw(m["rend_alpha"]),
                      global_step=it)
    writer.add_images(f"{base}/rend_dist", chw(_colormap(m["rend_dist"])),
                      global_step=it)
    if with_gt and "gt" in m:
        writer.add_images(f"{base}/ground_truth", chw(m["gt"]),
                          global_step=it)
