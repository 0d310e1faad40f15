"""Configuration dataclasses with the reference's CLI flags.

Port of instascene_tpu/config.py:18-203 (`ModelParams`,
`OptimizationParams`, `PipelineParams`, the argparse bridge,
`save_cfg_args`, `get_combined_args`): the same flag names, shorthands and
defaults, so a command line of the root train.py runs the port unchanged.
Two fields are kept only so that such command lines parse: `data_device`
(placement follows the trainer's `device`) and `rasterizer_impl` (the port
has one rasterizer: its kernels on the GPU, their plain versions on the
CPU).
"""

from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelParams:
    """Dataset / model loading parameters."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "tpu"  # parsed and ignored (see the module docstring)
    eval: bool = False
    render_items: List[str] = field(default_factory=lambda: [
        'RGB', 'Alpha', 'Normal', 'Depth', 'Edge', 'Curvature'])
    w_normal_prior: Optional[str] = None  # e.g. "stablenormal_normals"
    segmap_dir: str = "sam/mask"
    use_seg_feature: bool = False
    seg_feat_dim: int = 16
    load_seg_feat: bool = False
    load_filter_segmap: bool = False
    preload_robust_semantic: str = ""

    SHORTHANDS = {"source_path": "s", "model_path": "m", "images": "i",
                  "resolution": "r", "white_background": "w"}

    @classmethod
    def add_to_parser(cls, parser: ArgumentParser, sentinel: bool = False):
        _add_bridge(parser, cls, "Loading Parameters", cls.SHORTHANDS,
                    sentinel)

    @classmethod
    def extract(cls, args: Namespace) -> "ModelParams":
        out = _extract(cls, args)
        out.source_path = os.path.abspath(out.source_path)
        return out


@dataclass
class PipelineParams:
    """Render pipeline parameters: surf_depth mixes expected and median
    depth by depth_ratio (1 = median only, the reference default)."""
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    depth_ratio: float = 1.0
    debug: bool = False
    rasterizer_impl: str = "auto"  # parsed and ignored (module docstring)

    SHORTHANDS = {}

    @classmethod
    def add_to_parser(cls, parser: ArgumentParser):
        _add_bridge(parser, cls, "Pipeline Parameters", {})

    @classmethod
    def extract(cls, args: Namespace) -> "PipelineParams":
        return _extract(cls, args)


@dataclass
class OptimizationParams:
    """Optimization parameters (the semantic-step fields are read by the
    semantic trainer of a later slice)."""
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    seg_feature_lr: float = 0.025
    sample_batchsize: int = 32 * 1024
    sample_mv_frames: int = 5
    mv_tile_subsample: int = 0
    mv_merged: int = 0
    sparse_px: int = 0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal: float = 0.05
    lambda_normal_prior: float = 0.25
    lambda_mask: float = 0.1
    opacity_cull: float = 0.05
    lambda_singview_contras: float = 1e-6
    lambda_multiview_contras: float = 1e-6
    lambda_3D_contras: float = 2.5e-6
    gram_feat_3d: bool = False
    consider_negative_labels: bool = False
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002

    SHORTHANDS = {}

    @classmethod
    def add_to_parser(cls, parser: ArgumentParser):
        _add_bridge(parser, cls, "Optimization Parameters", {})

    @classmethod
    def extract(cls, args: Namespace) -> "OptimizationParams":
        return _extract(cls, args)


def _add_bridge(parser: ArgumentParser, cls, group_name: str, shorthands: dict,
                fill_none: bool = False) -> None:
    """Register dataclass fields as argparse flags (bools become
    store_true)."""
    group = parser.add_argument_group(group_name)
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        else:
            default = f.default_factory()
        if fill_none:
            default = None
        flags = ["--" + f.name]
        if f.name in shorthands:
            flags.append("-" + shorthands[f.name])
        ann = f.type if isinstance(f.type, str) else getattr(
            f.type, "__name__", str(f.type))
        if ann == "bool":
            group.add_argument(*flags, default=default, action="store_true")
        elif ann.startswith("List"):
            group.add_argument(*flags, default=default, nargs="+", type=str)
        elif ann == "int":
            group.add_argument(*flags, default=default, type=int)
        elif ann == "float":
            group.add_argument(*flags, default=default, type=float)
        else:
            group.add_argument(*flags, default=default, type=str)


def _extract(cls, args: Namespace):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if hasattr(args, f.name) and getattr(args, f.name) is not None:
            kwargs[f.name] = getattr(args, f.name)
    return cls(**kwargs)


def save_cfg_args(model_path: str, args: Namespace) -> None:
    """Write cfg_args in the reference's repr'd-Namespace format."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(Namespace(**vars(args))))


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge a model's saved cfg_args with the command line (the command
    line wins where it gives a value)."""
    import sys
    cmdline = sys.argv[1:] if argv is None else argv
    args_cmdline = parser.parse_args(cmdline)
    cfgfile_string = "Namespace()"
    try:
        cfgfilepath = os.path.join(args_cmdline.model_path, "cfg_args")
        with open(cfgfilepath) as cfg_file:
            cfgfile_string = cfg_file.read()
    except (TypeError, FileNotFoundError):
        pass
    args_cfgfile = eval(cfgfile_string)  # noqa: S307 - the reference's format
    merged = vars(args_cfgfile).copy()
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
