"""The render() entry point.

Port of instascene_tpu/render.py:63-232 (`render`): same key set, image maps
channels-last [H,W,C], same `viewer=` fast path, and `track_contrib=`
filling `gau_related_pixels` (render.py:181, :218). The pair-cap bookkeeping
of the TPU path (high-water caps, deferred overflow checks) is gone: the
binning sizes its buffers to the frame's pair total, so `n_dropped` is
always 0.

render() owns the API's options and the host-keyed ray cache; the model's
activations are `GaussianModel.raster_inputs` and the surface maps
`ops/depth_utils.surface_maps`, as in the geometry training step.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .ops.depth_utils import pixel_rays, surface_maps
from .ops.rasterize import CameraMats, RasterizeConfig, rasterize
from .utils.profiling import span


def camera_mats(cam, device) -> CameraMats:
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return CameraMats(w2v=f(cam.w2v), full_proj=f(cam.full_proj),
                      campos=f(cam.camera_center))


@lru_cache(maxsize=64)
def _cached_rays(width, height, tanfovx, tanfovy, c2w_rot_bytes, device):
    c2w_rot = np.frombuffer(c2w_rot_bytes, dtype=np.float32).reshape(3, 3)
    return pixel_rays(width, height, tanfovx, tanfovy,
                      torch.as_tensor(c2w_rot.copy(), device=device))


def render(viewpoint_camera, gaussians, pipe, bg_color,
           scaling_modifier: float = 1.0, override_color=None,
           norm_seg_feat: bool = True, track_contrib: bool = False,
           t_offset=None, cfg: Optional[RasterizeConfig] = None,
           viewer: bool = False) -> dict:
    """Render a view of `gaussians` (a models.gaussians.GaussianModel) on
    its device.

    Returns the JAX package's keys: render, radii, visibility_filter,
    seg_feature, gau_related_pixels, rend_alpha, rend_normal, rend_dist,
    surf_depth, surf_normal, rend_depth, rend_median_depth, final_T,
    n_contrib, n_dropped, gaussian_depth, T.

    viewer=True: forward-only fast path — only `render`, `rend_alpha` and
    `seg_feature` are meaningful; depth/normal/median/distortion outputs are
    zeros. track_contrib=True: forward-only full render whose
    `gau_related_pixels` is (contrib_ids, contrib_w) [H,W,10], each pixel's
    w > 0.1 contributors in blend order (K1 track). t_offset [N,3,3]: the
    densification tap (see ops.rasterize.rasterize). Differentiable through
    torch autograd and K2 unless viewer or track_contrib. Its span is
    "render" (utils/profiling.py)."""
    with span("render"):
        p = gaussians
        dev = p.device
        width = int(viewpoint_camera.width)
        height = int(viewpoint_camera.height)
        if cfg is None:
            cfg = RasterizeConfig(width=width, height=height,
                                  track_contrib=track_contrib,
                                  fwd_viewer=viewer)
        else:
            cfg = dataclasses.replace(
                cfg, width=width, height=height,
                track_contrib=track_contrib or cfg.track_contrib,
                fwd_viewer=viewer or cfg.fwd_viewer)

        cam = camera_mats(viewpoint_camera, dev)
        with span("model"):
            seg_feature = (p.seg_feature_normed() if norm_seg_feat
                           else p.seg_feature)
            colors = shs = None
            sh_degree = 0
            if override_color is None:
                shs = p.features()
                sh_degree = int(p.active_sh_degree)
            else:
                colors = override_color
            g = p.raster_inputs()
            scales = g.scales * scaling_modifier

        out = rasterize(g.xyz, scales, g.rotations, g.opacities, cam,
                        bg_color, cfg, colors=colors, shs=shs,
                        sh_degree=sh_degree, extras=seg_feature,
                        t_offset=t_offset, alive=p.alive)
        b = out.blend
        rend_alpha = b.alpha[..., None]
        common = {
            "render": b.color,
            "radii": out.radii,
            "visibility_filter": out.visible,
            "seg_feature": b.extra,
            # (contrib_ids, contrib_w) [H,W,10] with track_contrib, else None
            "gau_related_pixels": ((b.contrib_ids, b.contrib_w)
                                   if b.contrib_ids is not None else None),
            "rend_alpha": rend_alpha,
            "final_T": b.final_T,
            "n_contrib": b.n_contrib,
            "n_dropped": out.n_dropped,
            "gaussian_depth": out.depth,
            "T": out.T,
        }

        if cfg.fwd_viewer:
            z = torch.zeros_like(rend_alpha)
            z3 = torch.cat([z, z, z], dim=-1)
            return {**common, "rend_normal": z3, "rend_dist": z,
                    "surf_depth": z, "surf_normal": z3, "rend_depth": z,
                    "rend_median_depth": z}

        c2w_rot = np.ascontiguousarray(
            viewpoint_camera.c2w[:3, :3].astype(np.float32))
        rays = _cached_rays(width, height, float(viewpoint_camera.tanfovx),
                            float(viewpoint_camera.tanfovy), c2w_rot.tobytes(),
                            dev)
        normal, depth, median, surf_depth, surf_normal = surface_maps(
            b, cam.w2v, cam.campos, rays, getattr(pipe, "depth_ratio", 1.0))
        return {**common, "rend_normal": normal,
                "rend_dist": b.distortion[..., None],
                "surf_depth": surf_depth, "surf_normal": surf_normal,
                "rend_depth": depth, "rend_median_depth": median}
