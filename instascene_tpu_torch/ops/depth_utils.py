"""Rays, depth map → world points → pseudo surface normal, and the
surface maps a render derives from its blend.

Port of instascene_tpu/ops/depth_utils.py (the camera rays,
`depths_to_points`, `depth_to_normal`): image center W/2 and rays through
integer pixel coordinates, as the JAX package keeps them. render() and the
geometry training step share `pixel_rays` and `surface_maps`.
"""

from __future__ import annotations

import torch


def pixel_rays(width: int, height: int, tanfovx: float, tanfovy: float,
               c2w_rot: torch.Tensor) -> torch.Tensor:
    """Per-pixel world ray directions [H,W,3] (unnormalized) through
    integer pixel coordinates, image centre W/2, on c2w_rot's device."""
    dev = c2w_rot.device
    fx = width / (2 * tanfovx)
    fy = height / (2 * tanfovy)
    x = (torch.arange(width, dtype=torch.float32, device=dev) - width / 2) / fx
    y = (torch.arange(height, dtype=torch.float32, device=dev)
         - height / 2) / fy
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return (xx[..., None] * c2w_rot[:, 0] + yy[..., None] * c2w_rot[:, 1]
            + c2w_rot[:, 2])


def depths_to_points(depth: torch.Tensor, rays_world: torch.Tensor,
                     cam_center: torch.Tensor) -> torch.Tensor:
    """depth [H,W] → world points [H,W,3]: p = depth * ray + origin."""
    return depth[..., None] * rays_world + cam_center[None, None, :]


def depth_to_normal(depth: torch.Tensor, rays_world: torch.Tensor,
                    cam_center: torch.Tensor) -> torch.Tensor:
    """Normal from central differences of the unprojected points; zero on
    the 1-px border. [H,W,3]."""
    pts = depths_to_points(depth, rays_world, cam_center)
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    nrm = torch.stack([dx[..., 1] * dy[..., 2] - dx[..., 2] * dy[..., 1],
                       dx[..., 2] * dy[..., 0] - dx[..., 0] * dy[..., 2],
                       dx[..., 0] * dy[..., 1] - dx[..., 1] * dy[..., 0]],
                      dim=-1)
    nrm = nrm * torch.rsqrt(torch.sum(nrm * nrm, dim=-1, keepdim=True)
                            + 1e-24)
    return torch.nn.functional.pad(nrm, (0, 0, 1, 1, 1, 1))


def surface_maps(blend, w2v: torch.Tensor, campos: torch.Tensor,
                 rays: torch.Tensor, depth_ratio: float):
    """The maps a render derives from its blend (ops/rasterize.BlendOut),
    channels-last, for the camera w2v [4,4] at campos [3] with pixel_rays
    `rays`: (rend_normal [H,W,3] in the world frame, expected depth
    [H,W,1] (0 where alpha is), median depth [H,W,1], surf_depth = their
    mix by depth_ratio, surf_normal [H,W,3] = its normal times the
    detached alpha)."""
    R = w2v[:3, :3]     # world-frame normal: n_world = R_view^T n_view
    rend_normal = (blend.normal[..., 0:1] * R[0]
                   + blend.normal[..., 1:2] * R[1]
                   + blend.normal[..., 2:3] * R[2])
    alpha = blend.alpha[..., None]
    alpha_ok = alpha > 0
    depth_exp = torch.where(
        alpha_ok, blend.depth[..., None] / torch.where(alpha_ok, alpha, 1.0),
        0.0)
    depth_med = torch.nan_to_num(blend.median_depth[..., None], 0.0)
    surf_depth = depth_exp * (1 - depth_ratio) + depth_ratio * depth_med
    surf_normal = depth_to_normal(surf_depth[..., 0], rays, campos)
    return (rend_normal, depth_exp, depth_med, surf_depth,
            surf_normal * alpha.detach())
