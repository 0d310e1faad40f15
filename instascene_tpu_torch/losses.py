"""Training losses: L1, L2, cosine, SSIM, PSNR, the photometric loss and
edge-aware smoothness.

Port of instascene_tpu/losses.py:16-115 (`l1_loss`, `l2_loss`, `cos_loss`,
`ssim`, `psnr`, `photometric_loss`, `smooth_loss`): SSIM with an 11×11 gaussian window (σ 1.5),
C1 = 0.01², C2 = 0.03², zero-padded SAME blurs, as the reference's
F.conv2d. Here the separable blur is two depthwise convolutions, run
without TF32 (cuDNN's default would round the inputs to ~3 digits).
Images are channels-last [H, W, C].
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, gt):
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred, gt):
    return torch.mean((pred - gt) ** 2)


def cos_loss(pred, gt):
    """1 − the per-pixel dot product over the last (channel) axis,
    averaged."""
    return torch.mean(1.0 - torch.sum(pred * gt, dim=-1))


@functools.lru_cache()
def _window_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2)).astype(np.float64)
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Separable gaussian blur of [H, W, C] with zero padding (SAME)."""
    c = img.shape[-1]
    g = torch.as_tensor(_window_1d(window_size), device=img.device)
    x = img.permute(2, 0, 1)[None]                       # [1, C, H, W]
    pad = window_size // 2
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1),
                     padding=(pad, 0), groups=c)
        x = F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1),
                     padding=(0, pad), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over the image; the five blurred statistics (x, y, x², y²,
    xy) are stacked on the channel axis and blurred together."""
    c = img1.shape[-1]
    b = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                        dim=-1), window_size)
    mu1, mu2 = b[..., :c], b[..., c:2 * c]
    m11, m22, m12 = b[..., 2 * c:3 * c], b[..., 3 * c:4 * c], b[..., 4 * c:]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    return torch.mean(ssim_map)


def psnr(img1, img2):
    mse = torch.mean((img1 - img2) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))


def photometric_loss(image, gt_image, lambda_dssim: float):
    """((1 − λ)·L1 + λ·(1 − SSIM), L1)."""
    ll1 = l1_loss(image, gt_image)
    return ((1.0 - lambda_dssim) * ll1
            + lambda_dssim * (1.0 - ssim(image, gt_image)), ll1)


def smooth_loss(disp, img):
    """Edge-aware disparity smoothness (reference loss_utils.py:35-42).
    disp [H,W,1] or [H,W]; img [H,W,3] channels-last."""
    d = disp[..., 0] if disp.dim() == 3 else disp
    gdx = torch.abs(d[1:-1, :-2] + d[1:-1, 2:] - 2 * d[1:-1, 1:-1])
    gdy = torch.abs(d[:-2, 1:-1] + d[2:, 1:-1] - 2 * d[1:-1, 1:-1])
    gix = torch.mean(torch.abs(img[1:-1, :-2] - img[1:-1, 2:]), dim=-1) * 0.5
    giy = torch.mean(torch.abs(img[:-2, 1:-1] - img[2:, 1:-1]), dim=-1) * 0.5
    return (torch.mean(gdx * torch.exp(-gix))
            + torch.mean(gdy * torch.exp(-giy)))
