"""Photometric losses and image metrics (l1, l2, focal_l2, SSIM, PSNR).

Port of unipre3d_tpu/utils/losses.py. Images are channel-first
``[..., 3, H, W]``.
"""

from __future__ import annotations

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def focal_l2_loss(pred: torch.Tensor, gt: torch.Tensor, bg_color,
                  non_bg_rate: float, bg_rate: float) -> torch.Tensor:
    """L2 with per-pixel reweighting: background pixels (gt == bg_color in
    all channels, atol 1e-6) get ``bg_rate``, others ``non_bg_rate``, both
    normalized so the mean weight of a 50/50 image is 1.

    pred/gt: [B, 3, H, W]; bg_color: length-3.
    """
    bg = torch.as_tensor(bg_color, dtype=gt.dtype,
                         device=gt.device).reshape(1, 3, 1, 1)
    base = (pred - gt) ** 2
    is_bg = ((gt - bg).abs() <= 1e-6).all(dim=1, keepdim=True)
    normed_non_bg = 2.0 * non_bg_rate / (bg_rate + non_bg_rate)
    normed_bg = 2.0 * bg_rate / (bg_rate + non_bg_rate)
    weights = torch.where(is_bg, normed_bg, normed_non_bg)
    return (base * weights).mean()


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM with a ``window_size`` Gaussian window (sigma 1.5) applied per
    channel with zero "same" padding. img1/img2 [..., C, H, W] -> a scalar
    (``size_average``) or one value per image [...]."""
    lead = img1.shape[:-3]
    C, H, W = img1.shape[-3:]
    g1d = torch.from_numpy(_gaussian_window(window_size, 1.5)).to(img1.device)
    kernel = torch.outer(g1d, g1d)[None, None]               # [1, 1, k, k]
    pad = window_size // 2

    def dconv(x):
        y = torch.nn.functional.conv2d(x.reshape(-1, 1, H, W), kernel,
                                       padding=pad)
        return y.reshape(-1, C, H, W)

    x1 = img1.reshape(-1, C, H, W)
    x2 = img2.reshape(-1, C, H, W)
    mu1, mu2 = dconv(x1), dconv(x2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = dconv(x1 * x1) - mu1_sq
    sigma2_sq = dconv(x2 * x2) - mu2_sq
    sigma12 = dconv(x1 * x2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3)).reshape(lead)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR in dB over the full tensor (images in [0, 1])."""
    mse = ((pred - gt) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
