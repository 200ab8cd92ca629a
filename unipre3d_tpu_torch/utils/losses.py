"""Photometric losses and PSNR.

Port of unipre3d_tpu/utils/losses.py (``l1_loss``, ``l2_loss``,
``focal_l2_loss``, ``psnr``). Images are channel-first ``[..., 3, H, W]``.
"""

from __future__ import annotations

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


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR in dB over the full tensor (images in [0, 1])."""
    mse = ((pred - gt) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
