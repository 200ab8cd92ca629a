"""AutoencoderKL (SD-VAE), the frozen 2D texture encoder.

Port of unipre3d_tpu/models/vae.py. Module names are diffusers' own
(``encoder.down_blocks.0.resnets.0.conv1`` ...), as in the torch modules of
tests/test_vae_torch_parity.py, so a published sd-vae-ft-mse state dict
loads as it is. The forward runs encode -> posterior mode -> decode and
returns every decoder up-block output (``decoder_block_{i}``, NCHW) and the
reconstruction under ``sample``; the fusion path consumes
``decoder_block_3``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

GN_EPS = 1e-6


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=GN_EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, cout, eps=GN_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        sc = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return sc + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (diffusers mid-block)."""

    def __init__(self, c: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, c, eps=GN_EPS)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax((q @ k.transpose(1, 2)) * C ** -0.5, dim=-1)
        h = self.to_out[0](attn @ v)
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class MidBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, c), ResnetBlock2D(c, c)])
        self.attentions = nn.ModuleList([AttnBlock(c)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Conv(nn.Module):
    """Holder of a ``conv`` submodule (diffusers' down/upsampler naming)."""

    def __init__(self, c: int, stride: int, padding: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=stride, padding=padding)


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, last: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout)
             for j in range(layers)])
        self.downsamplers = None if last else nn.ModuleList(
            [_Conv(cout, stride=2, padding=0)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            # diffusers' asymmetric (0, 1) padding before the stride-2 conv
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, last: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout)
             for j in range(layers + 1)])
        self.upsamplers = None if last else nn.ModuleList(
            [_Conv(cout, stride=1, padding=1)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = self.upsamplers[0].conv(x)
        return x


class Encoder(nn.Module):
    def __init__(self, chans: Sequence[int], layers: int, latent: int):
        super().__init__()
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [DownBlock(chans[max(i - 1, 0)], c, layers, i == len(chans) - 1)
             for i, c in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1])
        self.conv_norm_out = nn.GroupNorm(32, chans[-1], eps=GN_EPS)
        self.conv_out = nn.Conv2d(chans[-1], 2 * latent, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for b in self.down_blocks:
            x = b(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, chans: Sequence[int], layers: int, latent: int):
        super().__init__()
        rev = list(reversed(chans))
        self.conv_in = nn.Conv2d(latent, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0])
        self.up_blocks = nn.ModuleList(
            [UpBlock(rev[max(i - 1, 0)], c, layers, i == len(rev) - 1)
             for i, c in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(32, rev[-1], eps=GN_EPS)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        feats = {}
        for i, b in enumerate(self.up_blocks):
            x = b(x)
            feats[f"decoder_block_{i}"] = x
        return self.conv_out(F.silu(self.conv_norm_out(x))), feats


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        chans = tuple(block_out_channels)
        self.latent = latent_channels
        self.encoder = Encoder(chans, layers_per_block, latent_channels)
        self.decoder = Decoder(chans, layers_per_block, latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def forward(self, images):
        """images [B, 3, H, W] -> {"decoder_block_i": [B, C, h, w], ...,
        "sample": [B, 3, H, W]}."""
        moments = self.quant_conv(self.encoder(images))
        z = self.post_quant_conv(moments[:, :self.latent])  # posterior mode
        sample, feats = self.decoder(z)
        feats["sample"] = sample
        return feats
