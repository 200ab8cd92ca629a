"""AutoencoderKL (SD-VAE), the frozen 2D texture encoder.

Port of unipre3d_tpu/models/vae.py. Module names are diffusers' own
(``encoder.down_blocks.0.resnets.0.conv1`` ...), as in the torch modules of
tests/test_vae_torch_parity.py, so a published sd-vae-ft-mse state dict
loads as it is. The forward runs encode -> posterior mode -> decode and
returns every decoder up-block output (``decoder_block_{i}``, NCHW) and the
reconstruction under ``sample``; the fusion path consumes
``decoder_block_3``.

``dtype`` is the compute dtype, with the flax semantics of the JAX module
(unipre3d_tpu/models/vae.py:30-92): convolutions and linear layers cast
their input, weight and bias to it (on the card, the cuDNN bf16 path);
GroupNorm computes its statistics and affine in float32 and returns
``dtype``; the attention softmax runs in float32. The parameters stay
float32. At float32 every cast is the identity.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.models.layers import F32, Dense, maybe_cast

GN_EPS = 1e-6


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(dtype=)``: input, weight and bias cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = F32):
        super().__init__(cin, cout, k, stride=stride, padding=padding)
        self.dtype = dtype

    def forward(self, x):
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                                  maybe_cast(self.bias, self.dtype))


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-6, dtype=)``:
    statistics and affine in float32, the output in ``dtype``."""

    def __init__(self, ch: int, dtype: torch.dtype = F32):
        super().__init__(32, ch, eps=GN_EPS)
        self.dtype = dtype

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(self.dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype = F32):
        super().__init__()
        self.norm1 = GroupNorm(cin, dtype)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(cout, dtype)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, dtype=dtype)
        self.conv_shortcut = Conv2d(cin, cout, 1, dtype=dtype) \
            if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        sc = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return sc + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (diffusers mid-block)."""

    def __init__(self, c: int, dtype: torch.dtype = F32):
        super().__init__()
        self.group_norm = GroupNorm(c, dtype)
        self.to_q = Dense(c, c, dtype=dtype)
        self.to_k = Dense(c, c, dtype=dtype)
        self.to_v = Dense(c, c, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(c, c, dtype=dtype)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = (q @ k.transpose(1, 2)) * C ** -0.5
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        h = self.to_out[0](attn @ v)
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class MidBlock(nn.Module):
    def __init__(self, c: int, dtype: torch.dtype = F32):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, c, dtype),
                                      ResnetBlock2D(c, c, dtype)])
        self.attentions = nn.ModuleList([AttnBlock(c, dtype)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Conv(nn.Module):
    """Holder of a ``conv`` submodule (diffusers' down/upsampler naming)."""

    def __init__(self, c: int, stride: int, padding: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=stride, padding=padding,
                           dtype=dtype)


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, last: bool,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, dtype)
             for j in range(layers)])
        self.downsamplers = None if last else nn.ModuleList(
            [_Conv(cout, stride=2, padding=0, dtype=dtype)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            # diffusers' asymmetric (0, 1) padding before the stride-2 conv
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, last: bool,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, dtype)
             for j in range(layers + 1)])
        self.upsamplers = None if last else nn.ModuleList(
            [_Conv(cout, stride=1, padding=1, dtype=dtype)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = self.upsamplers[0].conv(x)
        return x


class Encoder(nn.Module):
    def __init__(self, chans: Sequence[int], layers: int, latent: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.conv_in = Conv2d(3, chans[0], 3, padding=1, dtype=dtype)
        self.down_blocks = nn.ModuleList(
            [DownBlock(chans[max(i - 1, 0)], c, layers, i == len(chans) - 1,
                       dtype)
             for i, c in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1], dtype)
        self.conv_norm_out = GroupNorm(chans[-1], dtype)
        self.conv_out = Conv2d(chans[-1], 2 * latent, 3, padding=1,
                               dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for b in self.down_blocks:
            x = b(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, chans: Sequence[int], layers: int, latent: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        rev = list(reversed(chans))
        self.conv_in = Conv2d(latent, rev[0], 3, padding=1, dtype=dtype)
        self.mid_block = MidBlock(rev[0], dtype)
        self.up_blocks = nn.ModuleList(
            [UpBlock(rev[max(i - 1, 0)], c, layers, i == len(rev) - 1, dtype)
             for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1], dtype)
        self.conv_out = Conv2d(rev[-1], 3, 3, padding=1, dtype=dtype)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        feats = {}
        for i, b in enumerate(self.up_blocks):
            x = b(x)
            feats[f"decoder_block_{i}"] = x
        return self.conv_out(F.silu(self.conv_norm_out(x))), feats


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 dtype: torch.dtype = F32):
        super().__init__()
        chans = tuple(block_out_channels)
        self.latent, self.dtype = latent_channels, dtype
        self.encoder = Encoder(chans, layers_per_block, latent_channels, dtype)
        self.decoder = Decoder(chans, layers_per_block, latent_channels, dtype)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1,
                                 dtype=dtype)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1,
                                      dtype=dtype)

    def forward(self, images):
        """images [B, 3, H, W] -> {"decoder_block_i": [B, C, h, w], ...,
        "sample": [B, 3, H, W]}, in the compute dtype."""
        moments = self.quant_conv(self.encoder(images.to(self.dtype)))
        z = self.post_quant_conv(moments[:, :self.latent])  # posterior mode
        sample, feats = self.decoder(z)
        feats["sample"] = sample
        return feats
