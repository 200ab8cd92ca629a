"""Plain reference of the LPIPS distance (VGG16 variant), a frozen copy of
the port's utils/lpips.py: the lpips scaling layer, torchvision's VGG16
trunk tapped at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, features
unit-normalised over channels, non-negative per-channel weights, spatial
mean, sum over the taps. Float32, as the program's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

VGG_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
VGG_CHANNELS = ((64, 64), (128, 128), (256, 256, 256),
                (512, 512, 512), (512, 512, 512))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for idxs, chans in zip(VGG_SLICES, VGG_CHANNELS):
            for idx, ch in zip(idxs, chans):
                self.add_module(f"conv{idx}", nn.Conv2d(cin, ch, 3, padding=1,
                                                        device="meta"))
                cin = ch

    def forward(self, x):
        shift = torch.tensor(SHIFT, device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor(SCALE, device=x.device).view(1, 3, 1, 1)
        h = (x - shift) / scale
        taps = []
        for si, idxs in enumerate(VGG_SLICES):
            if si > 0:
                h = F.max_pool2d(h, 2, 2)
            for idx in idxs:
                h = F.relu(getattr(self, f"conv{idx}")(h))
            taps.append(h)
        return taps


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, chans in enumerate(VGG_CHANNELS):
            setattr(self, f"lin{i}", nn.Parameter(
                torch.empty(chans[-1], device="meta")))

    def forward(self, x, y):
        """x, y [N, 3, H, W] in [-1, 1] -> distances [N]; no gradient to
        ``y``."""
        fx = self.vgg(x)
        with torch.no_grad():
            fy = self.vgg(y)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            w = torch.clamp_min(getattr(self, f"lin{i}"), 0.0)
            total = total + torch.einsum("bchw,c->bhw", (a - b) ** 2,
                                         w).mean(dim=(1, 2))
        return total
