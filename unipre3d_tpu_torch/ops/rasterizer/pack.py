"""Packed Gaussian table shared by the splat kernels.

Port of the packing part of unipre3d_tpu/ops/rasterizer/pallas_splat.py
(``_pack`` and the compositing constants, :40-62).
"""

from __future__ import annotations

import math

import torch

T_EPS = 1e-4             # transmittance stop: T after a gaussian >= T_EPS
LOG_T_EPS = math.log(T_EPS)
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
ROWS = 16  # packed rows: mx my ca cb cc opa r g b (9 used)


def pack(mean2d, conic, color, opacity, n_pad: int) -> torch.Tensor:
    """[..., N, ...] gaussian tensors -> [..., 16, n_pad] packed f32;
    padding columns have opacity 0 (a no-op). Differentiable: the
    gradient of the table flows back to its inputs."""
    n = opacity.shape[-1]
    rows = torch.cat([mean2d.transpose(-1, -2), conic.transpose(-1, -2),
                      opacity.unsqueeze(-2), color.transpose(-1, -2)],
                     dim=-2).float()                           # [..., 9, N]
    return torch.nn.functional.pad(rows, (0, n_pad - n, 0, ROWS - 9))
