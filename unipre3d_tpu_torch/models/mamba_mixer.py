"""Mamba sequence mixer (uni- and bi-directional).

Port of unipre3d_tpu/models/mamba_mixer.py (``SSMBranch``,
``MambaMixer``): in_proj -> (x, z); per direction a depthwise causal conv +
SiLU, the input-dependent (dt, B, C) from x_proj / dt_proj, the selective
scan (ops/scan.py, the hand-written kernel pair on the card) gated by
silu(z); out_proj. ``bimamba`` adds a second parameter set (``bwd``)
scanned over the flipped sequence, the outputs summed.

Dtypes as in flax (models/layers.py): the projections compute in
``dtype``; the float32 ``conv_weight`` meets the bfloat16 x and promotes
the conv to float32 (as ``causal_conv1d`` does in JAX); the scan is
float32; out_proj casts its float32 input back to ``dtype``. Parameters
keep the flax names (``conv_weight [K, D]``, ``conv_bias``, ``dt_bias``,
``A_log``, ``D``) and their flax initial values: A = log(1..N) per
channel, dt_bias the inverse softplus of a log-uniform dt in [1e-3, 0.1]
drawn from ``RandomState(0)``, D = 1.

Tensor parallelism (parallel/mesh.py ``replicate`` on a grid of M model
ranks): rank m keeps the channels [m d_inner/M, (m+1) d_inner/M) of both
x and z (``in_proj`` column parallel, each half split), their per-channel
parameters (``conv_weight``, ``conv_bias``, ``dt_proj``'s outputs,
``dt_bias``, ``A_log``, ``D``) and ``x_proj``'s inputs, and scans its own
channels. ``x_proj`` reads every channel, so its partial product goes
through ``sum_model``, whose backward sums too: dt, B and C feed the
rank's channels again. ``out_proj`` is row parallel (``reduce_from_model``);
the input goes through ``copy_to_model``. JAX splits only the two
projections and lets GSPMD compute the rest on whole channels; the sums
are the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.models.layers import F32, Dense, row_parallel
from unipre3d_tpu_torch.ops.scan import causal_conv1d, selective_scan
from unipre3d_tpu_torch.parallel.tensor import (copy_to_model, split_ranks,
                                                sum_model)


def a_log_init(d_inner: int, d_state: int) -> torch.Tensor:
    return torch.from_numpy(np.log(np.tile(
        np.arange(1, d_state + 1, dtype=np.float32), (d_inner, 1))))


def dt_bias_init(d_inner: int, dt_min=1e-3, dt_max=0.1,
                 floor=1e-4) -> torch.Tensor:
    dt = np.exp(np.random.RandomState(0).uniform(size=d_inner)
                * (math.log(dt_max) - math.log(dt_min))
                + math.log(dt_min)).clip(min=floor)
    return torch.from_numpy((dt + np.log(-np.expm1(-dt))).astype(np.float32))


class SSMBranch(nn.Module):
    """One scan direction: conv -> (dt, B, C) -> selective scan."""

    def __init__(self, d_inner: int, d_state: int = 16, d_conv: int = 4,
                 dt_rank: int = 24, dtype: torch.dtype = F32):
        super().__init__()
        self.d_state, self.dt_rank = d_state, dt_rank
        self.conv_weight = nn.Parameter(torch.zeros(d_conv, d_inner))
        self.conv_bias = nn.Parameter(torch.zeros(d_inner))
        self.x_proj = Dense(d_inner, dt_rank + 2 * d_state, bias=False,
                            dtype=dtype)
        self.dt_proj = Dense(dt_rank, d_inner, bias=False, dtype=dtype)
        self.dt_bias = nn.Parameter(dt_bias_init(d_inner))
        self.A_log = nn.Parameter(a_log_init(d_inner, d_state))
        self.D = nn.Parameter(torch.ones(d_inner))

    def flax_init(self, generator: torch.Generator) -> None:
        """flax's lecun-normal ``conv_weight`` (fan-in K, the leading axis
        of [K, D]); the other parameters keep their constructed values."""
        w = self.conv_weight
        std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
        w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), std=std,
                                      a=-2 * std, b=2 * std,
                                      generator=generator))

    def forward(self, x, z):
        """x, z [B, L, d_inner] -> y [B, L, d_inner] float32 (gated)."""
        x = F.silu(causal_conv1d(x, self.conv_weight, self.conv_bias))
        proj = self.x_proj(x)
        if split_ranks(self.x_proj, 1) > 1:
            proj = sum_model(proj)
        dt, B, C = torch.split(proj,
                               [self.dt_rank, self.d_state, self.d_state], -1)
        dt = self.dt_proj(dt)
        A = -torch.exp(self.A_log.float())
        return selective_scan(x, dt, A, B, C, D=self.D, z=z,
                              delta_bias=self.dt_bias, delta_softplus=True)


class MambaMixer(nn.Module):
    """x [B, L, d_model] -> [B, L, d_model]."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, bimamba: bool = True,
                 dtype: torch.dtype = F32):
        super().__init__()
        d_inner = expand * d_model
        dt_rank = math.ceil(d_model / 16)
        self.dtype, self.bimamba = dtype, bimamba
        self.in_proj = Dense(d_model, 2 * d_inner, bias=False, dtype=dtype)
        self.fwd = SSMBranch(d_inner, d_state, d_conv, dt_rank, dtype)
        if bimamba:
            self.bwd = SSMBranch(d_inner, d_state, d_conv, dt_rank, dtype)
        self.out_proj = Dense(d_inner, d_model, bias=False, dtype=dtype)

    def forward(self, x):
        tp = split_ranks(self.in_proj, 0)
        if tp > 1:
            x = copy_to_model(x)
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        y = self.fwd(xs, z)
        if self.bimamba:
            y = y + self.bwd(xs.flip(1), z.flip(1)).flip(1)
        return row_parallel(self.out_proj, y.to(self.dtype), tp)
