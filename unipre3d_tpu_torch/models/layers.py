"""Building blocks of the point backbone.

Port of unipre3d_tpu/models/layers.py: ``Mlp``, ``Attention``, ``DropPath``,
``Block`` (pre-LN) and ``PointGroupEncoder`` (mini-PointNet). Module and
attribute names follow the flax parameter paths so that weights convert by
rule (unipre3d_tpu_torch/weights.py). Two flax conventions are kept:

* LayerNorm eps is 1e-6 (torch's default is 1e-5);
* BatchNorm (``FlaxBatchNorm``) normalizes by the biased batch variance and
  updates its running stats with flax momentum 0.99 and the *biased*
  variance (torch's ``BatchNorm`` would use momentum 0.01 and the unbiased
  one).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-6


class Mlp(nn.Module):
    """Linear -> GELU (exact) -> Linear."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head self-attention, qkv without bias; plain matmul + softmax
    in float32, as the JAX version."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd)
        q, k, v = qkv.unbind(2)                                   # [B,N,H,D]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (hd ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        return self.proj(out)


def drop_path(x, rate: float, generator, training: bool):
    """Per-sample stochastic depth; the keep mask is drawn from the explicit
    ``generator``."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, generator=None):
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path,
                          generator, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path,
                             generator, self.training)


class FlaxBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with flax semantics: batch
    stats from E[x^2] - E[x]^2 (clamped at 0), eps 1e-5, and running
    stats ``ra = 0.99 ra + 0.01 batch`` with the biased variance. In eval
    mode it normalizes by the running stats."""

    def __init__(self, ch: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if self.training:
            flat = x.reshape(-1, x.shape[-1]).float()
            mean = flat.mean(0)
            var = torch.clamp_min((flat * flat).mean(0) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class PointGroupEncoder(nn.Module):
    """Mini-PointNet over local groups: [B, G, K, 3] -> [B, G, C]."""

    def __init__(self, encoder_channel: int):
        super().__init__()
        self.encoder_channel = encoder_channel
        self.conv1 = nn.Linear(3, 128)
        self.bn1 = FlaxBatchNorm(128)
        self.conv2 = nn.Linear(128, 256)
        self.conv3 = nn.Linear(512, 512)
        self.bn2 = FlaxBatchNorm(512)
        self.conv4 = nn.Linear(512, encoder_channel)

    def forward(self, point_groups):
        B, G, K, _ = point_groups.shape
        x = point_groups.reshape(B * G, K, 3)
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)
        g = x.amax(dim=1, keepdim=True)
        x = torch.cat([g.expand_as(x), x], dim=-1)
        x = F.relu(self.bn2(self.conv3(x)))
        x = self.conv4(x).amax(dim=1)
        return x.reshape(B, G, self.encoder_channel)
