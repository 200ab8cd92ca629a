"""Building blocks of the point backbone.

Port of unipre3d_tpu/models/layers.py: ``Mlp``, ``Attention``, ``DropPath``,
``Block`` (pre-LN) and ``PointGroupEncoder`` (mini-PointNet), with flax's
``RMSNorm`` beside them. Module and attribute names follow the flax
parameter paths so that weights convert by rule
(unipre3d_tpu_torch/weights.py). Three flax conventions are kept:

* LayerNorm eps is 1e-6 (torch's default is 1e-5);
* BatchNorm (``FlaxBatchNorm``) normalizes by the biased batch variance and
  updates its running stats with flax momentum 0.99 and the *biased*
  variance (torch's ``BatchNorm`` would use momentum 0.01 and the unbiased
  one);
* every module takes a compute ``dtype`` with flax's semantics, the
  parameters staying float32: ``Dense`` casts its input, weight and bias
  to ``dtype`` and returns ``dtype``; ``LayerNorm`` and ``FlaxBatchNorm``
  compute their statistics and affine in float32 and return ``dtype``
  (BatchNorm's running stats stay float32); attention takes its products
  in ``dtype`` and its softmax in float32. The residual stream is then in
  ``dtype``. ``torch.autocast`` would not give these dtypes: its policy
  returns float32 from ``layer_norm`` and ``softmax``. At float32 every
  cast is the identity and the modules compute what ``nn.Linear`` and
  ``nn.LayerNorm`` do.

Under several processes (parallel/distributed.py), inside ``synced()``
BatchNorm takes its statistics over the global batch (its sums all-reduced
over the data group, with their gradient) and DropPath draws the global
batch's per-sample mask and keeps this rank's rows, as the JAX step over a
data-sharded batch does.

Tensor parallelism (parallel/mesh.py ``replicate`` on a grid of M model
ranks): ``Attention`` keeps heads [m H/M, (m+1) H/M) of q, k and v
(``qkv`` column parallel, split head-aligned) and a row-parallel ``proj``;
``Mlp`` a column-parallel ``fc1`` (its bias split) and a row-parallel
``fc2``. The replicated input goes through ``copy_to_model``, the
row-parallel partial sums through ``reduce_from_model``, and the
replicated bias of ``proj`` and ``fc2`` is added once after the sum
(``row_parallel``), where GSPMD puts the same collectives in JAX.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.parallel.distributed import (global_rows,
                                                     sum_across_ranks,
                                                     sync_world)
from unipre3d_tpu_torch.parallel.tensor import (copy_to_model,
                                                reduce_from_model,
                                                split_ranks)

LN_EPS = 1e-6
F32 = torch.float32


def maybe_cast(t, dtype):
    return None if t is None else t.to(dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=)``: input, weight and bias cast to ``dtype``
    (the compute dtype, not the parameters' own, which stay float32; their
    gradients come back float32), the product and the output in it."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = F32):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        maybe_cast(self.bias, self.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=)``, eps 1e-6: statistics and affine in
    float32, the output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = F32):
        super().__init__(dim, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(epsilon=, dtype=)``: x * (rsqrt(mean(x^2) + eps) *
    scale) in float32, the output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        mul = torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * self.weight
        return (x * mul).to(self.dtype)


def row_parallel(dense: Dense, x: torch.Tensor, tp: int) -> torch.Tensor:
    """``dense(x)`` for a row-parallel ``dense`` split over ``tp`` model
    ranks: the partial product summed over the model group, then the
    replicated bias added once. ``dense(x)`` itself when ``tp`` is 1.
    GSPMD stands in its place in JAX."""
    if tp == 1:
        return dense(x)
    y = reduce_from_model(F.linear(x.to(dense.dtype),
                                   dense.weight.to(dense.dtype)))
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


class Mlp(nn.Module):
    """Linear -> GELU (exact) -> Linear."""

    def __init__(self, dim: int, hidden: int, out: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out, dtype=dtype)

    def forward(self, x):
        tp = split_ranks(self.fc1, 0)
        if tp > 1:
            x = copy_to_model(x)
        return row_parallel(self.fc2, F.gelu(self.fc1(x)), tp)


class Attention(nn.Module):
    """Multi-head self-attention, qkv without bias; the products in the
    compute dtype, the softmax in float32, as the JAX version. Split over
    M model ranks, it computes its own ``num_heads / M`` heads."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = F32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, dim * 3, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.num_heads
        tp = split_ranks(self.qkv, 0)
        H = self.num_heads // tp
        if tp > 1:
            x = copy_to_model(x)
        qkv = self.qkv(x).reshape(B, N, 3, H, hd)
        q, k, v = qkv.unbind(2)                                   # [B,N,H,D]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (hd ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, H * hd)
        return row_parallel(self.proj, out, tp)


def drop_path(x, rate: float, generator, training: bool):
    """Per-sample stochastic depth; the keep mask is drawn from the explicit
    ``generator``: inside ``synced()``, the global batch's mask, of which
    this rank keeps its rows (``global_rows``). Every caller (Transformer,
    Mamba3D, PCM, PTv3) passes ``[B, ...]`` with one scene or object a
    row, so this mask is per sample everywhere. The one elementwise mask,
    PCM's SegHead dropout (models/pcm.py:dropout), takes the same rule
    over its whole ``[B, N, C]`` draw."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    tail = (1,) * (x.ndim - 1)
    mask = global_rows(lambda n: torch.rand(
        (n,) + tail, generator=generator, device=x.device), x.shape[0]) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, dtype: torch.dtype = F32):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype)

    def forward(self, x, generator=None):
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path,
                          generator, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path,
                             generator, self.training)


class FlaxBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with flax semantics: batch
    stats from E[x^2] - E[x]^2 (clamped at 0), eps 1e-5, and running
    stats ``ra = 0.99 ra + 0.01 batch`` with the biased variance. In eval
    mode it normalizes by the running stats. Statistics, running stats and
    affine are float32; the output is in ``dtype``. Inside ``synced()``
    the sums behind E[x] and E[x^2] are the global batch's."""

    def __init__(self, ch: int, momentum: float = 0.99, eps: float = 1e-5,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if self.training:
            flat = x.reshape(-1, x.shape[-1]).float()
            w = sync_world()
            if w > 1:        # every rank holds as many rows
                s = sum_across_ranks(torch.cat([flat.sum(0),
                                                (flat * flat).sum(0)]))
                mean, sq = (s / (w * flat.shape[0])).chunk(2)
            else:
                mean, sq = flat.mean(0), (flat * flat).mean(0)
            var = torch.clamp_min(sq - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(self.dtype)


class PointGroupEncoder(nn.Module):
    """Mini-PointNet over local groups: [B, G, K, 3] -> [B, G, C]."""

    def __init__(self, encoder_channel: int, dtype: torch.dtype = F32):
        super().__init__()
        self.encoder_channel, self.dtype = encoder_channel, dtype
        self.conv1 = Dense(3, 128, dtype=dtype)
        self.bn1 = FlaxBatchNorm(128, dtype=dtype)
        self.conv2 = Dense(128, 256, dtype=dtype)
        self.conv3 = Dense(512, 512, dtype=dtype)
        self.bn2 = FlaxBatchNorm(512, dtype=dtype)
        self.conv4 = Dense(512, encoder_channel, dtype=dtype)

    def forward(self, point_groups):
        B, G, K, _ = point_groups.shape
        x = point_groups.reshape(B * G, K, 3).to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)
        g = x.amax(dim=1, keepdim=True)
        x = torch.cat([g.expand_as(x), x], dim=-1)
        x = F.relu(self.bn2(self.conv3(x)))
        x = self.conv4(x).amax(dim=1)
        return x.reshape(B, G, self.encoder_channel)
