"""SparseUNet (SpUNet-v1m1) scene backbone with PointFusion.

Port of unipre3d_tpu/models/sparseunet.py: stem 5^3 submanifold conv
(6 -> 32) + BatchNorm + ReLU, scene PointFusion right after the stem, four
encoder stages [stride-2 conv + BasicBlock x (2, 3, 4, 6)] with channels
(32, 64, 128, 256), four decoder stages [inverse conv + skip concat +
BasicBlock x 2] with channels (256, 128, 96, 96), final linear -> 64.

Voxel sets are fixed-capacity, code-sorted and masked (ops/sparse.py); all
index structures come precomputed in a :class:`~unipre3d_tpu_torch.models.
scene_geometry.SpUNetGeometry`, whose submanifold structures are neighbour
tables (``conv_impl="gather"``, the default) or block structures
(``"block"``, ops/sparse.py:block_conv_apply; ``block_size``, ``block_div``,
threaded into every SubMConv, the scene ``fusion_mlps`` included). BatchNorm statistics run over the valid
rows of the whole batch. Module and parameter names follow the flax tree
(``conv_input``, ``enc{s}_block{i}``, ``down{s}``, ...) so that
``weights.jax_to_state_dict`` maps it across.

``dtype`` is the compute dtype (unipre3d_tpu/models/sparseunet.py:39-163):
the conv kernels are cast to it before each sparse conv (float32
accumulation inside the product, the result in ``dtype``), linear layers
cast as flax's ``Dense``, and ``MaskedBatchNorm`` computes its statistics,
running stats and affine in float32 and returns ``dtype``. A conv bias is
float32 and, as in JAX, promotes the biased conv's output to float32
(the BatchNorm after it casts back).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.models.layers import F32, Dense
from unipre3d_tpu_torch.models.scene_geometry import (CONV_IMPLS,
                                                      build_spunet_geometry)
from unipre3d_tpu_torch.ops import sparse as sp
from unipre3d_tpu_torch.parallel.distributed import sum_across_ranks
from unipre3d_tpu_torch.telemetry import span


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded [..., N, C] tensor with the
    reference's torch settings (eps 1e-3, momentum 0.01: running =
    0.99 running + 0.01 batch). Batch statistics are the masked mean and
    the masked BIASED variance, and the running variance is updated with
    the biased one too; ``torch.nn.BatchNorm1d`` does neither. Float32
    throughout; the output is in ``dtype``. Inside ``synced()`` the count,
    the sum and the centred sum of squares are the global batch's."""

    def __init__(self, ch: int, eps: float = 1e-3, momentum: float = 0.01,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x, mask):
        C = x.shape[-1]
        if self.training:
            m = mask.reshape(-1, 1).float()
            xf = x.reshape(-1, C).float()
            # (sum, count), then the centred sum of squares: global sums
            # across ranks inside synced(), where shards hold different
            # numbers of valid rows
            s = sum_across_ranks(torch.cat([(xf * m).sum(0), m.sum(0)]))
            n = torch.clamp_min(s[C], 1.0)
            mean = s[:C] / n
            var = sum_across_ranks((((xf - mean) ** 2) * m).sum(0)) / n
            with torch.no_grad():
                self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var
                                       + self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        y = (y * self.weight + self.bias).to(self.dtype)
        return torch.where(mask[..., None], y,
                           torch.zeros((), dtype=y.dtype, device=y.device))


class SparseKernel(nn.Module):
    """Holder of a sparse-conv kernel ``weight`` [K, Cin, Cout], initialised
    truncated-normal(0.02) within 2 sigma (``reset_parameters``; the
    trainer calls it with its seeded generator); ``kernel()`` is the weight
    in the compute dtype."""

    def __init__(self, k: int, cin: int, cout: int, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(k, cin, cout))
        self.reset_parameters()

    def kernel(self) -> torch.Tensor:
        return self.weight.to(self.dtype)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(0.02 * nn.init.trunc_normal_(
                torch.empty(self.weight.shape), a=-2.0, b=2.0,
                generator=generator))


class SubMConv(SparseKernel):
    """Submanifold conv over a precomputed structure: feats [B, M, Cin] and
    a neighbour table [B, M, K] (gather executor) or a batched
    :class:`~unipre3d_tpu_torch.ops.sparse.BlockStructure` of blocks of
    side ``block_size`` (block executor) -> [B, M, Cout] (+ bias). The
    structure's type chooses the executor, as in JAX."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 use_bias: bool = False, block_size: int = 4,
                 dtype: torch.dtype = F32):
        super().__init__(kernel_size ** 3, cin, cout, dtype)
        self.block_size = block_size
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, feats, nbr):
        if isinstance(nbr, sp.BlockStructure):
            y = sp.block_conv_apply(feats, nbr, self.kernel(),
                                    self.block_size)
        else:
            y = sp.subm_gather_matmul(feats, nbr, self.kernel())
        return y if self.bias is None else y + self.bias


class SubMConvBlock(nn.Module):
    """SubMConv(k3, bias) + BN + ReLU: the scene ``fusion_mlps``."""

    def __init__(self, cin: int, channels: int, dtype: torch.dtype = F32,
                 block_size: int = 4):
        super().__init__()
        self.conv = SubMConv(cin, channels, 3, use_bias=True,
                             block_size=block_size, dtype=dtype)
        self.bn = MaskedBatchNorm(channels, dtype=dtype)

    def forward(self, feats, nbr, mask):
        return F.relu(self.bn(self.conv(feats, nbr), mask))


class BasicBlock(nn.Module):
    """[conv3-bn-relu-conv3-bn] + x (or a bias-free projection + BN when
    the width changes), then ReLU."""

    def __init__(self, cin: int, channels: int, dtype: torch.dtype = F32,
                 block_size: int = 4):
        super().__init__()
        self.conv1 = SubMConv(cin, channels, block_size=block_size,
                              dtype=dtype)
        self.bn1 = MaskedBatchNorm(channels, dtype=dtype)
        self.conv2 = SubMConv(channels, channels, block_size=block_size,
                              dtype=dtype)
        self.bn2 = MaskedBatchNorm(channels, dtype=dtype)
        if cin != channels:
            self.proj = Dense(cin, channels, bias=False, dtype=dtype)
            self.proj_bn = MaskedBatchNorm(channels, dtype=dtype)
        else:
            self.proj = None

    def forward(self, feats, nbr, mask):
        h = F.relu(self.bn1(self.conv1(feats, nbr), mask))
        h = self.bn2(self.conv2(h, nbr), mask)
        res = feats if self.proj is None else \
            self.proj_bn(self.proj(feats), mask)
        return F.relu(h + res)


class DownConv(SparseKernel):
    """SparseConv3d(k2, s2) + BN + ReLU over a batched DownStructure."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = F32):
        super().__init__(8, cin, cout, dtype)
        self.bn = MaskedBatchNorm(cout, dtype=dtype)

    def forward(self, feats, ds):
        return F.relu(self.bn(sp.downsample_apply(ds, feats, self.kernel()),
                              ds.mask))


class UpConv(SparseKernel):
    """SparseInverseConv3d(k2) + BN + ReLU."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = F32):
        super().__init__(8, cin, cout, dtype)
        self.bn = MaskedBatchNorm(cout, dtype=dtype)

    def forward(self, parent_idx, child_offset, coarse_feats, fine_mask):
        f = sp.inverse_conv(parent_idx, child_offset, coarse_feats, fine_mask,
                            self.kernel())
        return F.relu(self.bn(f, fine_mask))


def point_fusion_merge(x, image_features, geometry):
    """Scene PointFusion, feature part: append each fused pixel voxel's
    representative 2D feature (in ``x``'s dtype) to the stem output and
    apply the merge permutation. x [B, M, C], image_features
    [B*V, C, H, W] -> [B, M+P, C].
    (The geometry part, voxelize + bbox filter + merge, is in
    models/scene_geometry.py.)"""
    B, _, C = x.shape
    pf = image_features.to(x.dtype).reshape(B, -1, C,
                                            *image_features.shape[2:])
    pf = pf.permute(0, 1, 3, 4, 2).reshape(B, -1, C)
    pix_rep = geometry.pix_rep
    pix = torch.gather(pf, 1, pix_rep.clamp(min=0)[..., None].expand(
        -1, -1, C))
    pix = torch.where((pix_rep >= 0)[..., None], pix,
                      torch.zeros((), dtype=pix.dtype, device=pix.device))
    cat = torch.cat([x, pix], dim=1)
    return torch.gather(cat, 1, geometry.merge_order[..., None].expand(
        -1, -1, C))


class SpUNet(nn.Module):
    """SpUNet-v1m1; ``forward_point_fusion`` is the scene entry."""

    def __init__(self, in_channels: int = 6, num_classes: int = 64,
                 base_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96,
                                            96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 grid_size: float = 0.02, pixel_capacity: int = 4096,
                 level_capacity_div: Sequence[int] = (3, 9, 27, 81),
                 conv_impl: str = "gather", block_size: int = 4,
                 block_div: int = 8, dtype: torch.dtype = F32):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r}: one of {CONV_IMPLS}")
        self.conv_impl, self.block_size = conv_impl, block_size
        self.block_div = block_div
        self.channels, self.layers = tuple(channels), tuple(layers)
        self.grid_size, self.pixel_capacity = grid_size, pixel_capacity
        self.level_capacity_div = tuple(level_capacity_div)
        n_stages = len(self.layers) // 2
        self.n_stages, self.dtype = n_stages, dtype

        self.conv_input = SubMConv(in_channels, base_channels, 5,
                                   block_size=block_size, dtype=dtype)
        self.bn_input = MaskedBatchNorm(base_channels, dtype=dtype)
        enc_ch = [base_channels]
        c = base_channels
        for s in range(n_stages):
            self.add_module(f"down{s}", DownConv(c, self.channels[s], dtype))
            c = self.channels[s]
            for i in range(self.layers[s]):
                self.add_module(f"enc{s}_block{i}",
                                BasicBlock(c, c, dtype, block_size))
            enc_ch.append(c)
        # decoder widths (reference :230-276): start at channels[-1], then
        # channels[len - s - 2]
        self.ref_dec, dc = [], self.channels[-1]
        for s in range(n_stages):
            self.ref_dec.append(dc)
            dc = self.channels[len(self.channels) - s - 2]
        c = enc_ch[-1]
        for s in reversed(range(n_stages)):
            self.add_module(f"up{s}", UpConv(c, self.ref_dec[s], dtype))
            c = self.ref_dec[s] + enc_ch[s]
            for i in range(self.layers[len(self.channels) - s - 1]):
                self.add_module(f"dec{s}_block{i}",
                                BasicBlock(c, self.ref_dec[s], dtype,
                                           block_size))
                c = self.ref_dec[s]
        self.final = Dense(c, num_classes, dtype=dtype)

    def build_geometry(self, data, unprojected, use_fusion: bool):
        """The batch's index structures (models/scene_geometry.py)."""
        with span("geometry/build"):
            return build_spunet_geometry(
                data, unprojected, grid_size=self.grid_size,
                pixel_capacity=self.pixel_capacity,
                level_divs=self.level_capacity_div, n_stages=self.n_stages,
                use_fusion=use_fusion, conv_impl=self.conv_impl,
                block_size=self.block_size, block_div=self.block_div)

    def forward_point_fusion(self, data, image_features=None,
                             unprojected=None, fusion_mlp=None,
                             geometry=None, generator=None):
        """data: dict with ``coord`` [B, M, 3], ``grid_coord`` [B, M, 3],
        ``feat`` [B, M, in_channels], ``mask`` [B, M], ``min_coord``
        [B, 3]; image_features [B*V, C, H, W] with C == base_channels;
        unprojected [B, V, H, W, 4]. ``geometry``: the precomputed
        SpUNetGeometry of the batch, built here when None (the same
        computation). ``generator`` is taken for the scene backbones'
        common signature; SpUNet draws nothing. Returns (features [B, M',
        num_classes], world coords [B, M', 3], mask [B, M']) with M' = M +
        pixel_capacity under fusion."""
        if geometry is None:
            geometry = self.build_geometry(data, unprojected,
                                           fusion_mlp is not None)
        g = geometry
        feats = torch.gather(data["feat"].to(self.dtype), 1,
                             g.order0[..., None].expand(
                                 -1, -1, data["feat"].shape[-1]))
        x = F.relu(self.bn_input(self.conv_input(feats, g.nbr5), g.mask0))
        if fusion_mlp is not None:
            x = point_fusion_merge(x, image_features, g)
            x = fusion_mlp(x, g.nbr3_fine, g.fine_mask)

        skips, f = [x], x
        for s in range(self.n_stages):
            f = getattr(self, f"down{s}")(f, g.downs[s])
            for i in range(self.layers[s]):
                f = getattr(self, f"enc{s}_block{i}")(f, g.nbrs[s],
                                                      g.downs[s].mask)
            skips.append(f)

        f = skips.pop(-1)
        masks = [g.fine_mask] + [d.mask for d in g.downs]
        level_nbrs = [g.nbr3_fine] + list(g.nbrs)
        for s in reversed(range(self.n_stages)):
            skip = skips.pop(-1)
            f = getattr(self, f"up{s}")(g.downs[s].parent_idx,
                                        g.downs[s].child_offset, f, masks[s])
            f = torch.cat([f, skip], dim=-1)
            for i in range(self.layers[len(self.channels) - s - 1]):
                f = getattr(self, f"dec{s}_block{i}")(f, level_nbrs[s],
                                                      masks[s])
        f = self.final(f)
        f = torch.where(g.fine_mask[..., None], f,
                        torch.zeros((), dtype=f.dtype, device=f.device))
        return f, g.world, g.fine_mask
