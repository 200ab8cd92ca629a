"""PointMLP backbone: residual-MLP U-Net over FPS/kNN groups.

Port of unipre3d_tpu/models/pointmlp.py (``ConvBNReLU``,
``ConvBNReLURes``, ``LocalGrouper``, ``PreExtraction``, ``PosExtraction``,
``FeaturePropagation``, ``PointMLPEncoder``) with the reference factory's
hyperparameters (embed 64, dims x2 per stage to 1024, k = 24, reducers 2,
anchor normalization, decoder [512, 256, 128, 128] with 3-NN
inverse-distance propagation) and its quirks:

* grouping distances (FPS, kNN, three-NN) use every point channel, the
  gravity channel included when ``in_channels`` is 4;
* the geometric affine normalizes by one standard deviation per cloud
  (``correction=0``, as ``jnp.std``);
* the image fusion runs at the last decoder layer over the full cloud.

Channel-last [B, N, C]; a 1x1 Conv1d is a ``Dense``. Dtypes as in flax
(models/layers.py): a float32 affine parameter or interpolation weight
that meets a ``dtype`` activation outside a module promotes it to float32,
as JAX's type promotion does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.models import fusion as fusion_lib
from unipre3d_tpu_torch.models.layers import F32, Dense, FlaxBatchNorm
from unipre3d_tpu_torch.ops.point_ops import (furthest_point_sample,
                                              index_points, knn,
                                              three_interpolate, three_nn)


def cloud_std(diff: torch.Tensor) -> torch.Tensor:
    """``jnp.std(diff.reshape(B, -1), axis=-1)``: ddof 0, computed in float32
    and rounded to the input's dtype -> [B, 1, 1, 1]."""
    var = diff.reshape(diff.shape[0], -1).float().var(-1, correction=0)
    return torch.sqrt(var.to(diff.dtype))[:, None, None, None]


def geometric_affine(grouped, anchor, alpha, beta):
    """alpha * (grouped - anchor) / (std + 1e-5) + beta, the std one per
    cloud; float32 alpha and beta promote the result to float32."""
    diff = grouped - anchor
    return alpha * (diff / (cloud_std(diff) + 1e-5)) + beta


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.conv = Dense(cin, cout, bias=bias, dtype=dtype)
        self.bn = FlaxBatchNorm(cout, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvBNReLURes(nn.Module):
    """relu(net2(net1(x)) + x)."""

    def __init__(self, ch: int, bias: bool = True, dtype: torch.dtype = F32):
        super().__init__()
        self.conv1 = Dense(ch, ch, bias=bias, dtype=dtype)
        self.bn1 = FlaxBatchNorm(ch, dtype=dtype)
        self.conv2 = Dense(ch, ch, bias=bias, dtype=dtype)
        self.bn2 = FlaxBatchNorm(ch, dtype=dtype)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(h)) + x)


class LocalGrouper(nn.Module):
    """FPS + kNN + anchor-normalized geometric affine."""

    def __init__(self, channel: int, sample_ratio: int, kneighbors: int,
                 use_xyz: bool = False, xyz_channels: int = 3):
        super().__init__()
        self.sample_ratio, self.kneighbors = sample_ratio, kneighbors
        self.use_xyz = use_xyz
        d = channel + (xyz_channels if use_xyz else 0)
        self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, d))
        self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, d))

    def forward(self, xyz, points):
        """xyz [B, N, C_xyz] (every point channel), points [B, N, D] ->
        (new_xyz [B, S, C_xyz], new_points [B, S, K, 2D(+C_xyz)])."""
        S = xyz.shape[1] // self.sample_ratio
        fps_idx = furthest_point_sample(xyz, S)
        new_xyz = index_points(xyz, fps_idx)
        new_points = index_points(points, fps_idx)
        _, idx = knn(new_xyz, xyz, self.kneighbors)
        grouped = index_points(points, idx)                  # [B, S, K, D]
        anchor = new_points
        if self.use_xyz:
            grouped = torch.cat([grouped, index_points(xyz, idx)], -1)
            anchor = torch.cat([new_points, new_xyz], -1)
        grouped = geometric_affine(grouped, anchor[:, :, None, :],
                                   self.affine_alpha, self.affine_beta)
        return new_xyz, torch.cat(
            [grouped, new_points[:, :, None, :].expand(
                -1, -1, grouped.shape[2], -1).to(grouped.dtype)], -1)


class PreExtraction(nn.Module):
    """[B, S, K, D] -> [B, S, out]: transfer, residual blocks, max over K."""

    def __init__(self, cin: int, cout: int, blocks: int = 2,
                 bias: bool = False, dtype: torch.dtype = F32):
        super().__init__()
        self.cout, self.blocks = cout, blocks
        self.transfer = ConvBNReLU(cin, cout, bias, dtype)
        for i in range(blocks):
            self.add_module(f"res{i}", ConvBNReLURes(cout, bias, dtype))

    def forward(self, x):
        B, S, K, D = x.shape
        h = self.transfer(x.reshape(B * S, K, D))
        for i in range(self.blocks):
            h = getattr(self, f"res{i}")(h)
        return h.amax(1).reshape(B, S, self.cout)


class PosExtraction(nn.Module):
    def __init__(self, ch: int, blocks: int = 2, bias: bool = False,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"res{i}", ConvBNReLURes(ch, bias, dtype))

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"res{i}")(x)
        return x


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance upsampling + fuse MLP + residual blocks."""

    def __init__(self, cin: int, cout: int, blocks: int = 2,
                 bias: bool = False, dtype: torch.dtype = F32):
        super().__init__()
        self.fuse = ConvBNReLU(cin, cout, bias, dtype)
        self.extraction = PosExtraction(cout, blocks, bias, dtype)

    def forward(self, xyz1, xyz2, points1, points2):
        """xyz1 [B, N, C] dense, xyz2 [B, S, C] coarse, points1 [B, N, D1]
        (the skip, may be None), points2 [B, S, D2] -> [B, N, out]."""
        dists, idx = three_nn(xyz1, xyz2)
        x = three_interpolate(points2, idx, dists)           # float32
        if points1 is not None:
            x = torch.cat([points1.to(x.dtype), x], -1)
        return self.extraction(self.fuse(x))


class PointMLPEncoder(nn.Module):
    def __init__(self, in_channels: int = 4, embed_dim: int = 64,
                 dim_expansion: Sequence[int] = (2, 2, 2, 2),
                 pre_blocks: Sequence[int] = (2, 2, 2, 2),
                 pos_blocks: Sequence[int] = (2, 2, 2, 2),
                 de_blocks: Sequence[int] = (2, 2, 2, 2),
                 de_dims: Sequence[int] = (512, 256, 128, 128),
                 k_neighbors: Sequence[int] = (24, 24, 24, 24),
                 reducers: Sequence[int] = (2, 2, 2, 2),
                 use_xyz: bool = False, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype, self.n_stages = dtype, len(pre_blocks)
        self.embedding = ConvBNReLU(in_channels, embed_dim, bias=False,
                                    dtype=dtype)
        channels = [embed_dim]
        for i in range(self.n_stages):
            last = channels[-1]
            out = last * dim_expansion[i]
            channels.append(out)
            self.add_module(f"grouper{i}", LocalGrouper(
                last, reducers[i], k_neighbors[i], use_xyz, in_channels))
            cin = 2 * last + (in_channels if use_xyz else 0)
            self.add_module(f"pre{i}", PreExtraction(cin, out, pre_blocks[i],
                                                     dtype=dtype))
            self.add_module(f"pos{i}", PosExtraction(out, pos_blocks[i],
                                                     dtype=dtype))
        dims = [channels[-1], *de_dims]
        skips = channels[::-1][1:]
        self.n_dec = len(dims) - 1
        for i in range(self.n_dec):
            self.add_module(f"decode{i}", FeaturePropagation(
                skips[i] + dims[i], dims[i + 1], de_blocks[i], dtype=dtype))

    def forward(self, pts, image_features=None, c2w=None, fusion_mlp=None,
                intrinsic=None, image_proj=None, generator=None):
        """pts [B, N, in_channels] -> (features [B, N, de_dims[-1]], centres
        = the input points [B, N, in_channels])."""
        p = pts
        x = self.embedding(p.to(self.dtype))
        p_list, x_list = [p], [x]
        for i in range(self.n_stages):
            p, grouped = getattr(self, f"grouper{i}")(p, x)
            x = getattr(self, f"pos{i}")(getattr(self, f"pre{i}")(grouped))
            p_list.append(p)
            x_list.append(x)
        p_list, x_list = p_list[::-1], x_list[::-1]
        x = x_list[0]
        for i in range(self.n_dec):
            x = getattr(self, f"decode{i}")(p_list[i + 1], p_list[i],
                                            x_list[i + 1], x)
            if i == self.n_dec - 1 and fusion_mlp is not None:
                x = fusion_lib.feature_fusion(
                    x, p_list[i + 1][..., :3], image_features, c2w,
                    intrinsic, fusion_mlp, image_proj)
        return x, p_list[-1]
