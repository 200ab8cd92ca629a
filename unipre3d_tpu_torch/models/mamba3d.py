"""Mamba3D backbone: local-geometry aggregation + bidirectional Mamba.

Port of unipre3d_tpu/models/mamba3d.py (``LNPBlock``, ``Mamba3DBlock``,
``Mamba3DEncoder``) with the pretraining config: 128 FPS groups of 32
(kNN), a 384-dim group embedding, a CLS token, 16 blocks of [LNP (K_Norm
over k = 4 neighbouring centres -> softmax K_Pool -> shared MLP, SiLU) ->
bimamba mixer], the positional embedding re-added at every block, the
image fusion after the last block.

The reference's quirk is kept: the encoder returns ``(tokens, cls_pos)``,
the *learned CLS positional embedding* ``[B, 1, C]`` in place of centres;
the Gaussian head takes its first 3 channels as every gaussian's centre
(broadcast over the tokens). ``LNPBlock`` normalizes by one scalar
standard deviation over the whole ``[B, G, K, C]`` neighbourhood tensor
(``correction=0``, as ``jnp.std``; inside ``synced()`` over the global
batch, as JAX's over its data-sharded batch, in training and in the CLI's
validation); its float32 affine promotes the
bfloat16 activations to float32, and the K_Pool's exp runs on them, as in
JAX.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.models import fusion as fusion_lib
from unipre3d_tpu_torch.models.layers import (F32, Dense, LayerNorm,
                                              PointGroupEncoder, drop_path)
from unipre3d_tpu_torch.models.mamba_mixer import MambaMixer
from unipre3d_tpu_torch.ops.point_ops import (index_points, knn,
                                              subsample_group)
from unipre3d_tpu_torch.parallel.distributed import (sum_across_ranks,
                                                     sync_world)


def trunc_normal_(p: torch.Tensor, std: float, generator) -> None:
    """flax ``truncated_normal(std)``: ``std`` times a standard normal
    truncated at +-2."""
    p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), std=std,
                                  a=-2 * std, b=2 * std, generator=generator))


def spread(x: torch.Tensor) -> torch.Tensor:
    """The biased variance of every entry of ``x`` (JAX's ``jnp.std`` over
    the whole batch, squared); inside ``synced()`` the global batch's,
    from the global sum, then the global centred sum of squares."""
    w = sync_world()
    if w == 1:
        return x.var(correction=0)
    n = w * x.numel()           # every rank holds as many entries
    mean = sum_across_ranks(x.sum().reshape(1)) / n
    return (sum_across_ranks(((x - mean) ** 2).sum().reshape(1)) / n)[0]


class LNPBlock(nn.Module):
    """K_Norm -> K_Pool -> shared MLP; the CLS token (position 0) passes
    through untouched."""

    def __init__(self, dim: int, k_group_size: int = 4,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.k = k_group_size
        self.affine_alpha_feat = nn.Parameter(torch.ones(1, 1, 1, 2 * dim))
        self.affine_beta_feat = nn.Parameter(torch.zeros(1, 1, 1, 2 * dim))
        self.pre_norm_ft = LayerNorm(2 * dim, dtype)
        self.share_mlp = Dense(2 * dim, dim, dtype=dtype)

    def forward(self, center, feat):
        """center [B, G, 3], feat [B, G+1, C] -> [B, G+1, C]."""
        cls_tok, x = feat[:, :1], feat[:, 1:]
        _, idx = knn(center, center, self.k)
        knn_x = index_points(x, idx)                          # [B, G, K, C]
        mean_x = x[:, :, None, :]
        diff = knn_x - mean_x
        std = torch.sqrt(spread(diff.float()).to(diff.dtype))
        knn_x = torch.cat([diff / (std + 1e-5), mean_x.expand_as(knn_x)], -1)
        knn_x = self.affine_alpha_feat * knn_x + self.affine_beta_feat
        e_x = torch.exp(knn_x)
        pooled = (knn_x * e_x).mean(2) / e_x.mean(2)           # [B, G, 2C]
        out = F.silu(self.share_mlp(self.pre_norm_ft(pooled)))
        return torch.cat([cls_tok, out], 1)


class Mamba3DBlock(nn.Module):
    def __init__(self, dim: int, k_group_size: int = 4,
                 drop_path: float = 0.0, dtype: torch.dtype = F32):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, dtype)
        self.lfa = LNPBlock(dim, k_group_size, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mixer = MambaMixer(dim, bimamba=True, dtype=dtype)

    def forward(self, center, x, generator=None):
        x = x + drop_path(self.lfa(center, self.norm1(x)), self.drop_path,
                          generator, self.training)
        return x + drop_path(self.mixer(self.norm2(x)), self.drop_path,
                             generator, self.training)


class Mamba3DEncoder(nn.Module):
    def __init__(self, trans_dim: int = 384, depth: int = 16,
                 num_group: int = 128, group_size: int = 32,
                 k_group_size: int = 4, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.trans_dim, self.depth, self.dtype = trans_dim, depth, dtype
        self.num_group, self.group_size = num_group, group_size
        self.encoder = PointGroupEncoder(trans_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.pos_embed_fc1 = Dense(3, 128, dtype=dtype)
        self.pos_embed_fc2 = Dense(128, trans_dim, dtype=dtype)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        for i in range(depth):
            self.add_module(f"block{i}", Mamba3DBlock(
                trans_dim, k_group_size, drop_path=dpr[i], dtype=dtype))
        self.norm = LayerNorm(trans_dim, dtype)

    def flax_init(self, generator: torch.Generator) -> None:
        """flax's truncated_normal(0.02) CLS token and position."""
        trunc_normal_(self.cls_token, 0.02, generator)
        trunc_normal_(self.cls_pos, 0.02, generator)

    def forward(self, pts, image_features=None, c2w=None, fusion_mlp=None,
                intrinsic=None, image_proj=None, generator=None):
        """pts [B, N, 3(+)] -> (tokens [B, G, C], cls_pos [B, 1, C] float32:
        the learned CLS positional embedding, not geometric centres)."""
        neighborhood, center = subsample_group(
            pts[..., :3], self.num_group, self.group_size, use_knn=True)
        tokens = self.encoder(neighborhood)
        B, C = tokens.shape[0], self.trans_dim
        pos = self.pos_embed_fc2(F.silu(self.pos_embed_fc1(center)))
        x = torch.cat([self.cls_token.expand(B, 1, C).to(self.dtype), tokens],
                      1)
        pos = torch.cat([self.cls_pos.expand(B, 1, C).to(self.dtype), pos], 1)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(center, x + pos, generator)
            if i == self.depth - 1 and fusion_mlp is not None:
                x = fusion_lib.feature_fusion(
                    x, center, image_features, c2w, intrinsic, fusion_mlp,
                    image_proj)
        x = self.norm(x)
        return x[:, 1:], self.cls_pos.expand(B, 1, C).float()

