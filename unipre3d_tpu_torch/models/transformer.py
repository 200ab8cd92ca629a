"""Standard point transformer backbone (Point-BERT style).

Port of unipre3d_tpu/models/transformer.py (``PointTransformerEncoder``):
FPS + ball-query groups, mini-PointNet group embedding, CLS token + MLP
positional embedding re-added at every pre-LN block, and the object
feature fusion after the last block. ``dtype`` is the compute dtype of
every module (models/layers.py); the residual stream is in it. On a
``(data, model)`` grid each block's ``Attention`` and ``Mlp`` compute on
their split (models/layers.py); the rest of the encoder is replicated on
the ranks of a model group, which hold the same rows.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.models import fusion as fusion_lib
from unipre3d_tpu_torch.models.layers import (F32, Block, Dense, LayerNorm,
                                              PointGroupEncoder)
from unipre3d_tpu_torch.ops.point_ops import subsample_group


class PointTransformerEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, num_groups: int = 128,
                 group_size: int = 32, radius: float = 0.1,
                 encoder_dims: int = 384, trans_dim: int = 384,
                 depth: int = 16, num_heads: int = 6,
                 drop_path_rate: float = 0.1, dtype: torch.dtype = F32):
        super().__init__()
        self.num_groups, self.group_size, self.radius = (
            num_groups, group_size, radius)
        self.depth, self.dtype = depth, dtype
        self.encoder = PointGroupEncoder(encoder_dims, dtype)
        self.reduce_dim = Dense(encoder_dims, trans_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.pos_embed_fc1 = Dense(3, 128, dtype=dtype)
        self.pos_embed_fc2 = Dense(128, trans_dim, dtype=dtype)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        for i in range(depth):
            self.add_module(f"block{i}", Block(trans_dim, num_heads,
                                               drop_path=dpr[i], dtype=dtype))
        self.norm = LayerNorm(trans_dim, dtype)

    def forward(self, pts, image_features=None, c2w=None, fusion_mlp=None,
                intrinsic=None, image_proj=None, generator=None):
        """pts [B, N, 3(+)] -> (tokens [B, G, trans_dim], centers [B, G, 3])."""
        neighborhood, center = subsample_group(
            pts[:, :, :3], self.num_groups, self.group_size,
            radius=self.radius)
        tokens = self.reduce_dim(self.encoder(neighborhood))
        B, _, D = tokens.shape
        pos = self.pos_embed_fc2(F.gelu(self.pos_embed_fc1(center)))
        x = torch.cat([self.cls_token.expand(B, 1, D).to(self.dtype), tokens],
                      dim=1)
        pos = torch.cat([self.cls_pos.expand(B, 1, D).to(self.dtype), pos],
                        dim=1)
        for i in range(self.depth):
            # positional embedding re-added at every block input
            x = getattr(self, f"block{i}")(x + pos, generator)
            if i == self.depth - 1 and fusion_mlp is not None:
                x = fusion_lib.feature_fusion(
                    x, center, image_features, c2w, intrinsic, fusion_mlp,
                    image_proj)
        x = self.norm(x)
        return x[:, 1:, :], center
