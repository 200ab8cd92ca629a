"""PointTransformerV3 (PT-v3m1) scene backbone: serialized patch attention.

Port of unipre3d_tpu/models/ptv3.py with the UniPre3D pretraining setup:
orders ("z", "z-trans"), encoder depths (2, 2, 2, 6, 2), channels
(32, 64, 128, 256, 512), heads (2, 4, 8, 16, 32); decoder depths
(2, 2, 2, 2), channels (64, 64, 128, 256), heads (4, 4, 8, 16); patch 48,
MLP ratio 4, drop-path 0.3, pre-norm blocks with xCPE (a 3^3 submanifold
conv, a linear layer and a LayerNorm), scene PointFusion after the
embedding.

* Points live in the fixed-capacity, code-sorted voxel arrays of
  ops/sparse.py; every index structure (the PointFusion merge, each
  stage's pooling clusters, 3^3 table and the two serialization orders)
  comes precomputed in a :class:`~unipre3d_tpu_torch.models.
  scene_geometry.PTv3Geometry`, built here when the forward is given none.
* Serialized attention is masked attention over the ``[M/48, 48]`` patches
  of each order's sorted sequence, padded with invalid rows to a multiple
  of 48: one ``scaled_dot_product_attention`` call over the patches of
  every scene, invalid keys masked by an additive -1e9 (JAX replaces their
  logits by -1e9: the softmax of a row with a valid key is the same, and a
  patch of padding alone, whose rows are zeroed after the attention, stays
  finite in the forward and the backward, where a boolean mask can give
  NaN rows). ``q`` is scaled by ``hd ** -0.5`` (0.25 at hd = 16, exact).
* Pooling groups each stage's voxels into their stride-2 parents
  (``sparse.pool_clusters``), projects and takes the segment max
  (``sparse.segment_reduce``), then BatchNorm and GELU; unpooling gathers
  the coarse rows through ``parent_idx``.
* ``shuffle_orders``: in training, one Bernoulli(0.5) draw a forward from
  the step's generator swaps the two orders for the whole batch (a select
  on the device, no host sync); nothing is drawn in eval.

Module and parameter names follow the flax tree (``embedding``,
``enc{s}_block{i}`` with ``cpe_kernel``, ``cpe_bias``, ``cpe_fc``,
``cpe_norm``, ``norm1``, ``attn.qkv``, ``attn.proj``, ``norm2``,
``mlp_fc1``, ``mlp_fc2``; ``pool{s}_proj``/``_bn``; ``unpool{s}_proj``,
``_bn``, ``_proj_skip``, ``_skip_bn``) so ``weights.jax_to_state_dict``
maps it. ``dtype`` is the compute dtype with flax's module semantics
(models/layers.py); ``cpe_bias`` is float32 and promotes the xCPE conv's
output to float32, as in JAX. GELU is flax's default, the tanh
approximation.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.models.layers import (F32, Dense, LayerNorm,
                                              drop_path, row_parallel)
# serialize and PTv3Geometry live beside the other scene geometry (which
# this module imports); they are PTv3's, and named here too
from unipre3d_tpu_torch.models.scene_geometry import (  # noqa: F401
    PTv3Geometry, Serialized, build_ptv3_geometry, serialize)
from unipre3d_tpu_torch.models.sparseunet import (MaskedBatchNorm, SubMConv,
                                                  point_fusion_merge)
from unipre3d_tpu_torch.ops import sparse as sp
from unipre3d_tpu_torch.parallel.tensor import copy_to_model, split_ranks
from unipre3d_tpu_torch.telemetry import span

MASKED_LOGIT = -1e9


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def patch_attention(qkv: torch.Tensor, order: torch.Tensor,
                    inverse: torch.Tensor, mask: torch.Tensor,
                    num_heads: int, patch_size: int) -> torch.Tensor:
    """Masked patch attention over one order of every scene: qkv [B, M, 3C]
    in canonical row order, order/inverse/mask [B, M] -> [B, M, C] in
    canonical order. The sorted sequence is padded with invalid rows to a
    multiple of ``patch_size`` (invalid rows already sort last); the
    logits and the softmax are float32 on float32 inputs, the products in
    the input dtype otherwise; invalid rows are zeroed."""
    B, M, C3 = qkv.shape
    C = C3 // 3
    H, K = num_heads, patch_size
    hd = C // H
    x = torch.gather(qkv, 1, order[..., None].expand(B, M, C3))
    m_s = torch.gather(mask, 1, order)
    Mpad = -(-M // K) * K
    if Mpad != M:
        x = torch.cat([x, x.new_zeros(B, Mpad - M, C3)], 1)
        m_s = torch.cat([m_s, m_s.new_zeros(B, Mpad - M)], 1)
    P = Mpad // K
    x = x.reshape(B * P, K, 3, H, hd).permute(2, 0, 3, 1, 4)  # [3,BP,H,K,hd]
    bias = torch.where(m_s.reshape(B * P, 1, 1, K), _zero(x),
                       torch.full((), MASKED_LOGIT, dtype=x.dtype,
                                  device=x.device))
    out = F.scaled_dot_product_attention(x[0], x[1], x[2], attn_mask=bias,
                                         scale=hd ** -0.5)
    out = out.permute(0, 2, 1, 3).reshape(B, Mpad, C)
    out = torch.where(m_s[..., None], out, _zero(out))
    return torch.gather(out, 1, inverse[..., None].expand(B, M, C))


class SerializedAttention(nn.Module):
    """qkv -> patch attention along one order -> proj. Split over M model
    ranks (parallel/mesh.py ``replicate``) it computes its own
    ``num_heads / M`` heads: ``qkv`` column parallel, split head-aligned
    with its bias (JAX's ``attn/qkv/bias`` ``P("model")``), ``proj`` row
    parallel, its bias replicated and added once after the sum."""

    def __init__(self, channels: int, num_heads: int, patch_size: int = 48,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.num_heads, self.patch_size = num_heads, patch_size
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj = Dense(channels, channels, dtype=dtype)

    def forward(self, feat, ser: Serialized, mask, order_index: int):
        tp = split_ranks(self.qkv, 0)
        if tp > 1:
            feat = copy_to_model(feat)
        out = patch_attention(self.qkv(feat), ser.order[:, order_index],
                              ser.inverse[:, order_index], mask,
                              self.num_heads // tp, self.patch_size)
        return row_parallel(self.proj, out, tp)


class PTv3Block(nn.Module):
    """xCPE + pre-norm attention + pre-norm MLP; ``nbr`` is the stage's 3^3
    submanifold table, ``ser`` its serialization. The output is masked."""

    def __init__(self, channels: int, num_heads: int, patch_size: int = 48,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 order_index: int = 0, dtype: torch.dtype = F32):
        super().__init__()
        self.drop_path, self.order_index, self.dtype = (drop_path,
                                                        order_index, dtype)
        self.cpe_kernel = nn.Parameter(torch.empty(27, channels, channels))
        self.cpe_bias = nn.Parameter(torch.zeros(channels))
        self.cpe_fc = Dense(channels, channels, dtype=dtype)
        self.cpe_norm = LayerNorm(channels, dtype)
        self.norm1 = LayerNorm(channels, dtype)
        self.attn = SerializedAttention(channels, num_heads, patch_size,
                                        dtype)
        self.norm2 = LayerNorm(channels, dtype)
        self.mlp_fc1 = Dense(channels, int(channels * mlp_ratio), dtype=dtype)
        self.mlp_fc2 = Dense(int(channels * mlp_ratio), channels, dtype=dtype)
        self.flax_init(None)

    def flax_init(self, generator):
        """``cpe_kernel``: flax variance_scaling(1, fan_in, truncated
        normal), fan_in = 27 x channels."""
        with torch.no_grad():
            fan_in = self.cpe_kernel.shape[0] * self.cpe_kernel.shape[1]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            self.cpe_kernel.copy_(nn.init.trunc_normal_(
                torch.empty(self.cpe_kernel.shape), std=std, a=-2 * std,
                b=2 * std, generator=generator))

    def forward(self, feat, nbr, ser: Serialized, mask, generator=None):
        h = sp.subm_gather_matmul(feat, nbr, self.cpe_kernel.to(self.dtype))
        h = self.cpe_norm(self.cpe_fc(h + self.cpe_bias))
        feat = feat + h
        h = self.attn(self.norm1(feat), ser, mask, self.order_index)
        feat = feat + drop_path(h, self.drop_path, generator, self.training)
        h = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(feat))))
        feat = feat + drop_path(h, self.drop_path, generator, self.training)
        return torch.where(mask[..., None], feat, _zero(feat))


class PointTransformerV3(nn.Module):
    """PT-v3m1; ``forward_point_fusion`` is the scene entry."""

    def __init__(self, in_channels: int = 6,
                 orders: Sequence[str] = ("z", "z-trans"),
                 enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
                 enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
                 enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
                 dec_depths: Sequence[int] = (2, 2, 2, 2),
                 dec_channels: Sequence[int] = (64, 64, 128, 256),
                 dec_num_head: Sequence[int] = (4, 4, 8, 16),
                 patch_size: int = 48, mlp_ratio: float = 4.0,
                 drop_path: float = 0.3, shuffle_orders: bool = True,
                 grid_size: float = 0.02, pixel_capacity: int = 4096,
                 pool_capacity_div: int = 3, dtype: torch.dtype = F32):
        super().__init__()
        self.orders = tuple(orders)
        self.enc_depths, self.dec_depths = tuple(enc_depths), tuple(dec_depths)
        self.enc_channels = tuple(enc_channels)
        self.dec_channels = tuple(dec_channels)
        self.patch_size, self.shuffle_orders = patch_size, shuffle_orders
        self.grid_size, self.pixel_capacity = grid_size, pixel_capacity
        self.pool_capacity_div, self.dtype = pool_capacity_div, dtype
        n_stages = self.n_stages = len(self.enc_depths)
        n_orders = len(self.orders)

        self.embedding = SubMConv(in_channels, enc_channels[0], 5,
                                  dtype=dtype)
        self.embedding_bn = MaskedBatchNorm(enc_channels[0], dtype=dtype)
        n_enc = sum(self.enc_depths)
        enc_dpr = [drop_path * i / max(n_enc - 1, 1) for i in range(n_enc)]
        di = 0
        for s in range(n_stages):
            if s > 0:
                self.add_module(f"pool{s}_proj", Dense(
                    enc_channels[s - 1], enc_channels[s], dtype=dtype))
                self.add_module(f"pool{s}_bn", MaskedBatchNorm(
                    enc_channels[s], dtype=dtype))
            for i in range(self.enc_depths[s]):
                self.add_module(f"enc{s}_block{i}", PTv3Block(
                    enc_channels[s], enc_num_head[s], patch_size, mlp_ratio,
                    enc_dpr[di], order_index=i % n_orders, dtype=dtype))
                di += 1
        n_dec = sum(self.dec_depths)
        dec_dpr = [drop_path * i / max(n_dec - 1, 1) for i in range(n_dec)]
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        for s in reversed(range(n_stages - 1)):
            self.add_module(f"unpool{s}_proj",
                            Dense(dec_ch[s + 1], dec_ch[s], dtype=dtype))
            self.add_module(f"unpool{s}_bn",
                            MaskedBatchNorm(dec_ch[s], dtype=dtype))
            self.add_module(f"unpool{s}_proj_skip",
                            Dense(enc_channels[s], dec_ch[s], dtype=dtype))
            self.add_module(f"unpool{s}_skip_bn",
                            MaskedBatchNorm(dec_ch[s], dtype=dtype))
            # the decoder's rates run in reverse within each stage
            dd = dec_dpr[sum(self.dec_depths[:s]):sum(self.dec_depths[:s + 1])]
            dd = list(reversed(dd))
            for i in range(self.dec_depths[s]):
                self.add_module(f"dec{s}_block{i}", PTv3Block(
                    dec_ch[s], dec_num_head[s], patch_size, mlp_ratio, dd[i],
                    order_index=i % n_orders, dtype=dtype))

    def build_geometry(self, data, unprojected, use_fusion: bool):
        """The batch's index structures (models/scene_geometry.py)."""
        with span("geometry/build"):
            return build_ptv3_geometry(
                data, unprojected, grid_size=self.grid_size,
                pixel_capacity=self.pixel_capacity, orders=self.orders,
                n_stages=self.n_stages, patch_size=self.patch_size,
                pool_capacity_div=self.pool_capacity_div,
                use_fusion=use_fusion)

    def _shuffled(self, sers, generator, device):
        """The stages' serializations with the order axis flipped for the
        whole batch when one Bernoulli(0.5) draw says so (training with
        ``shuffle_orders`` only)."""
        if not (self.shuffle_orders and self.training):
            return sers
        swap = torch.rand((), generator=generator, device=device) < 0.5
        return [Serialized(*(torch.where(swap, t.flip(1), t) for t in ser))
                for ser in sers]

    def forward_point_fusion(self, data, image_features=None,
                             unprojected=None, fusion_mlp=None,
                             geometry=None, generator=None):
        """data: dict with ``coord`` [B, M, 3], ``grid_coord`` [B, M, 3],
        ``feat`` [B, M, in_channels], ``mask`` [B, M], ``min_coord``
        [B, 3]; image_features [B*V, C, H, W] with C == enc_channels[0];
        unprojected [B, V, H, W, 4]. ``geometry``: the batch's
        PTv3Geometry, built here when None; ``generator``: DropPath's and
        the order shuffle's draws. Returns (features [B, M',
        dec_channels[0]], world coords [B, M', 3], mask [B, M'])."""
        if geometry is None:
            geometry = self.build_geometry(data, unprojected,
                                           fusion_mlp is not None)
        g = geometry
        feats = torch.gather(data["feat"].to(self.dtype), 1,
                             g.order0[..., None].expand(
                                 -1, -1, data["feat"].shape[-1]))
        x = gelu(self.embedding_bn(self.embedding(feats, g.nbr5), g.mask0))
        if fusion_mlp is not None:
            x = point_fusion_merge(x, image_features, g)
            x = fusion_mlp(x, g.nbr3_fine, g.fine_mask)

        masks = [g.fine_mask] + [c.mask for c in g.clusters]
        nbrs = [g.nbr3_fine] + list(g.nbrs)
        sers = self._shuffled(list(g.sers), generator, x.device)
        skips = []
        for s in range(self.n_stages):
            if s > 0:
                cl = g.clusters[s - 1]
                h = getattr(self, f"pool{s}_proj")(x)
                h = sp.segment_reduce(h, cl.parent_idx, cl.mask.shape[1],
                                      "max")
                h = gelu(getattr(self, f"pool{s}_bn")(h, cl.mask))
                x = torch.where(cl.mask[..., None], h, _zero(h))
            for i in range(self.enc_depths[s]):
                x = getattr(self, f"enc{s}_block{i}")(x, nbrs[s], sers[s],
                                                      masks[s], generator)
            skips.append(x)

        for s in reversed(range(self.n_stages - 1)):
            parent = g.clusters[s].parent_idx
            h = getattr(self, f"unpool{s}_proj")(x)
            h = gelu(getattr(self, f"unpool{s}_bn")(h, masks[s + 1]))
            hskip = getattr(self, f"unpool{s}_proj_skip")(skips[s])
            hskip = gelu(getattr(self, f"unpool{s}_skip_bn")(hskip, masks[s]))
            up = torch.gather(h, 1, parent.clamp(min=0)[..., None].expand(
                -1, -1, h.shape[-1]))
            x = hskip + torch.where((parent >= 0)[..., None], up, _zero(up))
            for i in range(self.dec_depths[s]):
                x = getattr(self, f"dec{s}_block{i}")(x, nbrs[s], sers[s],
                                                      masks[s], generator)
        x = torch.where(g.fine_mask[..., None], x, _zero(x))
        return x, g.world, g.fine_mask
