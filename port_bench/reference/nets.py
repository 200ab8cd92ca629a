"""Plain reference of the object-level Gaussian predictor.

A frozen copy of the PyTorch port's model code for one process
(unipre3d_tpu_torch/models/layers.py, transformer.py, fusion.py, vae.py,
gaussian_predictor.py and ops/point_ops.py as of the benchmark's first
version), with three changes: no distribution over ranks, the compute
dtype replaced by a ``Rounding`` (precision.py) applied where the port
casts, and only what the transformer object predictor runs. Module and
parameter names are the port's, so one state dict loads into both.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from port_bench.reference.precision import Rounding

LN_EPS = 1e-6
GN_EPS = 1e-6


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

class Dense(nn.Linear):
    def __init__(self, cin, cout, bias=True, q: Rounding = None):
        super().__init__(cin, cout, bias=bias, device="meta")
        self.q = q

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.q(self.bias))


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim, q: Rounding):
        super().__init__(dim, eps=LN_EPS, device="meta")
        self.q = q

    def forward(self, x):
        return self.q(F.layer_norm(x.float(), self.normalized_shape,
                                   self.weight, self.bias, self.eps))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out, q):
        super().__init__()
        self.fc1 = Dense(dim, hidden, q=q)
        self.fc2 = Dense(hidden, out, q=q)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim, num_heads, q):
        super().__init__()
        self.num_heads, self.q = num_heads, q
        self.qkv = Dense(dim, dim * 3, bias=False, q=q)
        self.proj = Dense(dim, dim, q=q)

    def forward(self, x):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd)
        qq, k, v = qkv.unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", qq, k) * (hd ** -0.5)
        attn = self.q(torch.softmax(attn.float(), dim=-1))
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        return self.proj(out)


def drop_path(x, rate, generator, training):
    """Per-sample stochastic depth, the keep mask drawn from ``generator``
    as the port draws it."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                      generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Block(nn.Module):
    def __init__(self, dim, num_heads, drop_path_rate, q):
        super().__init__()
        self.drop_path = drop_path_rate
        self.norm1 = LayerNorm(dim, q)
        self.attn = Attention(dim, num_heads, q)
        self.norm2 = LayerNorm(dim, q)
        self.mlp = Mlp(dim, dim * 4, dim, q)

    def forward(self, x, generator=None):
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path,
                          generator, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path,
                             generator, self.training)


class FlaxBatchNorm(nn.Module):
    """Batch statistics E[x^2] - E[x]^2 (clamped), eps 1e-5, float32;
    running statistics 0.99 r + 0.01 batch (the biased variance)."""

    def __init__(self, ch, q, eps=1e-5):
        super().__init__()
        self.q, self.eps = q, eps
        self.weight = nn.Parameter(torch.empty(ch, device="meta"))
        self.bias = nn.Parameter(torch.empty(ch, device="meta"))
        self.register_buffer("running_mean", torch.empty(ch, device="meta"))
        self.register_buffer("running_var", torch.empty(ch, device="meta"))

    def forward(self, x):
        flat = x.reshape(-1, x.shape[-1]).float()
        mean, sq = flat.mean(0), (flat * flat).mean(0)
        var = torch.clamp_min(sq - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.99).add_(0.01 * mean)
            self.running_var.mul_(0.99).add_(0.01 * var)
        return self.q((x - mean) * (torch.rsqrt(var + self.eps) * self.weight)
                      + self.bias)


class PointGroupEncoder(nn.Module):
    def __init__(self, encoder_channel, q):
        super().__init__()
        self.encoder_channel, self.q = encoder_channel, q
        self.conv1 = Dense(3, 128, q=q)
        self.bn1 = FlaxBatchNorm(128, q)
        self.conv2 = Dense(128, 256, q=q)
        self.conv3 = Dense(512, 512, q=q)
        self.bn2 = FlaxBatchNorm(512, q)
        self.conv4 = Dense(512, encoder_channel, q=q)

    def forward(self, point_groups):
        B, G, K, _ = point_groups.shape
        x = self.q(point_groups.reshape(B * G, K, 3))
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)
        g = x.amax(dim=1, keepdim=True)
        x = torch.cat([g.expand_as(x), x], dim=-1)
        x = F.relu(self.bn2(self.conv3(x)))
        x = self.conv4(x).amax(dim=1)
        return x.reshape(B, G, self.encoder_channel)


# --------------------------------------------------------------------------
# point grouping (FPS + ball query)
# --------------------------------------------------------------------------

def square_distance(src, dst):
    dist = -2.0 * torch.einsum("bnc,bmc->bnm", src, dst)
    dist = dist + (src.float() ** 2).sum(-1, keepdim=True)
    return dist + (dst.float() ** 2).sum(-1)[:, None, :]


def furthest_point_sample(xyz, npoint):
    """Farthest point sampling from index 0, ties to the first index, the
    distances formed as |x|^2 - 2 x.last + |last|^2."""
    B, N, C = xyz.shape
    xyz = xyz.float()
    sq_norm = (xyz * xyz).sum(-1)
    min_dist = torch.full((B, N), 1e10, device=xyz.device)
    idx = torch.zeros(B, npoint, dtype=torch.long, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        p = torch.gather(xyz, 1, last[:, None, None].expand(B, 1, C))
        p_sq = torch.gather(sq_norm, 1, last[:, None])
        d = sq_norm - 2.0 * torch.einsum("bnc,bmc->bn", xyz, p) + p_sq
        min_dist = torch.minimum(min_dist, d)
        last = torch.argmax(min_dist, dim=-1)
        idx[:, i] = last
    return idx


def ball_query(radius, nsample, support, query):
    """The first ``nsample`` in-radius indices in point order, padded with
    the first one found (index 0 when there is none)."""
    N = support.shape[1]
    inball = square_distance(query, support) < radius * radius
    iota = torch.arange(N, device=support.device)
    order_key = torch.where(inball, iota, N + iota)
    sorted_idx = torch.argsort(order_key, dim=-1)[..., :nsample]
    count = inball.sum(-1, keepdim=True)
    first = torch.where(count > 0, sorted_idx[..., 0:1],
                        torch.zeros_like(sorted_idx[..., 0:1]))
    slot = torch.arange(sorted_idx.shape[-1], device=support.device)
    return torch.where(slot < count, sorted_idx, first)


def index_points(points, idx):
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def subsample_group(pts, num_groups, group_size, radius):
    centers = index_points(pts, furthest_point_sample(pts, num_groups))
    idx = ball_query(radius, group_size, pts, centers)
    return index_points(pts, idx) - centers[:, :, None, :], centers


# --------------------------------------------------------------------------
# transformer backbone and the object fusion
# --------------------------------------------------------------------------

def feature_fusion_gather(center, image_features, c2w, intrinsic,
                          image_proj):
    """Occlusion-aware image features of the token centres (the x
    projection indexes image rows, as the reference's)."""
    if c2w.ndim == 4:
        c2w = c2w[:, 0]
    B, N = center.shape[:2]
    C, H, W = image_features.shape[1:]
    hom = torch.cat([center, torch.ones(B, N, 1, dtype=center.dtype,
                                        device=center.device)], dim=-1)
    w2c = torch.linalg.inv(c2w.transpose(-1, -2))
    cam = torch.einsum("bij,bnj->bni", w2c, hom)
    z = cam[..., 2]
    px = cam[..., 0] * intrinsic[0, 0] / z + intrinsic[0, 2]
    py = cam[..., 1] * intrinsic[1, 1] / z + intrinsic[1, 2]
    pix = torch.round(torch.stack([px, py], dim=-1)).long()
    x, y = pix[..., 0], pix[..., 1]
    inside = (x >= 0) & (y >= 0) & (x < H) & (y < W) & (z >= 0)
    flat_id = y.clamp(0, W - 1) * H + x.clamp(0, H - 1)
    masked = torch.where(inside, z, torch.full_like(z, float("inf")))
    min_depth = torch.full((B, H * W), float("inf"), dtype=z.dtype,
                           device=z.device)
    min_depth = min_depth.scatter_reduce(1, flat_id, masked, "amin",
                                         include_self=True)
    winner = inside & (masked == torch.gather(min_depth, 1, flat_id))
    feats = image_features.reshape(B, C, H * W).transpose(1, 2)
    rows = x.clamp(0, H - 1) * W + y.clamp(0, W - 1)
    gathered = image_proj(torch.gather(feats, 1,
                                       rows[..., None].expand(-1, -1, C)))
    return torch.where(winner[..., None], gathered,
                       torch.zeros_like(gathered))


class PointTransformerEncoder(nn.Module):
    def __init__(self, q, num_groups=128, group_size=32, radius=0.1,
                 dim=384, depth=16, num_heads=6, drop_path_rate=0.1):
        super().__init__()
        self.num_groups, self.group_size, self.radius = (
            num_groups, group_size, radius)
        self.depth, self.q = depth, q
        self.encoder = PointGroupEncoder(dim, q)
        self.reduce_dim = Dense(dim, dim, q=q)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, device="meta"))
        self.cls_pos = nn.Parameter(torch.empty(1, 1, dim, device="meta"))
        self.pos_embed_fc1 = Dense(3, 128, q=q)
        self.pos_embed_fc2 = Dense(128, dim, q=q)
        for i in range(depth):
            self.add_module(f"block{i}", Block(
                dim, num_heads, drop_path_rate * i / max(depth - 1, 1), q))
        self.norm = LayerNorm(dim, q)

    def forward(self, pts, image_features, c2w, fusion_mlp, intrinsic,
                image_proj, generator):
        neighborhood, center = subsample_group(
            pts[:, :, :3], self.num_groups, self.group_size, self.radius)
        tokens = self.reduce_dim(self.encoder(neighborhood))
        B, _, D = tokens.shape
        pos = self.pos_embed_fc2(F.gelu(self.pos_embed_fc1(center)))
        x = torch.cat([self.q(self.cls_token.expand(B, 1, D)), tokens], 1)
        pos = torch.cat([self.q(self.cls_pos.expand(B, 1, D)), pos], 1)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x + pos, generator)
            if i == self.depth - 1:
                mapped = feature_fusion_gather(center, image_features, c2w,
                                               intrinsic, image_proj)
                mapped = torch.cat([mapped.new_zeros(B, 1, mapped.shape[-1]),
                                    mapped], 1)
                x = fusion_mlp(torch.cat([x, self.q(mapped)], dim=-1))
        return self.norm(x)[:, 1:, :], center


# --------------------------------------------------------------------------
# the frozen SD-VAE (AutoencoderKL), diffusers' module names
# --------------------------------------------------------------------------

class Conv2d(nn.Conv2d):
    def __init__(self, cin, cout, k, q, stride=1, padding=0):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         device="meta")
        self.q = q

    def forward(self, x):
        return self._conv_forward(self.q(x), self.q(self.weight),
                                  self.q(self.bias))


class GroupNorm(nn.GroupNorm):
    def __init__(self, ch, q):
        super().__init__(32, ch, eps=GN_EPS, device="meta")
        self.q = q

    def forward(self, x):
        return self.q(F.group_norm(x.float(), self.num_groups, self.weight,
                                   self.bias, self.eps))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, q):
        super().__init__()
        self.norm1 = GroupNorm(cin, q)
        self.conv1 = Conv2d(cin, cout, 3, q, padding=1)
        self.norm2 = GroupNorm(cout, q)
        self.conv2 = Conv2d(cout, cout, 3, q, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1, q) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        sc = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return sc + h


class AttnBlock(nn.Module):
    def __init__(self, c, q):
        super().__init__()
        self.q = q
        self.group_norm = GroupNorm(c, q)
        self.to_q = Dense(c, c, q=q)
        self.to_k = Dense(c, c, q=q)
        self.to_v = Dense(c, c, q=q)
        self.to_out = nn.ModuleList([Dense(c, c, q=q)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        qq, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = self.q(torch.softmax((qq @ k.transpose(1, 2)) * C ** -0.5,
                                    dim=-1))
        h = self.to_out[0](attn @ v)
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class MidBlock(nn.Module):
    def __init__(self, c, q):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, c, q),
                                      ResnetBlock2D(c, c, q)])
        self.attentions = nn.ModuleList([AttnBlock(c, q)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Conv(nn.Module):
    def __init__(self, c, stride, padding, q):
        super().__init__()
        self.conv = Conv2d(c, c, 3, q, stride=stride, padding=padding)


class DownBlock(nn.Module):
    def __init__(self, cin, cout, layers, last, q):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, q)
             for j in range(layers)])
        self.downsamplers = None if last else nn.ModuleList(
            [_Conv(cout, 2, 0, q)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class UpBlock(nn.Module):
    def __init__(self, cin, cout, layers, last, q):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, q)
             for j in range(layers + 1)])
        self.upsamplers = None if last else nn.ModuleList(
            [_Conv(cout, 1, 1, q)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = self.upsamplers[0].conv(x)
        return x


class Encoder(nn.Module):
    def __init__(self, chans, layers, latent, q):
        super().__init__()
        self.conv_in = Conv2d(3, chans[0], 3, q, padding=1)
        self.down_blocks = nn.ModuleList(
            [DownBlock(chans[max(i - 1, 0)], c, layers, i == len(chans) - 1,
                       q) for i, c in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1], q)
        self.conv_norm_out = GroupNorm(chans[-1], q)
        self.conv_out = Conv2d(chans[-1], 2 * latent, 3, q, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for b in self.down_blocks:
            x = b(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class Decoder(nn.Module):
    """Up to the block whose output the fusion reads (``decoder_block_3``,
    the last); its conv_out is built for the names but not run."""

    def __init__(self, chans, layers, latent, q):
        super().__init__()
        rev = list(reversed(chans))
        self.conv_in = Conv2d(latent, rev[0], 3, q, padding=1)
        self.mid_block = MidBlock(rev[0], q)
        self.up_blocks = nn.ModuleList(
            [UpBlock(rev[max(i - 1, 0)], c, layers, i == len(rev) - 1, q)
             for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1], q)
        self.conv_out = Conv2d(rev[-1], 3, 3, q, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for b in self.up_blocks:
            x = b(x)
        return x


class AutoencoderKL(nn.Module):
    def __init__(self, q, block_out_channels: Sequence[int] = (128, 256, 512,
                                                              512),
                 layers_per_block=2, latent_channels=4):
        super().__init__()
        chans = tuple(block_out_channels)
        self.latent = latent_channels
        self.encoder = Encoder(chans, layers_per_block, latent_channels, q)
        self.decoder = Decoder(chans, layers_per_block, latent_channels, q)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1,
                                 q)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1, q)

    def forward(self, images):
        """images [N, 3, H, W] -> decoder_block_3 [N, C, H, W] (the
        posterior's mode decoded)."""
        moments = self.quant_conv(self.encoder(images))
        return self.decoder(self.post_quant_conv(moments[:, :self.latent]))


# --------------------------------------------------------------------------
# the predictor
# --------------------------------------------------------------------------

def group_normalize(x, num_groups=32, epsilon=1e-6):
    B, C, H, W = x.shape
    g = x.float().reshape(B, num_groups, C // num_groups, H, W)
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    return ((g - mean) * torch.rsqrt(var + epsilon)).reshape(B, C, H, W)


class GroupNormAffine(nn.Module):
    def __init__(self, ch, q):
        super().__init__()
        self.q = q
        self.weight = nn.Parameter(torch.empty(ch, device="meta"))
        self.bias = nn.Parameter(torch.empty(ch, device="meta"))


class ImageConv(nn.Module):
    def __init__(self, out_dim, feat_ch, q):
        super().__init__()
        self.q = q
        self.layers_0 = GroupNormAffine(feat_ch, q)
        self.layers_1 = nn.Conv2d(feat_ch, out_dim, 1, device="meta")

    def proj_rows(self, xn_rows):
        gn = self.layers_0
        y = self.q(xn_rows.float() * gn.weight + gn.bias)
        w = self.layers_1.weight[:, :, 0, 0]
        return F.linear(y, self.q(w), self.q(self.layers_1.bias))


class FinalHead(nn.Module):
    def __init__(self, dim, hidden, out, q):
        super().__init__()
        self.fc1 = Dense(dim, hidden, q=q)
        self.fc2 = Dense(hidden, out, q=q)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class PointFeaturePredictor(nn.Module):
    def __init__(self, q, depth):
        super().__init__()
        self.encoder = PointTransformerEncoder(q, depth=depth)
        self.final = FinalHead(384, 128, 23, q)


class FusionMlp(nn.Module):
    def __init__(self, cin, cout, q):
        super().__init__()
        self.layers_0 = Dense(cin, cout, q=q)

    def forward(self, x):
        return F.relu(self.layers_0(x))


def intrinsics_from_fov(fov_deg, resolution):
    K = np.zeros((3, 4), dtype=np.float32)
    focal = (resolution / 2.0) / math.tan(math.radians(fov_deg / 2.0))
    K[0, 0] = K[1, 1] = focal
    K[0, 2] = K[1, 2] = resolution / 2.0
    K[2, 2] = 1.0
    return K


class ObjectPredictor(nn.Module):
    """Transformer backbone with the object fusion of the frozen VAE's
    ``decoder_block_3`` and the Gaussian head (23 channels: xyz offset,
    opacity, scale, rotation, SH DC, SH rest of degree 1)."""

    def __init__(self, q: Rounding, fov: float, resolution: int,
                 offset_scale: float = 1.0, depth: int = 16,
                 vae: dict = None):
        super().__init__()
        self.q, self.offset_scale = q, offset_scale
        self.point_network = PointFeaturePredictor(q, depth)
        vae = dict(vae or {})
        self.image_network = AutoencoderKL(q, **vae)
        self.image_network.requires_grad_(False)
        feat_ch = list(vae.get("block_out_channels", [128]))[0]
        self.image_conv = ImageConv(384, feat_ch, q)
        self.fusion_mlps = FusionMlp(768, 384, q)
        self.intrinsic = torch.from_numpy(intrinsics_from_fov(fov,
                                                              resolution))

    def vae_features(self, images):
        """Conditioning images [N, 3, H, W] -> decoder_block_3."""
        with torch.no_grad():
            return self.image_network(images)

    def forward(self, point_cloud, image, c2w, generator,
                vae_features=None) -> Dict[str, torch.Tensor]:
        B = image.shape[0]
        with torch.no_grad():
            feat = self.vae_features(image[:, 0]) if vae_features is None \
                else vae_features
            feats = self.q(group_normalize(self.q(feat)))
        out, center = self.point_network.encoder(
            point_cloud, feats, c2w[:, :1].reshape(B, 1, 4, 4),
            self.fusion_mlps, self.intrinsic.to(point_cloud.device),
            self.image_conv.proj_rows, generator)
        out = self.point_network.final(out).float()
        xyz, opacity, scaling, rotation, f_dc, rest = torch.split(
            out, [3, 1, 3, 4, 3, 9], dim=-1)
        rot_norm = torch.sqrt((rotation ** 2).sum(-1, keepdim=True) + 1e-12)
        return {
            "xyz": torch.tanh(xyz) * self.offset_scale + center.float(),
            "opacity": torch.sigmoid(opacity),
            "scaling": torch.exp(torch.clamp(scaling, -1, 20)),
            "rotation": rotation / torch.clamp_min(rot_norm, 1e-6),
            "features_dc": f_dc.reshape(*f_dc.shape[:-1], 1, 3),
            "features_rest": rest.reshape(*rest.shape[:-1], 3, 3),
        }
