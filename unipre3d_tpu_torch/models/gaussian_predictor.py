"""Gaussian-splat predictor, object level: backbone -> per-point Gaussians.

Port of the object path of unipre3d_tpu/models/gaussian_predictor.py: the
transformer backbone with the frozen-VAE feature fusion emits 23 channels
per point token, split ``[3, 1, 3, 4, 3, 9]`` into xyz offset / opacity /
scale / rotation / SH-DC / SH-rest and activated into a renderable dict:

* position ``tanh(x) * offset_scale + center``; opacity ``sigmoid``;
* scale ``exp(clamp(x, -1, 20))``; rotation an L2-normalized quaternion
  with a safe norm (``sqrt(sum x^2 + 1e-12)``, floored at 1e-6).

The VAE's ``decoder_block_3`` map is group-normalized (parameter-free,
stop-gradient) over the whole map; the trainable per-channel affine and
1x1 conv of ``ImageConv`` are applied after the fusion gather, to the N
gathered rows only (``ImageConv.proj_rows``) — exact, since both are
per-pixel linear maps of a map that carries no gradient.

Other backbones and ``level=scene`` are later slices (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from unipre3d_tpu_torch.models.transformer import PointTransformerEncoder
from unipre3d_tpu_torch.models.vae import AutoencoderKL
from unipre3d_tpu_torch.utils.camera import intrinsics_from_fov

# feature_dim/fusion_dim of the object backbones this slice has
MODEL_CONFIGS = {
    "transformer": {"feature_dim": 384, "fusion_dim": 384, "final_dim": 384},
}
VAE_FIRST_BLOCK_CHANNELS = 128


def group_normalize(x: torch.Tensor, num_groups: int,
                    epsilon: float) -> torch.Tensor:
    """Parameter-free GroupNorm of an NCHW map (stats over each group's
    channels and all pixels), float32, two-pass variance."""
    B, C, H, W = x.shape
    g = x.float().reshape(B, num_groups, C // num_groups, H, W)
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    return ((g - mean) * torch.rsqrt(var + epsilon)).reshape(B, C, H, W)


class GroupNormAffine(nn.Module):
    """The trainable per-channel affine half of a GroupNorm."""

    def __init__(self, ch: int, num_groups: int = 32, epsilon: float = 1e-6):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def affine(self, xn):
        """Channel-last rows [..., ch] already normalized over the map."""
        return xn.float() * self.weight + self.bias


class ImageConv(nn.Module):
    """GroupNorm + 1x1 conv over the frozen-VAE map; ``proj_rows`` applies
    its trainable part to gathered, pre-normalized rows."""

    def __init__(self, out_dim: int, feat_ch: int = VAE_FIRST_BLOCK_CHANNELS):
        super().__init__()
        self.layers_0 = GroupNormAffine(feat_ch)
        self.layers_1 = nn.Conv2d(feat_ch, out_dim, 1)

    def proj_rows(self, xn_rows):
        """Pre-normalized rows [B, N, feat_ch] -> [B, N, out_dim]."""
        y = self.layers_0.affine(xn_rows)
        w = self.layers_1.weight[:, :, 0, 0]
        return F.linear(y, w, self.layers_1.bias)


def split_dimensions(max_sh_degree: int):
    dims = [3, 1, 3, 4, 3]
    if max_sh_degree != 0:
        dims.append(((max_sh_degree + 1) ** 2 - 1) * 3)
    return dims


class FinalHead(nn.Module):
    """Per-token Gaussian parameter head: Linear -> ReLU -> Linear."""

    def __init__(self, dim: int, hidden: int, out: int = 23):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class PointFeaturePredictor(nn.Module):
    """Backbone + final head. ``backbone_overrides`` (dict) is forwarded to
    the backbone constructor (used to cut depth for small runs)."""

    def __init__(self, backbone_type: str, in_channels: int = 3,
                 backbone_overrides=None):
        super().__init__()
        if backbone_type != "transformer":
            raise NotImplementedError(
                f"backbone {backbone_type!r} is not ported yet (ROADMAP.md "
                f"queue A, slice 2: the other object backbones)")
        kw = dict(in_channels=in_channels, num_groups=128, encoder_dims=384,
                  depth=16)
        kw.update(backbone_overrides or {})
        self.encoder = PointTransformerEncoder(**kw)
        self.final = FinalHead(384, 128)

    def forward(self, x, image_features=None, c2w=None, fusion_mlp=None,
                intrinsic=None, image_proj=None, generator=None):
        feats, center = self.encoder(
            x, image_features=image_features, c2w=c2w, fusion_mlp=fusion_mlp,
            intrinsic=intrinsic, image_proj=image_proj, generator=generator)
        return self.final(feats), center


class FusionMlp(nn.Module):
    """Linear -> ReLU over [tokens || image features] (flax name layers_0)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layers_0 = nn.Linear(cin, cout)

    def forward(self, x):
        return F.relu(self.layers_0(x))


class GaussianSplatPredictor(nn.Module):
    """Object-level predictor with the frozen SD-VAE as image encoder. The
    VAE (``image_network``) runs under ``torch.no_grad`` and is kept out of
    the optimizer (training/trainer.py:split_frozen)."""

    def __init__(self, backbone_type: str = "transformer", in_channels: int = 3,
                 max_sh_degree: int = 1, isotropic: bool = False,
                 offset_scale: float = 1.0, use_fusion: bool = True,
                 level: str = "object", fov: float = 49.13434264120263,
                 training_resolution: int = 128, backbone_overrides=None,
                 vae_overrides=None):
        super().__init__()
        if level != "object":
            raise NotImplementedError(
                "level=scene is not ported yet (ROADMAP.md queue A, slice 3: "
                "the scene path with SparseUNet)")
        self.max_sh_degree = max_sh_degree
        self.isotropic = isotropic
        self.offset_scale = offset_scale
        self.use_fusion = use_fusion
        self.split_dims = split_dimensions(max_sh_degree)
        mc = MODEL_CONFIGS.get(backbone_type)
        self.point_network = PointFeaturePredictor(
            backbone_type, in_channels, backbone_overrides=backbone_overrides)
        if use_fusion:
            vo = dict(vae_overrides or {})
            self.image_network = AutoencoderKL(**vo)
            self.image_network.requires_grad_(False)
            feat_ch = tuple(vo.get("block_out_channels",
                                   (VAE_FIRST_BLOCK_CHANNELS,)))[0]
            self.image_conv = ImageConv(mc["feature_dim"], feat_ch=feat_ch)
            self.fusion_mlps = FusionMlp(mc["feature_dim"] * 2,
                                         mc["fusion_dim"])
        self.register_buffer("intrinsic", torch.from_numpy(np.asarray(
            intrinsics_from_fov(fov, training_resolution))), persistent=False)

    def raw_normalized_features(self, image):
        """Frozen VAE ``decoder_block_3``, group-normalized over the map,
        no gradient: image [N, 3, H, W] -> [N, feat_ch, H, W]."""
        with torch.no_grad():
            feat = self.image_network(image)["decoder_block_3"]
            gn = self.image_conv.layers_0
            return group_normalize(feat, gn.num_groups, gn.epsilon)

    def forward(self, point_cloud, image=None, c2w=None, generator=None):
        """point_cloud [B, N, 3(+)], image [B, V, 3, H, W] (conditioning
        views), c2w [B, V, 4, 4] -> dict of [B, V*G, ...] Gaussians."""
        if self.use_fusion:
            B, V = image.shape[:2]
            with record_function("predictor/frozen_vae"):
                feats = self.raw_normalized_features(
                    image.reshape(B * V, *image.shape[2:]))
            if V > 1:
                # multi-view union: the backbone runs once per view
                point_cloud = point_cloud.repeat_interleave(V, dim=0)
                c2w = c2w.reshape(B * V, 1, *c2w.shape[2:])
            out, center = self.point_network(
                point_cloud, image_features=feats, c2w=c2w,
                fusion_mlp=self.fusion_mlps, intrinsic=self.intrinsic,
                image_proj=self.image_conv.proj_rows, generator=generator)
        else:
            B, V = point_cloud.shape[0], 1
            out, center = self.point_network(point_cloud, generator=generator)
        d = self.activate(out, center)
        if V > 1:
            d = {k: v.reshape(B, V * v.shape[1], *v.shape[2:])
                 for k, v in d.items()}
        return d

    def activate(self, out, center) -> Dict[str, torch.Tensor]:
        """23 channels [B, N, 23] + centers [B, N, 3] -> Gaussian dict."""
        out = out.float()
        xyz_raw, opacity, scaling, rotation, f_dc, *rest = torch.split(
            out, self.split_dims, dim=-1)
        pos = torch.tanh(xyz_raw) * self.offset_scale + center.float()[..., :3]
        if self.isotropic:
            scaling = scaling[..., :1].expand_as(scaling)
        rot_norm = torch.sqrt((rotation ** 2).sum(-1, keepdim=True) + 1e-12)
        d = {
            "xyz": pos,
            "opacity": torch.sigmoid(opacity),
            "scaling": torch.exp(torch.clamp(scaling, -1, 20)),
            "rotation": rotation / torch.clamp_min(rot_norm, 1e-6),
            "features_dc": f_dc.reshape(*f_dc.shape[:-1], 1, 3),
        }
        if self.max_sh_degree > 0:
            d["features_rest"] = rest[0].reshape(*rest[0].shape[:-1], -1, 3)
        else:
            d["features_rest"] = out.new_zeros(*f_dc.shape[:-1], 0, 3)
        return d


def build_predictor(cfg) -> GaussianSplatPredictor:
    """Construct from a composed config."""
    res = (int(cfg.data.training_resolution)
           if "training_resolution" in cfg.data else
           int(cfg.data.training_height))
    return GaussianSplatPredictor(
        backbone_type=cfg.model.backbone_type,
        in_channels=int(cfg.model.in_channels),
        max_sh_degree=int(cfg.model.max_sh_degree),
        isotropic=bool(cfg.model.isotropic),
        offset_scale=float(cfg.model.offset_scale),
        use_fusion=bool(cfg.opt.use_fusion),
        level=cfg.opt.level,
        fov=float(cfg.data.fov),
        training_resolution=res,
        backbone_overrides=dict(cfg.model.get("backbone_overrides") or {}),
        vae_overrides=dict(cfg.model.get("vae_overrides") or {}),
    )
