"""Gaussian-splat predictor: backbone -> per-point Gaussians.

Port of unipre3d_tpu/models/gaussian_predictor.py, object level (the
transformer, PointMLP, Mamba3D and PCM backbones with the object feature
fusion) and scene level (SparseUNet and PTv3 with PointFusion). The backbone
emits 23 channels per point token, split ``[3, 1, 3, 4, 3, 9]`` into xyz
offset / opacity / scale / rotation / SH-DC / SH-rest and activated into a
renderable dict:

* position ``tanh(x) * offset_scale + center``; opacity ``sigmoid``;
* scale ``exp(clamp(x, -1, 20))``; rotation an L2-normalized quaternion
  with a safe norm (``sqrt(sum x^2 + 1e-12)``, floored at 1e-6).

Mamba3D hands the head its learned CLS positional embedding ``[B, 1, C]``
as the centre (the reference's quirk, models/mamba3d.py): its first 3
channels are broadcast as every gaussian's centre.

The VAE's ``decoder_block_3`` map is group-normalized (parameter-free,
stop-gradient) over the whole map. At object level the trainable
per-channel affine and 1x1 conv of ``ImageConv`` are applied after the
fusion gather, to the N gathered rows only (``ImageConv.proj_rows``) —
exact, since both are per-pixel linear maps of a map that carries no
gradient. At scene level they run over the whole map (``ImageConv.forward``)
and the PointFusion merge appends its pixels as extra voxels; the output
dict then carries the validity ``mask`` of its padded rows.

``dtype`` is the compute dtype of every module (flax semantics,
models/layers.py), the parameters staying float32. The VAE features
(live, or ``vae_features`` from the feature cache,
training/feature_cache.py) are cast to it before the group normalisation;
the object path casts the normalized map to it, the scene path applies the
affine to the float32 map, as the JAX package does
(gaussian_predictor.py:258-313). ``activate`` casts the 23 channels to
float32, so the gaussians, the renderer and every kernel stay float32.

At object level the encoder's call (not the Gaussian head) goes through
``EncoderGraphs`` (models/backbone_graph.py), which replays it as CUDA
graphs in a one-device training step and runs it eagerly otherwise.

The JAX package reads no ``backbone_overrides`` for PointMLP, Mamba3D and
PCM and builds them at full width; the port raises if it is given any for
them rather than ignoring them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from unipre3d_tpu_torch.models.backbone_graph import EncoderGraphs
from unipre3d_tpu_torch.models.layers import F32, Dense
from unipre3d_tpu_torch.models.mamba3d import Mamba3DEncoder
from unipre3d_tpu_torch.models.pcm import PointMambaSeg
from unipre3d_tpu_torch.models.pointmlp import PointMLPEncoder
from unipre3d_tpu_torch.models.ptv3 import PointTransformerV3
from unipre3d_tpu_torch.models.scene_geometry import CONV_IMPLS
from unipre3d_tpu_torch.models.sparseunet import SpUNet, SubMConvBlock
from unipre3d_tpu_torch.models.transformer import PointTransformerEncoder
from unipre3d_tpu_torch.models.vae import AutoencoderKL
from unipre3d_tpu_torch.telemetry import mark, span
from unipre3d_tpu_torch.utils.camera import intrinsics_from_fov

# feature_dim/fusion_dim of the backbones the port has
MODEL_CONFIGS = {
    "pointmlp": {"feature_dim": 128, "fusion_dim": 128, "final_dim": 128},
    "transformer": {"feature_dim": 384, "fusion_dim": 384, "final_dim": 384},
    "pcm": {"feature_dim": 384, "fusion_dim": 384, "final_dim": 384},
    "mamba3d": {"feature_dim": 384, "fusion_dim": 384, "final_dim": 384},
    "sparseunet": {"feature_dim": 128, "fusion_dim": 32, "final_dim": 32},
    "ptv3": {"feature_dim": 32, "fusion_dim": 32, "final_dim": 32},
}
# the object backbones built at full width whatever the overrides (JAX's)
FIXED_WIDTH = ("pointmlp", "mamba3d", "pcm")
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
    """The trainable per-channel affine half of a GroupNorm: float32, the
    output in ``dtype``."""

    def __init__(self, ch: int, num_groups: int = 32, epsilon: float = 1e-6,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.num_groups, self.epsilon, self.dtype = num_groups, epsilon, dtype
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def affine(self, xn):
        """Channel-last rows [..., ch] already normalized over the map."""
        return (xn.float() * self.weight + self.bias).to(self.dtype)


class ImageConv(nn.Module):
    """GroupNorm + 1x1 conv over the frozen-VAE map; ``proj_rows`` applies
    its trainable part to gathered, pre-normalized rows."""

    def __init__(self, out_dim: int, feat_ch: int = VAE_FIRST_BLOCK_CHANNELS,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.layers_0 = GroupNormAffine(feat_ch, dtype=dtype)
        self.layers_1 = nn.Conv2d(feat_ch, out_dim, 1)

    def _conv(self, y):
        """The 1x1 conv over channel-last rows, in the compute dtype."""
        w = self.layers_1.weight[:, :, 0, 0].to(self.dtype)
        return F.linear(y, w, self.layers_1.bias.to(self.dtype))

    def forward(self, xn):
        """Pre-normalized map [B, feat_ch, H, W] -> [B, out_dim, H, W]."""
        y = self.layers_0.affine(xn.permute(0, 2, 3, 1))
        return self._conv(y).permute(0, 3, 1, 2)

    def proj_rows(self, xn_rows):
        """Pre-normalized rows [B, N, feat_ch] -> [B, N, out_dim]."""
        return self._conv(self.layers_0.affine(xn_rows))


def split_dimensions(max_sh_degree: int):
    dims = [3, 1, 3, 4, 3]
    if max_sh_degree != 0:
        dims.append(((max_sh_degree + 1) ** 2 - 1) * 3)
    return dims


class FinalHead(nn.Module):
    """Per-token Gaussian parameter head: Linear -> ReLU -> Linear."""

    def __init__(self, dim: int, hidden: int, out: int = 23,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class PointFeaturePredictor(nn.Module):
    """Backbone + final head. ``backbone_overrides`` (dict) is forwarded to
    the backbone constructor (used to cut depth for small runs)."""

    def __init__(self, backbone_type: str, in_channels: int = 3,
                 backbone_overrides=None, dtype: torch.dtype = F32):
        super().__init__()
        if backbone_type in FIXED_WIDTH and backbone_overrides:
            raise ValueError(
                f"backbone {backbone_type!r} takes no backbone_overrides "
                f"(the JAX package builds it at full width), got "
                f"{dict(backbone_overrides)}")
        if backbone_type == "transformer":
            kw = dict(in_channels=in_channels, num_groups=128,
                      encoder_dims=384, depth=16)
            kw.update(backbone_overrides or {})
            self.encoder = PointTransformerEncoder(**kw, dtype=dtype)
            self.final = FinalHead(384, 128, dtype=dtype)
        elif backbone_type == "pointmlp":
            self.encoder = PointMLPEncoder(in_channels=in_channels,
                                           dtype=dtype)
            self.final = FinalHead(128, 64, dtype=dtype)
        elif backbone_type == "mamba3d":
            self.encoder = Mamba3DEncoder(dtype=dtype)
            self.final = FinalHead(384, 128, dtype=dtype)
        elif backbone_type == "pcm":
            self.encoder = PointMambaSeg(in_channels=in_channels, dtype=dtype)
            self.final = FinalHead(128, 64, dtype=dtype)
        elif backbone_type == "sparseunet":
            self.encoder = SpUNet(in_channels=6, num_classes=64,
                                  **(backbone_overrides or {}), dtype=dtype)
            self.final = FinalHead(64, 32, dtype=dtype)
        elif backbone_type == "ptv3":
            self.encoder = PointTransformerV3(
                in_channels=6, **(backbone_overrides or {}), dtype=dtype)
            self.final = FinalHead(self.encoder.dec_channels[0], 32,
                                   dtype=dtype)
        else:
            raise ValueError(f"unsupported backbone: {backbone_type!r}")

    def forward(self, x, image_features=None, c2w=None, fusion_mlp=None,
                intrinsic=None, image_proj=None, generator=None):
        feats, center = self.encoder(
            x, image_features=image_features, c2w=c2w, fusion_mlp=fusion_mlp,
            intrinsic=intrinsic, image_proj=image_proj, generator=generator)
        return self.final(feats), center

    def forward_scene(self, data, image_features=None, unprojected=None,
                      fusion_mlp=None, geometry=None, generator=None):
        """Scene-level forward: (23 channels [B, M', 23], coords [B, M', 3],
        mask [B, M'])."""
        feats, coords, mask = self.encoder.forward_point_fusion(
            data, image_features, unprojected, fusion_mlp, geometry=geometry,
            generator=generator)
        return self.final(feats), coords, mask


class FusionMlp(nn.Module):
    """Linear -> ReLU over [tokens || image features] (flax name layers_0)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = F32):
        super().__init__()
        self.layers_0 = Dense(cin, cout, dtype=dtype)

    def forward(self, x):
        return F.relu(self.layers_0(x))


class GaussianSplatPredictor(nn.Module):
    """Object- or scene-level predictor with the frozen SD-VAE as image
    encoder. The VAE (``image_network``) runs under ``torch.no_grad`` and
    is kept out of the optimizer (training/trainer.py:split_frozen)."""

    def __init__(self, backbone_type: str = "transformer", in_channels: int = 3,
                 max_sh_degree: int = 1, isotropic: bool = False,
                 offset_scale: float = 1.0, use_fusion: bool = True,
                 level: str = "object", fov: float = 49.13434264120263,
                 training_resolution: int = 128, backbone_overrides=None,
                 vae_overrides=None, dtype: torch.dtype = F32):
        super().__init__()
        if level not in ("object", "scene"):
            raise ValueError(f"unknown level {level!r}")
        self.level, self.dtype = level, dtype
        self.backbone_type = backbone_type
        self.max_sh_degree = max_sh_degree
        self.isotropic = isotropic
        self.offset_scale = offset_scale
        self.use_fusion = use_fusion
        self.split_dims = split_dimensions(max_sh_degree)
        mc = MODEL_CONFIGS.get(backbone_type)
        self.point_network = PointFeaturePredictor(
            backbone_type, in_channels, backbone_overrides=backbone_overrides,
            dtype=dtype)
        if use_fusion:
            vo = dict(vae_overrides or {})
            self.image_network = AutoencoderKL(**vo, dtype=dtype)
            self.image_network.requires_grad_(False)
            feat_ch = tuple(vo.get("block_out_channels",
                                   (VAE_FIRST_BLOCK_CHANNELS,)))[0]
            if level == "object":
                self.image_conv = ImageConv(mc["feature_dim"], feat_ch=feat_ch,
                                            dtype=dtype)
                self.fusion_mlps = FusionMlp(mc["feature_dim"] * 2,
                                             mc["fusion_dim"], dtype)
            else:
                self.image_conv = ImageConv(mc["fusion_dim"], feat_ch=feat_ch,
                                            dtype=dtype)
                # the backbone's block size, which JAX's omits (its
                # default, 4, is every config's)
                self.fusion_mlps = SubMConvBlock(
                    mc["fusion_dim"], mc["fusion_dim"], dtype,
                    block_size=getattr(self.point_network.encoder,
                                       "block_size", 4))
        self.register_buffer("intrinsic", torch.from_numpy(np.asarray(
            intrinsics_from_fov(fov, training_resolution))), persistent=False)
        self.encoder_graphs = EncoderGraphs()

    def extract_vae_features(self, image):
        """The frozen VAE's raw ``decoder_block_3`` map, no gradient, in
        the compute dtype: image [N, 3, H, W] -> [N, feat_ch, H, W] (what
        the feature cache stores)."""
        with torch.no_grad():
            return self.image_network(image)["decoder_block_3"]

    def raw_normalized_features(self, image, vae_features=None):
        """VAE ``decoder_block_3`` (live from ``image`` [N, 3, H, W], or
        the cached ``vae_features`` [N, feat_ch, H, W] cast to the compute
        dtype), group-normalized over the map in float32, no gradient ->
        [N, feat_ch, H, W] float32."""
        with torch.no_grad():
            feat = self.extract_vae_features(image) if vae_features is None \
                else vae_features.to(self.dtype)
            gn = self.image_conv.layers_0
            return group_normalize(feat, gn.num_groups, gn.epsilon)

    @staticmethod
    def _flat_views(t):
        return None if t is None else t.reshape(-1, *t.shape[2:])

    def forward(self, point_cloud, image=None, c2w=None, generator=None,
                unprojected_coords=None, geometry=None, vae_features=None):
        """Object: point_cloud [B, N, 3(+)], image [B, V, 3, H, W]
        (conditioning views), c2w [B, V, 4, 4] -> dict of [B, V*G, ...]
        Gaussians. Scene: point_cloud the dict of the scene batch, image,
        unprojected_coords [B, V, H, W, 4] and ``geometry`` (the batch's
        precomputed SpUNetGeometry or PTv3Geometry; None builds it) -> dict
        of [B, M', ...] with ``mask``. ``generator`` draws DropPath's masks
        (and PTv3's order shuffle) in training. ``vae_features`` [B, V,
        feat_ch, H, W] (the feature cache's) stand in for the VAE run on
        ``image``."""
        if self.level == "scene":
            return self._forward_scene(point_cloud, image,
                                       unprojected_coords, geometry,
                                       vae_features, generator)
        fused, extra = {}, ()
        if self.use_fusion:
            B, V = image.shape[:2]
            with span("predictor/frozen_vae"):
                feats = self.raw_normalized_features(
                    self._flat_views(image),
                    self._flat_views(vae_features)).to(self.dtype)
            if V > 1:
                # multi-view union: the backbone runs once per view
                point_cloud = point_cloud.repeat_interleave(V, dim=0)
                c2w = c2w.reshape(B * V, 1, *c2w.shape[2:])
            fused = dict(image_features=feats, c2w=c2w,
                         fusion_mlp=self.fusion_mlps,
                         intrinsic=self.intrinsic,
                         image_proj=self.image_conv.proj_rows)
            extra = (self.fusion_mlps, self.image_conv)
        else:
            B, V = point_cloud.shape[0], 1
        with span(f"predictor/{self.backbone_type}"):
            # the encoder replays as CUDA graphs where it can
            # (models/backbone_graph.py), the head runs eagerly
            tokens, center = self.encoder_graphs(
                self.point_network.encoder, extra, point_cloud, generator,
                **fused)
            out = self.point_network.final(tokens)
        d = self.activate(mark(out, self.backbone_type), center)
        if V > 1:
            d = {k: v.reshape(B, V * v.shape[1], *v.shape[2:])
                 for k, v in d.items()}
        d["xyz"] = mark(d["xyz"], "activate")
        return d

    def _forward_scene(self, point_cloud, image, unprojected, geometry,
                       vae_features=None, generator=None):
        feats = None
        if self.use_fusion:
            with span("predictor/frozen_vae"):
                xn = self.raw_normalized_features(
                    self._flat_views(image), self._flat_views(vae_features))
            feats = mark(self.image_conv(xn), "image_conv")
        with span(f"predictor/{self.backbone_type}"):
            out, coords, mask = self.point_network.forward_scene(
                point_cloud, feats, unprojected,
                self.fusion_mlps if self.use_fusion else None,
                geometry=geometry, generator=generator)
        d = self.activate(mark(out, self.backbone_type), coords)
        d["mask"] = mask
        d["xyz"] = mark(d["xyz"], "activate")
        return d

    def activate(self, out, center) -> Dict[str, torch.Tensor]:
        """23 channels [B, N, 23] + centres [B, N, 3+] (or Mamba3D's [B, 1,
        C], broadcast over the N tokens) -> Gaussian dict."""
        out = out.float()
        xyz_raw, opacity, scaling, rotation, f_dc, *rest = torch.split(
            out, self.split_dims, dim=-1)
        pos = torch.tanh(xyz_raw) * self.offset_scale \
            + center.float()[..., :3].expand_as(xyz_raw)
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


def build_predictor(cfg, dtype: torch.dtype = F32) -> GaussianSplatPredictor:
    """Construct from a composed config, computing in ``dtype``.
    ``tpu.sparse_conv_impl`` (``gather``, the default, or ``block``) is
    SparseUNet's ``conv_impl`` unless ``model.backbone_overrides`` sets
    one, as in JAX; another value raises (JAX would fail later, in the
    geometry)."""
    res = (int(cfg.data.training_resolution)
           if "training_resolution" in cfg.data else
           int(cfg.data.training_height))
    bo = dict(cfg.model.get("backbone_overrides") or {})
    impl = (cfg.get("tpu") or {}).get("sparse_conv_impl")
    if impl is not None and str(impl) not in CONV_IMPLS:
        raise ValueError(f"tpu.sparse_conv_impl {impl!r}: one of "
                         f"{CONV_IMPLS}")
    if impl and cfg.model.backbone_type == "sparseunet":
        bo.setdefault("conv_impl", str(impl))
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
        backbone_overrides=bo,
        vae_overrides=dict(cfg.model.get("vae_overrides") or {}),
        dtype=dtype,
    )
