"""PCM (Point Cloud Mamba): a serialization-ordered Mamba U-Net.

Port of unipre3d_tpu/models/pcm.py (``serialize_reorder``,
``PCMLocalGrouper``, ``PCMStage``, ``MambaBlock``, ``SegHead``,
``PointMambaEncoder``, ``PointMambaDecoder``, ``PointMambaSeg``) with the
UniPre3D pretraining hyperparameters:

* encoder: a ConvBNReLU embedding (384 channels over every input
  channel), then 4 stages of [grouper (FPS / 2 with sorted indices, kNN-12,
  anchor-normalized affine, the residual stream carried through the FPS
  selection) -> PreExtraction -> per layer a space-filling-curve reorder,
  order-prompt tokens and a MambaBlock], mamba blocks [1, 2, 2, 4] over the
  9 orders ``xyz, xzy, yxz, yzx, zxy, zyx, hilbert, z, z-trans``;
* decoder: 3-NN feature propagation back to the full cloud, the image
  fusion at its last layer; SegHead (conv-bn-relu, Dropout 0.5, conv) to
  128 channels a point; the centres handed to the Gaussian head are the
  input cloud.

``MambaBlock`` keeps the reference's residual stream: ``residual +=
drop_path(x)``, ``x = mixer(RMSNorm(residual))``, the residual float32.
The reorder sorts the int64 codes of ops/serialization.py with a *stable*
sort, as ``jnp.argsort`` is: points in one 0.02 voxel tie. The optional
FPS-windowed scan (``use_windows``, off in the pretraining config) folds
windows into the batch axis as the JAX version does. The JAX package wraps
``PCMStage`` and ``MambaBlock`` in ``nn.remat`` to fit TPU memory; that
changes no number, and the port keeps the activations (PERF.md gives the
peak at batch 32).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from unipre3d_tpu_torch.models import fusion as fusion_lib
from unipre3d_tpu_torch.models.layers import F32, Dense, RMSNorm, drop_path
from unipre3d_tpu_torch.models.mamba_mixer import MambaMixer
from unipre3d_tpu_torch.models.pointmlp import (ConvBNReLU,
                                                FeaturePropagation,
                                                PreExtraction,
                                                geometric_affine)
from unipre3d_tpu_torch.ops.point_ops import (furthest_point_sample,
                                              index_points, knn)
from unipre3d_tpu_torch.ops.serialization import encode
from unipre3d_tpu_torch.parallel.distributed import global_rows

PCM_ORDERS = ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx",
              "hilbert", "z", "z-trans")
SER_DEPTH = 10
PROMPT_DIM = 384   # the order-prompt table's width (fixed in the JAX model)


def serialize_reorder(p: torch.Tensor, arrays, order: str,
                      grid_size: float = 0.02):
    """Reorder a batched sequence by the space-filling-curve code of its
    voxelized positions: p [B, N, 3], arrays a list of [B, N, C] (entries
    may be None) -> (p sorted, [arrays sorted])."""
    # a tensor divisor: a Python float divides as a reciprocal product on
    # CUDA and moves points across voxel boundaries; made by a fill on the
    # device, not copied from the host, which would wait for the copy
    g = torch.floor(p / torch.full((), grid_size, dtype=p.dtype,
                                   device=p.device)).int()
    g = g - g.amin(1, keepdim=True)
    g = g.clamp(0, (1 << SER_DEPTH) - 1)
    code = encode(g, order=order, depth=SER_DEPTH)
    idx = torch.sort(code, dim=1, stable=True).indices
    return index_points(p, idx), [None if a is None else index_points(a, idx)
                                  for a in arrays]


def dropout(x, rate: float, generator, training: bool):
    """Elementwise dropout with flax's ``nn.Dropout`` semantics (x / keep
    where kept), the mask drawn from ``generator``: inside ``synced()``,
    the global batch's elementwise mask, of which this rank keeps its rows
    (``global_rows``), as JAX's draw over the data-sharded batch."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = global_rows(lambda n: torch.rand(
        (n,) + tuple(x.shape[1:]), generator=generator, device=x.device),
        x.shape[0]) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class PCMLocalGrouper(nn.Module):
    """FPS downsample (sorted indices: the serialization order survives),
    kNN over the previous level, anchor-normalized affine over
    [points || xyz], concat [grouped || anchor points]."""

    def __init__(self, channel: int, sample_ratio: int, kneighbors: int,
                 use_xyz: bool = True):
        super().__init__()
        self.sample_ratio, self.kneighbors = sample_ratio, kneighbors
        self.use_xyz = use_xyz
        d = channel + (3 if use_xyz else 0)
        self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, d))
        self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, d))

    def forward(self, xyz, points, points_res=None):
        """xyz [B, N, 3], points [B, N, D], points_res [B, N, D] or None ->
        (new_xyz [B, S, 3], grouped [B, S, K, 2D(+3)], new_res)."""
        N = xyz.shape[1]
        S = N // self.sample_ratio
        if S == N:
            new_xyz, new_points = xyz, points
        else:
            fps_idx = torch.sort(furthest_point_sample(xyz, S), dim=-1,
                                 stable=True).values
            new_xyz = index_points(xyz, fps_idx)
            new_points = index_points(points, fps_idx)
            if points_res is not None:
                points_res = index_points(points_res, fps_idx)
        k = min(self.kneighbors, N)
        _, idx = knn(new_xyz, xyz, k)
        grouped = index_points(points, idx)
        anchor = new_points
        if self.use_xyz:
            grouped = torch.cat([grouped, index_points(xyz, idx)], -1)
            anchor = torch.cat([new_points, new_xyz], -1)
        grouped = geometric_affine(grouped, anchor[:, :, None, :],
                                   self.affine_alpha, self.affine_beta)
        return new_xyz, torch.cat(
            [grouped, new_points[:, :, None, :].expand(-1, -1, k, -1)
             .to(grouped.dtype)], -1), points_res


class PCMStage(nn.Module):
    """Grouper + PreExtraction."""

    def __init__(self, cin: int, cout: int, reducer: int, kneighbors: int,
                 pre_blocks: int, dtype: torch.dtype = F32):
        super().__init__()
        self.grouper = PCMLocalGrouper(cin, reducer, kneighbors)
        self.pre = PreExtraction(2 * cin + 3, cout, pre_blocks, dtype=dtype)

    def forward(self, p, x, x_res):
        p, grouped, x_res = self.grouper(p, x, x_res)
        return p, self.pre(grouped), x_res


class MambaBlock(nn.Module):
    """Add -> RMSNorm -> Mamba, the residual stream in float32."""

    def __init__(self, dim: int, drop_path: float = 0.0, bimamba: bool = True,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.drop_path, self.dtype = drop_path, dtype
        self.norm = RMSNorm(dim, eps=1e-5, dtype=dtype)
        self.mixer = MambaMixer(dim, bimamba=bimamba, dtype=dtype)

    def forward(self, x, residual=None, generator=None):
        """x, residual [B, L, D] -> (mixer output, new residual float32)."""
        if residual is None:
            residual = x.float()
        else:
            residual = residual.float() + drop_path(
                x, self.drop_path, generator, self.training).float()
        h = self.mixer(self.norm(residual).to(self.dtype))
        return h, residual


class SegHead(nn.Module):
    """conv-bn-relu (no conv bias) -> Dropout -> conv."""

    def __init__(self, cin: int, num_classes: int, dropout: float = 0.5,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dropout = dropout
        self.conv0 = ConvBNReLU(cin, cin, bias=False, dtype=dtype)
        self.head = Dense(cin, num_classes, dtype=dtype)

    def forward(self, x, generator=None):
        x = dropout(self.conv0(x), self.dropout, generator, self.training)
        return self.head(x)


class PointMambaEncoder(nn.Module):
    """4-stage serialization-ordered Mamba encoder."""

    def __init__(self, in_channels: int = 4, embed_dim: int = 384,
                 dim_expansion: Sequence[int] = (1, 1, 2, 1),
                 pre_blocks: Sequence[int] = (1, 1, 1, 1),
                 mamba_blocks: Sequence[int] = (1, 2, 2, 4),
                 k_neighbors: Sequence[int] = (12, 12, 12, 12),
                 reducers: Sequence[int] = (2, 2, 2, 2),
                 mamba_layers_orders: Sequence[str] = PCM_ORDERS,
                 use_order_prompt: bool = True, prompt_num_per_order: int = 6,
                 drop_path_rate: float = 0.1, grid_size: float = 0.02,
                 use_windows: bool = False, windows_size: int = 1200,
                 dtype: torch.dtype = F32):
        super().__init__()
        if len(mamba_layers_orders) != sum(mamba_blocks):
            raise ValueError("one serialization order per mamba block")
        self.dtype, self.orders = dtype, tuple(mamba_layers_orders)
        self.mamba_blocks = tuple(mamba_blocks)
        self.use_order_prompt = use_order_prompt
        self.n_prompt = prompt_num_per_order
        self.grid_size = grid_size
        self.use_windows, self.windows_size = use_windows, windows_size
        self.embedding = ConvBNReLU(in_channels, embed_dim, bias=False,
                                    dtype=dtype)
        unique = list(dict.fromkeys(self.orders))
        self.order2slot = {o: i for i, o in enumerate(unique)}
        if use_order_prompt:
            self.order_prompt = nn.Parameter(torch.zeros(
                len(unique) * prompt_num_per_order, PROMPT_DIM))
        total = sum(mamba_blocks)
        dpr = [0.0] + [drop_path_rate * i / max(total - 1, 1)
                       for i in range(total)]
        self.channels = [embed_dim]
        layer, last, has_res = 0, embed_dim, False
        for i, nb in enumerate(mamba_blocks):
            out = last * dim_expansion[i]
            self.add_module(f"stage{i}", PCMStage(
                last, out, reducers[i], k_neighbors[i], pre_blocks[i], dtype))
            if has_res and last != out:
                self.add_module(f"residual_proj{i}",
                                Dense(last, out, bias=False, dtype=dtype))
            if nb:
                if use_order_prompt:
                    self.add_module(f"order_prompt_proj{i}", Dense(
                        PROMPT_DIM, out, bias=False, dtype=dtype))
                self.add_module(f"pos_proj{i}",
                                Dense(3, out, bias=False, dtype=dtype))
            for _ in range(nb):
                self.add_module(f"mamba{layer}", MambaBlock(
                    out, drop_path=dpr[layer], dtype=dtype))
                layer += 1
                has_res = True
            self.channels.append(out)
            last = out

    def flax_init(self, generator: torch.Generator) -> None:
        """flax's normal(0.02) order-prompt table."""
        if self.use_order_prompt:
            self.order_prompt.copy_(0.02 * torch.randn(
                self.order_prompt.shape, generator=generator))

    def forward(self, pts, generator=None):
        """pts [B, N, in_channels] -> (p_list, x_list): points and
        channel-last features per stage, index 0 the full cloud."""
        p = pts[..., :3]
        x = self.embedding(pts.to(self.dtype))
        p_list, x_list = [p], [x]
        x_res, cur_order, layer = None, "original", 0
        for i, nb in enumerate(self.mamba_blocks):
            p, x, x_res = getattr(self, f"stage{i}")(p, x, x_res)
            if x_res is not None and hasattr(self, f"residual_proj{i}"):
                x_res = getattr(self, f"residual_proj{i}")(x_res)
            for _ in range(nb):
                order = self.orders[layer]
                if order != cur_order:
                    p, (x, x_res) = serialize_reorder(p, [x, x_res], order,
                                                      self.grid_size)
                    cur_order = order
                p_in, x_in, res_in, n_windows = p, x, x_res, 1
                if self.use_windows and p.shape[1] > self.windows_size:
                    p_in, x_in, res_in, n_windows, p_base, p_std = \
                        self._pre_split(p, x, x_res)
                x_in = x_in + getattr(self, f"pos_proj{i}")(
                    p_in.to(self.dtype))
                if self.use_order_prompt:
                    s = self.order2slot[order] * self.n_prompt
                    prom = getattr(self, f"order_prompt_proj{i}")(
                        self.order_prompt[s:s + self.n_prompt])
                    prom = prom[None].expand(x_in.shape[0], -1, -1)
                    x_in = torch.cat([prom, x_in, prom], 1)
                    if res_in is not None:
                        res_in = torch.cat([prom.float(), res_in,
                                            prom.float()], 1)
                x_in, res_in = getattr(self, f"mamba{layer}")(
                    x_in, res_in, generator)
                if self.use_order_prompt:
                    k = self.n_prompt
                    x_in, res_in = x_in[:, k:-k], res_in[:, k:-k]
                if n_windows > 1:
                    p, x, x_res = self._post_split(p_in, x_in, res_in,
                                                   n_windows, p_base, p_std)
                else:
                    x, x_res = x_in, res_in
                layer += 1
            p_list.append(p)
            x_list.append(x)
        return p_list, x_list

    def _pre_split(self, p, x, x_res):
        """FPS-select a multiple of ``windows_size`` points and fold the
        windows into the batch axis, each window's coordinates renormalized
        to [0, 1)."""
        B, N, _ = x.shape
        W = self.windows_size
        n_windows = N // W
        fps_idx = torch.sort(furthest_point_sample(p, n_windows * W), dim=-1,
                             stable=True).values

        def fold(a):
            return index_points(a, fps_idx).reshape(B * n_windows, W, -1)

        p, x = fold(p), fold(x)
        if x_res is not None:
            x_res = fold(x_res)
        p_base = p.amin(1, keepdim=True)
        p_std = p.amax(1, keepdim=True) - p_base + 1e-6
        return (p - p_base) / p_std, x, x_res, n_windows, p_base, p_std

    @staticmethod
    def _post_split(p, x, x_res, n_windows, p_base, p_std):
        p = p * p_std + p_base
        B = x.shape[0] // n_windows
        p = p.reshape(B, -1, p.shape[-1])
        x = x.reshape(B, -1, x.shape[-1])
        if x_res is not None:
            x_res = x_res.reshape(B, -1, x_res.shape[-1])
        return p, x, x_res


class PointMambaDecoder(nn.Module):
    """Feature propagation back to the full cloud, the image fusion at the
    last decode layer."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channel_list: Sequence[int] = (768, 384, 384, 384),
                 decoder_blocks: Sequence[int] = (1, 1, 1, 1),
                 dtype: torch.dtype = F32):
        super().__init__()
        skips = list(encoder_channels)[::-1]
        dims = [skips[0], *decoder_channel_list]
        self.n_dec = len(dims) - 1
        for i in range(self.n_dec):
            self.add_module(f"decode{i}", FeaturePropagation(
                skips[i + 1] + dims[i], dims[i + 1], decoder_blocks[i],
                bias=True, dtype=dtype))

    def forward(self, p_list, x_list, image_features=None, c2w=None,
                fusion_mlp=None, intrinsic=None, image_proj=None):
        ps, xs = p_list[::-1], x_list[::-1]
        x = xs[0]
        for i in range(self.n_dec):
            x = getattr(self, f"decode{i}")(ps[i + 1], ps[i], xs[i + 1], x)
            if i == self.n_dec - 1 and fusion_mlp is not None:
                x = fusion_lib.feature_fusion(
                    x, ps[i + 1][..., :3], image_features, c2w, intrinsic,
                    fusion_mlp, image_proj)
        return x


class PointMambaSeg(nn.Module):
    """Encoder + decoder + SegHead -> (tokens [B, N, 128], centres = the
    input cloud [B, N, 3])."""

    def __init__(self, in_channels: int = 4, num_classes: int = 128,
                 use_windows: bool = False, dtype: torch.dtype = F32):
        super().__init__()
        self.encoder = PointMambaEncoder(in_channels=in_channels,
                                         use_windows=use_windows, dtype=dtype)
        self.decoder = PointMambaDecoder(self.encoder.channels, dtype=dtype)
        self.head = SegHead(384, num_classes, dtype=dtype)

    def forward(self, pts, image_features=None, c2w=None, fusion_mlp=None,
                intrinsic=None, image_proj=None, generator=None):
        p_list, x_list = self.encoder(pts, generator)
        x = self.decoder(p_list, x_list, image_features, c2w, fusion_mlp,
                         intrinsic, image_proj)
        return self.head(x, generator), p_list[0]
