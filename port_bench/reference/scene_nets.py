"""Plain reference of the scene-level Gaussian predictor (SparseUNet with
PointFusion).

A frozen copy of the PyTorch port's scene code for one process
(unipre3d_tpu_torch/ops/sparse.py, models/scene_geometry.py,
models/sparseunet.py and the scene half of gaussian_predictor.py as of
the benchmark's first version): the gather executor only, no
distribution over ranks, the compute dtype replaced by a ``Rounding``
(precision.py) applied where the port casts. It builds the batch's index
structures itself from the batch. Module and parameter names are the
port's, so one state dict loads into both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from port_bench.reference.nets import (AutoencoderKL, Dense, FinalHead,
                                       GroupNormAffine, group_normalize)
from port_bench.reference.precision import Rounding

CODE_BITS = 10
INVALID_CODE = 0xFFFFFFFF


# --------------------------------------------------------------------------
# voxel sets and their index structures (one scene)
# --------------------------------------------------------------------------

def pack_code(coords, mask):
    c = coords.clamp(0, (1 << CODE_BITS) - 1).long()
    code = (c[:, 0] << (2 * CODE_BITS)) | (c[:, 1] << CODE_BITS) | c[:, 2]
    return torch.where(mask, code, torch.full_like(code, INVALID_CODE))


def argsort(key):
    return torch.sort(key, stable=True).indices


def kernel_offsets(k):
    r = k // 2
    return np.asarray([(dx, dy, dz) for dx in range(-r, r + 1)
                       for dy in range(-r, r + 1)
                       for dz in range(-r, r + 1)], dtype=np.int32)


def merge_lookup(codes, tgt):
    """Row of the LAST code equal to each target in the sorted codes, or
    -1."""
    T = codes.shape[0]
    t = tgt.reshape(-1)
    cand = torch.searchsorted(codes.contiguous(), t, right=True) - 1
    safe = cand.clamp(0, T - 1)
    found = (cand >= 0) & (codes[safe] == t)
    return torch.where(found, safe, torch.full_like(safe, -1)).reshape(
        tgt.shape)


def find_neighbors(coords, mask, k):
    """k^3 submanifold neighbour table of a canonical set: [M, k^3], the
    row at coords + offset (the last of a duplicate run), or -1."""
    M = coords.shape[0]
    codes = pack_code(coords, mask)
    offs = torch.as_tensor(kernel_offsets(k), dtype=torch.int64,
                           device=coords.device)
    tgt_coords = coords[:, None, :].long() + offs[None]
    in_range = ((tgt_coords >= 0) & (tgt_coords < (1 << CODE_BITS))).all(-1)
    tgt_mask = mask[:, None] & in_range
    tgt = pack_code(tgt_coords.reshape(-1, 3),
                    tgt_mask.reshape(-1)).reshape(M, -1)
    found = merge_lookup(codes, tgt)
    return torch.where(tgt == INVALID_CODE, torch.full_like(found, -1), found)


def first_of_runs(code_s, valid):
    first = torch.ones_like(valid)
    first[1:] = code_s[1:] != code_s[:-1]
    return first & valid


def slot_of(child):
    return child[:, 0] * 4 + child[:, 1] * 2 + child[:, 2]


class Down(NamedTuple):
    order: torch.Tensor
    seg: torch.Tensor
    slot_sorted: torch.Tensor
    valid_sorted: torch.Tensor
    coords: torch.Tensor
    mask: torch.Tensor
    parent_idx: torch.Tensor
    child_offset: torch.Tensor


def downsample_structure(coords, mask, cap):
    """Distinct parents (coords >> 1) in code order, the first ``cap``
    kept."""
    M, dev = coords.shape[0], coords.device
    parent = coords >> 1
    pcode = pack_code(parent, mask)
    order = argsort(pcode)
    pcode_s, parent_s = pcode[order], parent[order]
    mask_s = pcode_s != INVALID_CODE
    first = first_of_runs(pcode_s, mask_s)
    seg = torch.cumsum(first.long(), 0) - 1
    seg = torch.where(mask_s & (seg < cap), seg, torch.full_like(seg, cap))
    rep = first & (seg < cap)
    out_mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    out_mask[seg[rep]] = True
    out_coords = torch.zeros(cap, 3, dtype=coords.dtype, device=dev)
    out_coords[seg[rep]] = parent_s[rep]
    parent_idx = torch.empty(M, dtype=torch.long, device=dev)
    parent_idx[order] = torch.where(seg < cap, seg, torch.full_like(seg, -1))
    parent_idx = torch.where(mask, parent_idx, torch.full_like(parent_idx, -1))
    return Down(order, seg, slot_of(coords[order] & 1).long(), mask_s,
                out_coords, out_mask, parent_idx, slot_of(coords & 1).long())


def voxelize(points, mask, grid_size, min_coord, capacity):
    """One representative (first in code order) per occupied voxel ->
    (coords, mask, representative row or -1, world coords)."""
    dev = points.device
    g = torch.floor((points - min_coord[None, :])
                    / torch.full((3,), grid_size, device=dev)).to(torch.int32)
    g = g.clamp(0, (1 << CODE_BITS) - 1)
    code = pack_code(g, mask)
    order = argsort(code)
    code_s = code[order]
    first = first_of_runs(code_s, code_s != INVALID_CODE)
    seg = torch.cumsum(first.long(), 0) - 1
    keep = first & (seg < capacity)
    dst, src = seg[keep], order[keep]
    out_mask = torch.zeros(capacity, dtype=torch.bool, device=dev)
    out_mask[dst] = True
    out_coords = torch.zeros(capacity, 3, dtype=torch.int32, device=dev)
    out_coords[dst] = g[src]
    rep = torch.full((capacity,), -1, dtype=torch.long, device=dev)
    rep[dst] = src
    world = points.new_zeros(capacity, 3)
    world[dst] = points[src]
    return out_coords, out_mask, rep, world


class Geometry(NamedTuple):
    order0: torch.Tensor
    mask0: torch.Tensor
    nbr5: torch.Tensor
    pix_rep: torch.Tensor
    merge_order: torch.Tensor
    world: torch.Tensor
    fine_mask: torch.Tensor
    nbr3_fine: torch.Tensor
    downs: Tuple[Down, ...]
    nbrs: Tuple[torch.Tensor, ...]


def geometry_one(grid_coord, mask, coord, min_coord, unproj, grid_size,
                 pixel_capacity, level_caps):
    """One scene: the canonical order, the stem's 5^3 table, PointFusion's
    pixel voxels (bbox-filtered to the cloud, voxelized at its
    ``min_coord``) merged in, the fine 3^3 table, and per level its
    stride-2 structure and 3^3 table."""
    dev = grid_coord.device
    order0 = argsort(pack_code(grid_coord, mask))
    coords_c, mask0, world_c = grid_coord[order0], mask[order0], coord[order0]
    nbr5 = find_neighbors(coords_c, mask0, 5)
    pix_world = unproj[..., :3].reshape(-1, 3)
    pix_valid = unproj[..., 3].reshape(-1) > 0
    big = torch.tensor(1e9, device=dev)
    lo = torch.where(mask0[:, None], world_c, big).amin(0)
    hi = torch.where(mask0[:, None], world_c, -big).amax(0)
    pix_valid = pix_valid & ((pix_world >= lo) & (pix_world <= hi)).all(-1)
    c2d, m2d, pix_rep, world2d = voxelize(pix_world, pix_valid, grid_size,
                                          min_coord, pixel_capacity)
    all_coords = torch.cat([coords_c, c2d])
    all_mask = torch.cat([mask0, m2d])
    merge_order = argsort(pack_code(all_coords, all_mask))
    fine_coords, fine_mask = all_coords[merge_order], all_mask[merge_order]
    world = torch.cat([world_c, world2d])[merge_order]
    nbr3_fine = find_neighbors(fine_coords, fine_mask, 3)
    downs, nbrs = [], []
    cur_c, cur_m = fine_coords, fine_mask
    for cap in level_caps:
        ds = downsample_structure(cur_c, cur_m, cap)
        nbrs.append(find_neighbors(ds.coords, ds.mask, 3))
        downs.append(ds)
        cur_c, cur_m = ds.coords, ds.mask
    return Geometry(order0, mask0, nbr5, pix_rep, merge_order, world,
                    fine_mask, nbr3_fine, tuple(downs), tuple(nbrs))


def stack(items):
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    parts = [stack(list(x)) for x in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def build_geometry(data, unprojected, grid_size, pixel_capacity,
                   level_divs):
    M = data["mask"].shape[1]
    caps = tuple(max(M // int(d), 64) for d in level_divs)
    return stack([geometry_one(
        data["grid_coord"][b], data["mask"][b], data["coord"][b],
        data["min_coord"][b], unprojected[b], grid_size, pixel_capacity,
        caps) for b in range(data["mask"].shape[0])])


# --------------------------------------------------------------------------
# the sparse convolutions (a leading scene axis)
# --------------------------------------------------------------------------

def gather_all(table, nbr):
    B, M, C = table.shape
    K = nbr.shape[-1]
    base = torch.arange(B, device=nbr.device).view(B, 1, 1) * M
    g = table.reshape(B * M, C)[(nbr.clamp(min=0) + base).reshape(-1)]
    g = g.reshape(B, M, K, C)
    return torch.where((nbr >= 0)[..., None], g,
                       torch.zeros((), dtype=g.dtype, device=g.device))


class SubMGatherMatmul(torch.autograd.Function):
    """Gather and contract; the backward is the port's (and JAX's) mirror
    flip: dy gathered through the reversed columns."""

    @staticmethod
    def forward(ctx, feats, nbr, weight):
        B, M, Cin = feats.shape
        K = nbr.shape[-1]
        ctx.save_for_backward(feats, nbr, weight)
        g = gather_all(feats, nbr)
        return g.reshape(B, M, K * Cin) @ weight.reshape(K * Cin, -1)

    @staticmethod
    def backward(ctx, dy):
        feats, nbr, weight = ctx.saved_tensors
        B, M, Cin = feats.shape
        K, Cout = nbr.shape[-1], dy.shape[-1]
        G = gather_all(dy.contiguous(), nbr.flip(-1)).reshape(B * M,
                                                              K * Cout)
        dfeats = (G @ weight.transpose(1, 2).reshape(K * Cout, Cin))
        dw = (G.t() @ feats.reshape(B * M, Cin)).reshape(K, Cout, Cin)
        return dfeats.reshape(B, M, Cin), None, dw.transpose(1, 2)


def slot_products(x, weight, slot):
    B, M, Cin = x.shape
    Cout = weight.shape[-1]
    prod = (x @ weight.permute(1, 0, 2).reshape(Cin, 8 * Cout)).reshape(
        B, M, 8, Cout)
    return torch.gather(prod, 2, slot.reshape(B, M, 1, 1).expand(
        B, M, 1, Cout)).squeeze(2)


def downsample_apply(ds, feats, weight):
    B, M, _ = feats.shape
    cap = ds.mask.shape[1]
    feats_s = torch.gather(feats, 1, ds.order[..., None].expand_as(feats))
    contrib = slot_products(feats_s, weight, ds.slot_sorted)
    contrib = torch.where(ds.valid_sorted[..., None], contrib,
                          torch.zeros((), dtype=contrib.dtype,
                                      device=contrib.device))
    out = feats.new_zeros(B, cap + 1, contrib.shape[-1]).scatter_add(
        1, ds.seg[..., None].expand_as(contrib), contrib)[:, :cap]
    return torch.where(ds.mask[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def inverse_conv(parent_idx, child_offset, coarse, fine_mask, weight):
    B, Mf = parent_idx.shape
    Cin = coarse.shape[-1]
    gathered = torch.gather(coarse, 1, parent_idx.clamp(min=0)[..., None]
                            .expand(B, Mf, Cin))
    valid = ((parent_idx >= 0) & fine_mask)[..., None]
    zero = torch.zeros((), dtype=gathered.dtype, device=gathered.device)
    out = slot_products(torch.where(valid, gathered, zero), weight,
                        child_offset)
    return torch.where(valid, out, zero)


# --------------------------------------------------------------------------
# SpUNet-v1m1 with PointFusion
# --------------------------------------------------------------------------

class MaskedBatchNorm(nn.Module):
    """Masked mean and biased variance over the valid rows, eps 1e-3,
    float32; running statistics 0.99 r + 0.01 batch."""

    def __init__(self, ch, q, eps=1e-3):
        super().__init__()
        self.q, self.eps = q, eps
        self.weight = nn.Parameter(torch.empty(ch, device="meta"))
        self.bias = nn.Parameter(torch.empty(ch, device="meta"))
        self.register_buffer("running_mean", torch.empty(ch, device="meta"))
        self.register_buffer("running_var", torch.empty(ch, device="meta"))

    def forward(self, x, mask):
        C = x.shape[-1]
        m = mask.reshape(-1, 1).float()
        xf = x.reshape(-1, C).float()
        n = torch.clamp_min(m.sum(), 1.0)
        mean = (xf * m).sum(0) / n
        var = (((xf - mean) ** 2) * m).sum(0) / n
        with torch.no_grad():
            self.running_mean.mul_(0.99).add_(0.01 * mean)
            self.running_var.mul_(0.99).add_(0.01 * var)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        y = self.q(y * self.weight + self.bias)
        return torch.where(mask[..., None], y, torch.zeros_like(y))


class SparseKernel(nn.Module):
    def __init__(self, k, cin, cout, q):
        super().__init__()
        self.q = q
        self.weight = nn.Parameter(torch.empty(k, cin, cout, device="meta"))


class SubMConv(SparseKernel):
    def __init__(self, cin, cout, q, kernel_size=3, use_bias=False):
        super().__init__(kernel_size ** 3, cin, cout, q)
        self.bias = nn.Parameter(torch.empty(cout, device="meta")) \
            if use_bias else None

    def forward(self, feats, nbr):
        y = self.q(SubMGatherMatmul.apply(self.q(feats), nbr,
                                          self.q(self.weight)))
        return y if self.bias is None else y + self.bias


class SubMConvBlock(nn.Module):
    def __init__(self, cin, channels, q):
        super().__init__()
        self.conv = SubMConv(cin, channels, q, 3, use_bias=True)
        self.bn = MaskedBatchNorm(channels, q)

    def forward(self, feats, nbr, mask):
        return F.relu(self.bn(self.conv(feats, nbr), mask))


class BasicBlock(nn.Module):
    def __init__(self, cin, channels, q):
        super().__init__()
        self.conv1 = SubMConv(cin, channels, q)
        self.bn1 = MaskedBatchNorm(channels, q)
        self.conv2 = SubMConv(channels, channels, q)
        self.bn2 = MaskedBatchNorm(channels, q)
        if cin != channels:
            self.proj = Dense(cin, channels, bias=False, q=q)
            self.proj_bn = MaskedBatchNorm(channels, q)
        else:
            self.proj = None

    def forward(self, feats, nbr, mask):
        h = F.relu(self.bn1(self.conv1(feats, nbr), mask))
        h = self.bn2(self.conv2(h, nbr), mask)
        res = feats if self.proj is None else \
            self.proj_bn(self.proj(feats), mask)
        return F.relu(h + res)


class DownConv(SparseKernel):
    def __init__(self, cin, cout, q):
        super().__init__(8, cin, cout, q)
        self.bn = MaskedBatchNorm(cout, q)

    def forward(self, feats, ds):
        y = self.q(downsample_apply(ds, self.q(feats), self.q(self.weight)))
        return F.relu(self.bn(y, ds.mask))


class UpConv(SparseKernel):
    def __init__(self, cin, cout, q):
        super().__init__(8, cin, cout, q)
        self.bn = MaskedBatchNorm(cout, q)

    def forward(self, parent_idx, child_offset, coarse, fine_mask):
        f = self.q(inverse_conv(parent_idx, child_offset, self.q(coarse),
                                fine_mask, self.q(self.weight)))
        return F.relu(self.bn(f, fine_mask))


def point_fusion_merge(x, image_features, g):
    """Append each fused pixel voxel's representative 2D feature to the
    stem's output, in the merged order."""
    B, _, C = x.shape
    pf = image_features.reshape(B, -1, C, *image_features.shape[2:])
    pf = pf.permute(0, 1, 3, 4, 2).reshape(B, -1, C)
    pix = torch.gather(pf, 1, g.pix_rep.clamp(min=0)[..., None].expand(
        -1, -1, C))
    pix = torch.where((g.pix_rep >= 0)[..., None], pix, torch.zeros_like(pix))
    cat = torch.cat([x, pix], dim=1)
    return torch.gather(cat, 1, g.merge_order[..., None].expand(-1, -1, C))


class SpUNet(nn.Module):
    def __init__(self, q, in_channels=6, num_classes=64, base=32,
                 channels=(32, 64, 128, 256, 256, 128, 96, 96),
                 layers=(2, 3, 4, 6, 2, 2, 2, 2)):
        super().__init__()
        self.q, self.channels, self.layers = q, channels, layers
        n = self.n_stages = len(layers) // 2
        self.conv_input = SubMConv(in_channels, base, q, 5)
        self.bn_input = MaskedBatchNorm(base, q)
        enc_ch, c = [base], base
        for s in range(n):
            self.add_module(f"down{s}", DownConv(c, channels[s], q))
            c = channels[s]
            for i in range(layers[s]):
                self.add_module(f"enc{s}_block{i}", BasicBlock(c, c, q))
            enc_ch.append(c)
        ref_dec, dc = [], channels[-1]
        for s in range(n):
            ref_dec.append(dc)
            dc = channels[len(channels) - s - 2]
        c = enc_ch[-1]
        for s in reversed(range(n)):
            self.add_module(f"up{s}", UpConv(c, ref_dec[s], q))
            c = ref_dec[s] + enc_ch[s]
            for i in range(layers[len(channels) - s - 1]):
                self.add_module(f"dec{s}_block{i}",
                                BasicBlock(c, ref_dec[s], q))
                c = ref_dec[s]
        self.final = Dense(c, num_classes, q=q)

    def forward(self, data, image_features, fusion_mlp, g):
        feats = torch.gather(self.q(data["feat"]), 1, g.order0[..., None]
                             .expand(-1, -1, data["feat"].shape[-1]))
        x = F.relu(self.bn_input(self.conv_input(feats, g.nbr5), g.mask0))
        x = point_fusion_merge(x, self.q(image_features), g)
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
        return torch.where(g.fine_mask[..., None], f, torch.zeros_like(f))


class ImageConv(nn.Module):
    """GroupNorm's affine and the 1x1 conv over the whole normalised map."""

    def __init__(self, out_dim, feat_ch, q):
        super().__init__()
        self.q = q
        self.layers_0 = GroupNormAffine(feat_ch, q)
        self.layers_1 = nn.Conv2d(feat_ch, out_dim, 1, device="meta")

    def forward(self, xn):
        gn = self.layers_0
        y = self.q(xn.permute(0, 2, 3, 1).float() * gn.weight + gn.bias)
        w = self.layers_1.weight[:, :, 0, 0]
        return F.linear(y, self.q(w), self.q(self.layers_1.bias)).permute(
            0, 3, 1, 2)


class ScenePointNetwork(nn.Module):
    def __init__(self, q):
        super().__init__()
        self.encoder = SpUNet(q)
        self.final = FinalHead(64, 32, 23, q)


class ScenePredictor(nn.Module):
    """SpUNet with PointFusion of the frozen VAE's decoder_block_3 and the
    Gaussian head: 23 channels, centred on each voxel's world position."""

    def __init__(self, q: Rounding, offset_scale: float, vae: dict,
                 grid_size: float = 0.02, pixel_capacity: int = 4096,
                 level_divs=(3, 9, 27, 81)):
        super().__init__()
        self.q, self.offset_scale = q, offset_scale
        self.grid_size, self.pixel_capacity = grid_size, pixel_capacity
        self.level_divs = level_divs
        self.point_network = ScenePointNetwork(q)
        vae = dict(vae or {})
        self.image_network = AutoencoderKL(q, **vae)
        self.image_network.requires_grad_(False)
        feat_ch = list(vae.get("block_out_channels", [128]))[0]
        self.image_conv = ImageConv(32, feat_ch, q)
        self.fusion_mlps = SubMConvBlock(32, 32, q)

    def vae_features(self, images):
        with torch.no_grad():
            return self.image_network(images)

    def geometry(self, data, unprojected):
        return build_geometry(data, unprojected, self.grid_size,
                              self.pixel_capacity, self.level_divs)

    def forward(self, data, vae_features, geometry) -> dict:
        with torch.no_grad():
            xn = group_normalize(self.q(vae_features))
        feats = self.image_conv(xn)
        out = self.point_network.encoder(data, feats, self.fusion_mlps,
                                         geometry)
        out = self.point_network.final(out).float()
        xyz, opacity, scaling, rotation, f_dc, rest = torch.split(
            out, [3, 1, 3, 4, 3, 9], dim=-1)
        rot_norm = torch.sqrt((rotation ** 2).sum(-1, keepdim=True) + 1e-12)
        return {
            "xyz": torch.tanh(xyz) * self.offset_scale + geometry.world.float(),
            "opacity": torch.sigmoid(opacity),
            "scaling": torch.exp(torch.clamp(scaling, -1, 20)),
            "rotation": rotation / torch.clamp_min(rot_norm, 1e-6),
            "features_dc": f_dc.reshape(*f_dc.shape[:-1], 1, 3),
            "features_rest": rest.reshape(*rest.shape[:-1], 3, 3),
            "mask": geometry.fine_mask,
        }
