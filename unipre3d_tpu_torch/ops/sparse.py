"""Static-shape sparse voxel ops (spconv equivalent), plain PyTorch.

Port of unipre3d_tpu/ops/sparse.py. A voxel set is a fixed-capacity array
with a validity mask, kept sorted by a packed 30-bit grid code (invalid
rows last); a submanifold conv is a neighbour-table gather and one
``[M, K*Cin] @ [K*Cin, Cout]`` matmul; a stride-2 conv and its inverse
follow the parent-child relation of the stride-2 voxel tree.

Codes are int64 here (torch has no full uint32 sort); they hold the same
values as the JAX package's uint32 codes, with ``INVALID_CODE`` =
0xFFFFFFFF sorting last. Sorts are stable, as ``jnp.argsort``, so every
index structure equals the JAX one exactly.

Geometry functions (``canonicalize``, ``find_neighbors``,
``downsample_structure``, ``voxelize``, ``merge_voxel_sets``) take ONE
scene, as in the JAX package. The feature functions (``subm_gather_matmul``,
``downsample_apply``, ``inverse_conv``) take a leading scene axis
``[B, ...]``, which the JAX package ``vmap``s instead.

The block-dense executor (``BlockStructure``, ``block_structure``,
``block_conv_apply``) computes a submanifold conv the other way: each voxel
is scattered into the halo tensors of the blocks that contain it, one dense
``F.conv3d`` runs over all blocks, and the interior outputs are gathered
back. Its structure takes one scene, its apply a leading scene axis.

Not ported: the TPU gather-cost tricks (``_window_gather``, the hierarchical
rank of ``_merge_lookup``, the 16-lane code window of
``_find_neighbors_cubic``), each replaced by one gather or one
``searchsorted`` with the same result.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from unipre3d_tpu_torch.telemetry import span

CODE_BITS = 10          # per-axis bits; grid coords must be < 1024
INVALID_CODE = 0xFFFFFFFF


class SparseVoxels(NamedTuple):
    """One scene's voxel set, sorted by packed code, padded to capacity:
    coords [M, 3] int32 (0 where invalid), feats [M, C], mask [M] bool."""
    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor


def pack_code(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """coords [M, 3] (clamped to [0, 2^10)), mask [M] -> int64 code;
    invalid rows get INVALID_CODE so they sort to the end."""
    c = coords.clamp(0, (1 << CODE_BITS) - 1).long()
    code = (c[:, 0] << (2 * CODE_BITS)) | (c[:, 1] << CODE_BITS) | c[:, 2]
    return torch.where(mask, code, torch.full_like(code, INVALID_CODE))


def _argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def canonicalize(coords, feats, mask) -> Tuple[SparseVoxels, torch.Tensor]:
    """Sort voxels by packed code (invalid last, stable). Returns the sorted
    set and the permutation used."""
    order = _argsort(pack_code(coords, mask))
    return SparseVoxels(coords[order], feats[order], mask[order]), order


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """All 3D offsets of a centred cubic kernel, x-major: [K, 3] int32."""
    assert kernel_size % 2 == 1
    r = kernel_size // 2
    offs = [(dx, dy, dz)
            for dx in range(-r, r + 1)
            for dy in range(-r, r + 1)
            for dz in range(-r, r + 1)]
    return np.asarray(offs, dtype=np.int32)


def take_elements(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 1-D table (the JAX version is a TPU row-gather
    trick with the same result)."""
    return table[idx]


def _merge_lookup(codes: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Exact-match lookup of tgt [M, K] in the sorted codes [T]: the row of
    the LAST code equal to the target (the representative of a duplicate
    run), or -1."""
    T = codes.shape[0]
    t = tgt.reshape(-1)
    cand = torch.searchsorted(codes.contiguous(), t, right=True) - 1
    safe = cand.clamp(0, T - 1)
    found = (cand >= 0) & (codes[safe] == t)
    return torch.where(found, safe, torch.full_like(safe, -1)).reshape(
        tgt.shape)


def find_neighbors(sv: SparseVoxels, offsets: np.ndarray) -> torch.Tensor:
    """Submanifold neighbour table: offsets [K, 3] -> idx [M, K] int64, the
    row of the voxel at coords + offset, or -1 (also for invalid rows).

    ``sv`` must be canonical. Duplicate codes (the PointFusion-merged set
    holds up to two rows per code) resolve to the LAST duplicate, as the
    JAX package's rank lookup and its cubic 16-lane window do
    (``_find_neighbors_cubic``), which this one lookup covers."""
    M = sv.coords.shape[0]
    codes = pack_code(sv.coords, sv.mask)
    with span("sync/neighbor_offsets"):
        offs = torch.as_tensor(np.asarray(offsets), dtype=torch.int64,
                               device=sv.coords.device)
    tgt_coords = sv.coords[:, None, :].long() + offs[None, :, :]   # [M, K, 3]
    in_range = ((tgt_coords >= 0) & (tgt_coords < (1 << CODE_BITS))).all(-1)
    tgt_mask = sv.mask[:, None] & in_range
    tgt = pack_code(tgt_coords.reshape(-1, 3),
                    tgt_mask.reshape(-1)).reshape(M, -1)
    found = _merge_lookup(codes, tgt)
    return torch.where(tgt == INVALID_CODE, torch.full_like(found, -1), found)


def _gather_all(table: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """table [B, M, C], nbr [B, M, K] (-1 = missing) -> [B, M, K, C], 0 on
    a miss."""
    B, M, C = table.shape
    K = nbr.shape[-1]
    base = torch.arange(B, device=nbr.device).view(B, 1, 1) * M
    flat = (nbr.clamp(min=0) + base).reshape(-1)
    g = table.reshape(B * M, C)[flat].reshape(B, M, K, C)
    return torch.where((nbr >= 0)[..., None], g, torch.zeros((), dtype=g.dtype,
                                                             device=g.device))


class SubMGatherMatmul(torch.autograd.Function):
    """Gather the neighbours' features and contract with the kernel:
    feats [B, M, Cin], nbr [B, M, K], weight [K, Cin, Cout] -> [B, M, Cout];
    missing neighbours contribute zero.

    The backward is the JAX package's mirror flip (sparse.py:363-386): the
    transpose of the gather is replaced by a gather of dy through the
    reversed columns, which equals the scatter-add only where
    ``nbr[i, k] = j <=> nbr[j, K-1-k] = i``. On the PointFusion-merged set
    a non-representative duplicate row is read by no lookup, so there the
    flip gives it the representative's gradient where a scatter-add would
    give zero; the port keeps the reference's gradient, not autograd's."""

    @staticmethod
    def forward(ctx, feats, nbr, weight):
        B, M, Cin = feats.shape
        K = nbr.shape[-1]
        ctx.save_for_backward(feats, nbr, weight)
        g = _gather_all(feats, nbr)                           # [B, M, K, Cin]
        return g.reshape(B, M, K * Cin) @ weight.reshape(K * Cin, -1)

    @staticmethod
    def backward(ctx, dy):
        feats, nbr, weight = ctx.saved_tensors
        B, M, Cin = feats.shape
        K = nbr.shape[-1]
        Cout = dy.shape[-1]
        G = _gather_all(dy.contiguous(), nbr.flip(-1)).reshape(B * M,
                                                               K * Cout)
        w_t = weight.transpose(1, 2).reshape(K * Cout, Cin)
        dfeats = (G @ w_t).reshape(B, M, Cin)
        dw = (G.t() @ feats.reshape(B * M, Cin)).reshape(K, Cout, Cin)
        return dfeats, None, dw.transpose(1, 2)


def subm_gather_matmul(feats, nbr, weight):
    """See :class:`SubMGatherMatmul`."""
    return SubMGatherMatmul.apply(feats, nbr, weight)


class BlockStructure(NamedTuple):
    """Block-dense layout of one voxel set (one scene, or [B, ...] once
    stacked), JAX ``sparse.py:BlockStructure``: ``scat_idx`` [M, 8] each
    voxel's flat targets in the [NB * hs^3] halo tensors of the <= 8 blocks
    whose halo holds it (NB * hs^3: none); ``out_idx`` [M] its interior
    cell in [NB * bs^3], -1 for an invalid row or a dropped block;
    ``block_valid`` [NB] (its length is the block capacity)."""
    scat_idx: torch.Tensor
    out_idx: torch.Tensor
    block_valid: torch.Tensor


def block_structure(coords: torch.Tensor, mask: torch.Tensor, nb_cap: int,
                    bs: int = 4, halo: int = 1) -> BlockStructure:
    """Blocks of side ``bs`` (a power of two) and halo ``halo`` (the
    kernel's radius, at most bs / 2) of one canonical voxel set. Blocks past
    ``nb_cap`` drop in code order, and their voxels neither scatter nor
    read an output. Of a run of duplicate codes (PointFusion's merged set)
    only the last row scatters, the representative the gather path's
    lookup resolves to; every row of the run reads the shared output."""
    if bs & (bs - 1) or halo * 2 > bs:
        raise ValueError(f"block side {bs} must be a power of two of at "
                         f"least twice the halo {halo}")
    shift = bs.bit_length() - 1
    hs = bs + 2 * halo
    M = coords.shape[0]
    dev = coords.device
    coords = coords.long()
    vcode = pack_code(coords, mask)
    writer = torch.ones_like(mask)
    writer[:-1] = vcode[:-1] != vcode[1:]
    writer = writer & mask
    bc = coords >> shift
    bcode = pack_code(bc, mask)

    # distinct blocks in code order, and each voxel's block rank
    order = _argsort(bcode)
    bcode_s = bcode[order]
    mask_s = bcode_s != INVALID_CODE
    first = _first_of_runs(bcode_s, mask_s)
    seg = torch.cumsum(first.long(), 0) - 1
    ok = mask_s & (seg < nb_cap)
    btab = torch.full((nb_cap + 1,), INVALID_CODE, dtype=torch.long,
                      device=dev)
    btab[torch.where(first & ok, seg, nb_cap)] = bcode_s
    btab = btab[:nb_cap]
    own = torch.empty(M, dtype=torch.long, device=dev)
    own[order] = torch.where(ok, seg, -1)
    own = torch.where(mask, own, -1)

    local = coords - (bc << shift)
    # the neighbouring block along an axis whose halo holds the voxel: -1
    # where local < halo, +1 where local >= bs - halo
    d = torch.where(local < halo, -1, torch.where(local >= bs - halo, 1, 0))
    drop = nb_cap * hs ** 3
    cols = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                sel = torch.tensor([sx, sy, sz], device=dev)
                slot_ok = writer & (own >= 0)
                if sx or sy or sz:
                    # each selected axis must have a neighbouring block
                    slot_ok = slot_ok & ((d != 0) | (sel == 0)).all(-1)
                tb = bc + d * sel
                slot_ok = slot_ok & ((tb >= 0) & (tb < (1 << CODE_BITS))
                                     ).all(-1)
                rank = own if not (sx or sy or sz) else _merge_lookup(
                    btab, pack_code(tb, slot_ok)[:, None])[:, 0]
                pos = coords - (tb << shift) + halo
                flat = (rank * hs ** 3 + pos[:, 0] * hs * hs
                        + pos[:, 1] * hs + pos[:, 2])
                cols.append(torch.where(slot_ok & (rank >= 0), flat, drop))
    out_idx = torch.where(
        (own >= 0) & mask,
        own * bs ** 3 + local[:, 0] * bs * bs + local[:, 1] * bs
        + local[:, 2], -1)
    return BlockStructure(scat_idx=torch.stack(cols, 1), out_idx=out_idx,
                          block_valid=btab != INVALID_CODE)


def block_conv_apply(feats: torch.Tensor, bst: BlockStructure,
                     weight: torch.Tensor, bs: int = 4) -> torch.Tensor:
    """Submanifold conv over a batched :class:`BlockStructure`: feats
    [B, M, Cin], weight [k^3, Cin, Cout] in :func:`kernel_offsets`' x-major
    order -> [B, M, Cout] in ``feats``' dtype (0 on invalid rows and rows
    of dropped blocks). The same sum as :func:`subm_gather_matmul` in
    another order. Each voxel is written into its blocks' halo tensors (a
    copy to unique targets; the dropped ones all go to one dump row per
    scene, sliced off), ``F.conv3d`` runs over [B * NB, Cin, hs, hs, hs]
    with x as the depth axis, and the interior outputs are gathered back.
    Autograd gives the backward: the copy's transpose is a gather. On a
    card a float32 conv takes TF32 when ``torch.backends.cudnn.allow_tf32``
    is set (PyTorch's default)."""
    B, M, Cin = feats.shape
    K = weight.shape[0]
    k = round(K ** (1.0 / 3.0))
    if k ** 3 != K:
        raise ValueError(f"{K} kernel taps are not a cube")
    hs = bs + k - 1
    NB = bst.block_valid.shape[-1]
    D = bst.scat_idx.shape[-1]
    n = NB * hs ** 3                 # a scene's halo rows; row n: the dump
    base = torch.arange(B, device=feats.device).view(B, 1, 1) * (n + 1)
    src = feats[:, :, None, :].expand(B, M, D, Cin).reshape(-1, Cin)
    halo = feats.new_zeros(B * (n + 1), Cin).index_copy(
        0, (bst.scat_idx + base).reshape(-1), src)
    halo = halo.view(B, n + 1, Cin)[:, :n].reshape(B * NB, hs, hs, hs, Cin)
    w = weight.reshape(k, k, k, Cin, -1).permute(4, 3, 0, 1, 2)
    out = F.conv3d(halo.permute(0, 4, 1, 2, 3), w.to(feats.dtype))
    Cout = out.shape[1]
    flat = out.permute(0, 2, 3, 4, 1).reshape(B, NB * bs ** 3, Cout)
    y = torch.gather(flat, 1, bst.out_idx.clamp(min=0)[..., None].expand(
        B, M, Cout))
    return torch.where((bst.out_idx >= 0)[..., None], y,
                       torch.zeros((), dtype=y.dtype, device=y.device))


class DownStructure(NamedTuple):
    """Geometry of one stride-2 downsample level (one scene, or [B, ...]
    once stacked): fine rows sorted by parent code (``order``), output slot
    (``seg``, capacity = dropped), kernel slot and validity per sorted
    child, the coarse voxel set (``coords``/``mask``, canonical), and per
    fine row in original order its coarse row (``parent_idx``, -1) and
    kernel slot (``child_offset``)."""
    order: torch.Tensor
    seg: torch.Tensor
    slot_sorted: torch.Tensor
    valid_sorted: torch.Tensor
    coords: torch.Tensor
    mask: torch.Tensor
    parent_idx: torch.Tensor
    child_offset: torch.Tensor


def _slot(child: torch.Tensor) -> torch.Tensor:
    return child[:, 0] * 4 + child[:, 1] * 2 + child[:, 2]


def _first_of_runs(code_s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(valid)
    first[1:] = code_s[1:] != code_s[:-1]
    return first & valid


def downsample_structure(coords: torch.Tensor, mask: torch.Tensor,
                         capacity_out: int) -> DownStructure:
    """Distinct parents (coords >> 1), child->parent maps and kernel slots
    of one scene; parents beyond ``capacity_out`` are dropped (code
    order)."""
    M = coords.shape[0]
    dev = coords.device
    parent = coords >> 1
    pcode = pack_code(parent, mask)
    order = _argsort(pcode)
    pcode_s = pcode[order]
    parent_s = parent[order]
    mask_s = pcode_s != INVALID_CODE
    first = _first_of_runs(pcode_s, mask_s)
    seg = torch.cumsum(first.long(), 0) - 1
    seg = torch.where(mask_s & (seg < capacity_out), seg,
                      torch.full_like(seg, capacity_out))
    rep = first & (seg < capacity_out)
    out_mask = torch.zeros(capacity_out, dtype=torch.bool, device=dev)
    out_coords = torch.zeros(capacity_out, 3, dtype=coords.dtype, device=dev)
    # boolean indexing sizes its result on the host
    with span("sync/downsample"):
        out_mask[seg[rep]] = True
        out_coords[seg[rep]] = parent_s[rep]

    parent_idx = torch.empty(M, dtype=torch.long, device=dev)
    parent_idx[order] = torch.where(seg < capacity_out, seg,
                                    torch.full_like(seg, -1))
    parent_idx = torch.where(mask, parent_idx, torch.full_like(parent_idx, -1))
    return DownStructure(
        order=order, seg=seg, slot_sorted=_slot(coords[order] & 1).long(),
        valid_sorted=mask_s, coords=out_coords, mask=out_mask,
        parent_idx=parent_idx, child_offset=_slot(coords & 1).long())


def _slot_products(x: torch.Tensor, weight: torch.Tensor,
                   slot: torch.Tensor) -> torch.Tensor:
    """x [B, M, Cin], weight [8, Cin, Cout], slot [B, M] -> x @ W[slot]
    per row: one matmul against all eight kernel slots, then a select (the
    JAX package sums eight masked matmuls, seven of them exact zeros)."""
    B, M, Cin = x.shape
    Cout = weight.shape[-1]
    prod = (x @ weight.permute(1, 0, 2).reshape(Cin, 8 * Cout)).reshape(
        B, M, 8, Cout)
    idx = slot.reshape(B, M, 1, 1).expand(B, M, 1, Cout)
    return torch.gather(prod, 2, idx).squeeze(2)


def downsample_apply(ds: DownStructure, feats: torch.Tensor,
                     weight: torch.Tensor) -> torch.Tensor:
    """SparseConv3d(k2, s2) over a batched :class:`DownStructure`:
    y[parent] = sum_children W[slot(child)] x[child]; feats [B, M, Cin],
    weight [8, Cin, Cout] -> [B, capacity_out, Cout] (0 on invalid rows)."""
    B, M, _ = feats.shape
    cap = ds.mask.shape[1]
    feats_s = torch.gather(feats, 1, ds.order[..., None].expand_as(feats))
    contrib = _slot_products(feats_s, weight, ds.slot_sorted)
    contrib = torch.where(ds.valid_sorted[..., None], contrib,
                          torch.zeros((), dtype=contrib.dtype,
                                      device=contrib.device))
    out = feats.new_zeros(B, cap + 1, contrib.shape[-1]).scatter_add(
        1, ds.seg[..., None].expand_as(contrib), contrib)[:, :cap]
    return torch.where(ds.mask[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def inverse_conv(parent_idx: torch.Tensor, child_offset: torch.Tensor,
                 coarse_feats: torch.Tensor, fine_mask: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """SparseInverseConv3d(k2) back to the fine set: y[child] =
    W[slot(child)] x[parent]; parent_idx/child_offset/fine_mask [B, Mf],
    coarse_feats [B, Mc, Cin], weight [8, Cin, Cout] -> [B, Mf, Cout]."""
    B, Mf = parent_idx.shape
    Cin = coarse_feats.shape[-1]
    safe = parent_idx.clamp(min=0)[..., None].expand(B, Mf, Cin)
    gathered = torch.gather(coarse_feats, 1, safe)
    valid = ((parent_idx >= 0) & fine_mask)[..., None]
    zero = torch.zeros((), dtype=gathered.dtype, device=gathered.device)
    out = _slot_products(torch.where(valid, gathered, zero), weight,
                         child_offset)
    return torch.where(valid, out, zero)


def voxelize(points: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
             grid_size: float, min_coord: torch.Tensor, capacity: int
             ) -> Tuple[SparseVoxels, torch.Tensor, torch.Tensor]:
    """GridSample-style dedup of one scene: one representative (first in
    code order) per occupied voxel at the shared ``min_coord``.

    points [N, 3], feats [N, C], mask [N] -> (canonical SparseVoxels of
    ``capacity`` rows, rep_idx [capacity] input row of each kept voxel
    (-1), world coords [capacity, 3] of the representative)."""
    dev = points.device
    # a true division by a tensor: CUDA turns a division by a Python scalar
    # into a product with its reciprocal, which can round a point into the
    # neighbouring voxel
    g = torch.floor((points - min_coord[None, :])
                    / torch.full((3,), grid_size, device=dev)).to(torch.int32)
    g = g.clamp(0, (1 << CODE_BITS) - 1)
    code = pack_code(g, mask)
    order = _argsort(code)
    code_s = code[order]
    first = _first_of_runs(code_s, code_s != INVALID_CODE)
    seg = torch.cumsum(first.long(), 0) - 1
    keep = first & (seg < capacity)
    out_mask = torch.zeros(capacity, dtype=torch.bool, device=dev)
    # boolean indexing sizes its result on the host; True comes from it
    with span("sync/voxelize"):
        dst, src = seg[keep], order[keep]
        out_mask[dst] = True
    out_coords = torch.zeros(capacity, 3, dtype=torch.int32, device=dev)
    out_coords[dst] = g[src]
    out_feats = feats.new_zeros(capacity, feats.shape[-1])
    out_feats[dst] = feats[src]
    rep = torch.full((capacity,), -1, dtype=torch.long, device=dev)
    rep[dst] = src
    world = points.new_zeros(capacity, 3)
    world[dst] = points[src]
    return SparseVoxels(out_coords, out_feats, out_mask), rep, world


def merge_voxel_sets(a_coords, a_feats, a_mask, b_coords, b_feats, b_mask
                     ) -> Tuple[SparseVoxels, torch.Tensor]:
    """Concatenate two voxel sets (duplicates allowed) and re-canonicalize;
    returns the merged set and the permutation of the concatenated rows
    (the first len(a) rows are a's)."""
    return canonicalize(torch.cat([a_coords, b_coords]),
                        torch.cat([a_feats, b_feats]),
                        torch.cat([a_mask, b_mask]))


class Clustered(NamedTuple):
    """PTv3's stride-2 pooling structure of one scene (or [B, ...] once
    stacked): the coarse voxel set (``coords`` [cap, 3], 0 where invalid,
    and ``mask`` [cap], canonical) and each fine row's coarse row
    (``parent_idx`` [M], -1 for an invalid row or a parent past the
    capacity)."""
    coords: torch.Tensor
    mask: torch.Tensor
    parent_idx: torch.Tensor


def pool_clusters(coords: torch.Tensor, mask: torch.Tensor,
                  capacity_out: int) -> Clustered:
    """Distinct parents (coords >> 1), sorted by packed code (stable), and
    the fine -> coarse map of one scene; parents past ``capacity_out`` are
    dropped (their children get -1). The parent relation and the drop rule
    are :func:`downsample_structure`'s (JAX ``sparse.py:pool_clusters``)."""
    ds = downsample_structure(coords, mask, capacity_out)
    return Clustered(ds.coords, ds.mask, ds.parent_idx)


def segment_reduce(values: torch.Tensor, seg_idx: torch.Tensor,
                   capacity: int, reduce: str = "max") -> torch.Tensor:
    """Masked segment reduction over the row axis: values [..., M, C],
    seg_idx [..., M] (-1 = skip) -> [..., capacity, C]; ``reduce`` is
    ``max``, ``sum`` or ``mean``. ``max`` starts from the dtype's lowest
    finite value and turns an empty segment into 0; its gradient splits
    evenly over tied maxima (``scatter_reduce``'s amax backward, as JAX's
    ``.at[].max``). ``mean`` divides by the count, at least 1."""
    C = values.shape[-1]
    lead = values.shape[:-2]
    ok = seg_idx >= 0
    tgt = torch.where(ok, seg_idx, torch.full_like(seg_idx, capacity))
    idx = tgt.long()[..., None].expand(*tgt.shape, C)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    if reduce == "max":
        neg = torch.finfo(values.dtype).min
        v = torch.where(ok[..., None], values,
                        torch.full((), neg, dtype=values.dtype,
                                   device=values.device))
        out = values.new_full((*lead, capacity + 1, C), neg).scatter_reduce(
            -2, idx, v, "amax", include_self=True)[..., :capacity, :]
        return torch.where(out == neg, zero, out)
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce {reduce!r}: one of max, sum, mean")
    v = torch.where(ok[..., None], values, zero)
    out = values.new_zeros((*lead, capacity + 1, C)).scatter_add(
        -2, idx, v)[..., :capacity, :]
    if reduce == "mean":
        cnt = values.new_zeros((*lead, capacity + 1)).scatter_add(
            -1, tgt.long(), ok.to(values.dtype))[..., :capacity]
        out = out / torch.clamp_min(cnt[..., None], 1.0)
    return out
