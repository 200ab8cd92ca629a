"""Precomputed batch geometry of the scene backbones (SparseUNet, PTv3).

Port of unipre3d_tpu/models/scene_geometry.py. Every index structure of
one SpUNet forward (canonical voxel order, PointFusion pixel-voxel merge,
per-level stride-2 parent maps, submanifold neighbour tables) is a pure
function of the batch geometry, independent of features and parameters.
The trainer builds it once per batch, before the step, and hands it in the
batch. A loop over the scenes replaces the JAX package's ``vmap``; every
field is integer or boolean (or the world coords the merge permutes), and
equals the JAX one exactly.

PTv3's geometry (``PTv3Geometry``) has the same shared part and, per
stage, its pooling clusters, its 3^3 table and the serialization orders.
The JAX package builds these inline in the PTv3 forward
(unipre3d_tpu/models/ptv3.py:238-320; its ``make_geometry_fn`` returns
None for PTv3); building them before the step computes the same integers.
JAX's pooled world coordinates (``w_pool``, a segment mean) are left out:
only stage 0's reach the output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from unipre3d_tpu_torch.ops import sparse as sp
from unipre3d_tpu_torch.ops.serialization import encode
from unipre3d_tpu_torch.telemetry import span


class SpUNetGeometry(NamedTuple):
    """All index structures of one SpUNet forward, batched [B, ...]:
    order0 [B, M] canonical permutation of the input rows; mask0 [B, M];
    nbr5 [B, M, 125] stem table; pix_rep [B, P] pixel row feeding each fused
    voxel (-1) and merge_order [B, M+P] (None without fusion); world
    [B, Mf, 3] and fine_mask [B, Mf] of the final set; nbr3_fine
    [B, Mf, 27]; downs per stage; nbrs per stage [B, Mc, 27]. For the
    block executor (``conv_impl="block"``) every table is a
    :class:`~unipre3d_tpu_torch.ops.sparse.BlockStructure` instead, and
    ``block_dropped`` [B, 2 + stages] counts the valid rows whose block
    was dropped past its capacity (their outputs are 0, as in JAX, which
    does not count them): the stem's, the fine level's, each stage's.
    None for the gather executor."""
    order0: torch.Tensor
    mask0: torch.Tensor
    nbr5: object
    pix_rep: Optional[torch.Tensor]
    merge_order: Optional[torch.Tensor]
    world: torch.Tensor
    fine_mask: torch.Tensor
    nbr3_fine: object
    downs: Tuple[sp.DownStructure, ...]
    nbrs: Tuple[object, ...]
    block_dropped: Optional[torch.Tensor] = None


def _no_feats(m: int, device) -> torch.Tensor:
    return torch.zeros(m, 0, device=device)


class FineGeometry(NamedTuple):
    """The part of a scene backbone's geometry that SparseUNet and PTv3
    share, one scene: the canonical input order, the stem's table, the
    PointFusion merge, and the final (merged) set with its 3^3 table.
    ``coords`` are the final set's grid coords, the levels' input."""
    order0: torch.Tensor
    mask0: torch.Tensor
    nbr5: torch.Tensor
    pix_rep: Optional[torch.Tensor]
    merge_order: Optional[torch.Tensor]
    world: torch.Tensor
    fine_mask: torch.Tensor
    nbr3_fine: torch.Tensor
    coords: torch.Tensor


def _gather_table(coords, mask, k: int) -> torch.Tensor:
    """The gather executor's k^3 neighbour table of a canonical set."""
    return sp.find_neighbors(
        sp.SparseVoxels(coords, _no_feats(coords.shape[0], coords.device),
                        mask), sp.kernel_offsets(k))


def _fine_geometry_one(grid_coord, mask, coord, min_coord, unproj, *,
                       grid_size: float, pixel_capacity: int,
                       use_fusion: bool, table=_gather_table
                       ) -> FineGeometry:
    """The shared part of ONE scene's geometry (unbatched fields);
    ``table(coords, mask, k)`` builds the stem's (k 5) and the fine
    level's (k 3) conv structures."""
    dev = grid_coord.device
    M = grid_coord.shape[0]

    order0 = sp._argsort(sp.pack_code(grid_coord, mask))
    coords_c, mask0, world_c = grid_coord[order0], mask[order0], coord[order0]
    nbr5 = table(coords_c, mask0, 5)

    pix_rep = merge_order = None
    if use_fusion:
        # PointFusion: bbox-filter the unprojected pixels to the valid 3D
        # cloud's extent, voxelize at the shared min_coord, concat
        pix_world = unproj[..., :3].reshape(-1, 3)
        pix_valid = unproj[..., 3].reshape(-1) > 0
        with span("sync/fusion_bbox"):
            big = torch.tensor(1e9, device=dev)
        lo = torch.where(mask0[:, None], world_c, big).amin(0)
        hi = torch.where(mask0[:, None], world_c, -big).amax(0)
        pix_valid = pix_valid & ((pix_world >= lo) & (pix_world <= hi)).all(-1)
        sv2d, pix_rep, world2d = sp.voxelize(
            pix_world, _no_feats(pix_world.shape[0], dev), pix_valid,
            grid_size, min_coord, pixel_capacity)
        merged, merge_order = sp.merge_voxel_sets(
            coords_c, _no_feats(M, dev), mask0, sv2d.coords,
            _no_feats(pixel_capacity, dev), sv2d.mask)
        fine_coords, fine_mask = merged.coords, merged.mask
        world = torch.cat([world_c, world2d])[merge_order]
    else:
        fine_coords, fine_mask, world = coords_c, mask0, world_c

    nbr3_fine = table(fine_coords, fine_mask, 3)
    return FineGeometry(order0=order0, mask0=mask0, nbr5=nbr5,
                        pix_rep=pix_rep, merge_order=merge_order, world=world,
                        fine_mask=fine_mask, nbr3_fine=nbr3_fine,
                        coords=fine_coords)


CONV_IMPLS = ("gather", "block")


def _geometry_one(grid_coord, mask, coord, min_coord, unproj, *,
                  grid_size: float, pixel_capacity: int,
                  level_caps: Sequence[int], use_fusion: bool,
                  conv_impl: str = "gather", block_size: int = 4,
                  block_div: int = 8) -> SpUNetGeometry:
    """SparseUNet geometry of ONE scene (unbatched fields): the shared
    part, then a stride-2 structure and a 3^3 structure per level. The
    structures are neighbour tables for ``conv_impl="gather"`` and, for
    ``"block"``, block structures (JAX ``_geometry_one``): a k3 set of
    capacity ``cap`` gets ``max(cap // block_div, 16)`` blocks of side
    ``block_size``, the stem's k5 set ``max(M // block_div, 16)`` (halo
    2)."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r}: one of {CONV_IMPLS}")
    table = _gather_table
    if conv_impl == "block":
        def table(coords, mask, k):
            return sp.block_structure(
                coords, mask, max(coords.shape[0] // block_div, 16),
                bs=block_size, halo=k // 2)
    fine = _fine_geometry_one(grid_coord, mask, coord, min_coord, unproj,
                              grid_size=grid_size,
                              pixel_capacity=pixel_capacity,
                              use_fusion=use_fusion, table=table)
    downs, nbrs = [], []
    cur_coords, cur_mask = fine.coords, fine.fine_mask
    for cap in level_caps:
        ds = sp.downsample_structure(cur_coords, cur_mask, cap)
        nbrs.append(table(ds.coords, ds.mask, 3))
        downs.append(ds)
        cur_coords, cur_mask = ds.coords, ds.mask
    shared = fine._asdict()
    del shared["coords"]
    dropped = None
    if conv_impl == "block":
        sets = [(fine.nbr5, fine.mask0), (fine.nbr3_fine, fine.fine_mask)] \
            + [(b, d.mask) for b, d in zip(nbrs, downs)]
        dropped = torch.stack([(m & (b.out_idx < 0)).sum() for b, m in sets])
    return SpUNetGeometry(**shared, downs=tuple(downs), nbrs=tuple(nbrs),
                          block_dropped=dropped)


def _stack(items):
    """Stack a list of per-scene (nested) tuples of tensors along dim 0."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    parts = [_stack(list(x)) for x in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def build_spunet_geometry(data, unprojected, *, grid_size: float,
                          pixel_capacity: int, level_divs: Sequence[int],
                          n_stages: int, use_fusion: bool,
                          conv_impl: str = "gather", block_size: int = 4,
                          block_div: int = 8) -> SpUNetGeometry:
    """Batched SpUNet geometry. data: dict with ``grid_coord`` [B, M, 3],
    ``mask`` [B, M], ``coord`` [B, M, 3], ``min_coord`` [B, 3];
    unprojected [B, V, H, W, 4] (ignored without fusion). Level capacities
    are ``max(M // level_divs[s], 64)`` of the pre-merge M, as in the JAX
    package; ``conv_impl``, ``block_size`` and ``block_div`` choose the
    conv structures (``_geometry_one``)."""
    M = data["mask"].shape[1]
    level_caps = tuple(max(M // int(level_divs[s]), 64)
                       for s in range(n_stages))
    scenes = []
    for b in range(data["mask"].shape[0]):
        scenes.append(_geometry_one(
            data["grid_coord"][b], data["mask"][b], data["coord"][b],
            data["min_coord"][b] if use_fusion else None,
            unprojected[b] if use_fusion else None,
            grid_size=grid_size, pixel_capacity=pixel_capacity,
            level_caps=level_caps, use_fusion=use_fusion,
            conv_impl=conv_impl, block_size=block_size, block_div=block_div))
    return _stack(scenes)


# PTv3 (unipre3d_tpu/models/ptv3.py): codes at depth 10 at every stage
SER_DEPTH = 10


class Serialized(NamedTuple):
    """Per-order sort of a voxel set's rows: order [..., O, M] (the row at
    each sorted position) and inverse [..., O, M] (each row's position)."""
    order: torch.Tensor
    inverse: torch.Tensor


def serialize(coords: torch.Tensor, mask: torch.Tensor,
              orders: Sequence[str], depth: int = SER_DEPTH) -> Serialized:
    """Stable argsort of each order's code: coords [..., M, 3], mask
    [..., M] -> Serialized of [..., O, M]. Coordinates are clipped to
    [0, 2^depth) and encoded at ``depth`` (JAX ``ptv3.py:serialize``; the
    PTv3 forward passes 10 at every stage, its ``depth -= 1`` never reaching
    the encoder). Invalid rows take ``INVALID_CODE``, above every 30-bit
    code, and sort last; equal codes (PointFusion's duplicate voxels) keep
    their row order, as ``jnp.argsort`` does."""
    c = coords.clamp(0, (1 << depth) - 1)
    codes = torch.stack([
        torch.where(mask, encode(c, order=o, depth=depth),
                    torch.full(mask.shape, sp.INVALID_CODE, dtype=torch.long,
                               device=mask.device)) for o in orders], -2)
    order = sp._argsort(codes)
    inverse = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device
                                ).expand_as(order).contiguous())
    return Serialized(order, inverse)


class PTv3Geometry(NamedTuple):
    """All index structures of one PTv3 forward, batched [B, ...]: the
    fields SpUNetGeometry shares (order0 ... nbr3_fine; stage 0 is the
    final set, its table ``nbr3_fine``); ``clusters`` per pooled stage
    (s = 1..S-1, Clustered of stage s-1's rows into stage s); ``nbrs`` per
    pooled stage [B, Mc, 27]; ``sers`` per stage (Serialized [B, O, M_s]);
    ``pool_dropped`` [B, S-1]: the distinct parents each pooling dropped
    past its capacity (JAX drops them silently)."""
    order0: torch.Tensor
    mask0: torch.Tensor
    nbr5: torch.Tensor
    pix_rep: Optional[torch.Tensor]
    merge_order: Optional[torch.Tensor]
    world: torch.Tensor
    fine_mask: torch.Tensor
    nbr3_fine: torch.Tensor
    clusters: Tuple[sp.Clustered, ...]
    nbrs: Tuple[torch.Tensor, ...]
    sers: Tuple[Serialized, ...]
    pool_dropped: torch.Tensor


def ptv3_stage_caps(m_fine: int, n_stages: int, patch_size: int,
                    pool_capacity_div: int) -> Tuple[int, ...]:
    """Row capacity of each stage: the final set's, then each pooling's
    ``ceil(max(cap_prev // div, patch) / patch) * patch`` (JAX
    ``ptv3.py:281-284``)."""
    caps = [m_fine]
    for _ in range(1, n_stages):
        c = max(caps[-1] // pool_capacity_div, patch_size)
        caps.append(-(-c // patch_size) * patch_size)
    return tuple(caps)


def _distinct_parents(coords, mask) -> torch.Tensor:
    """The number of distinct parents (coords >> 1) of the valid rows."""
    code = torch.sort(sp.pack_code(coords >> 1, mask)).values
    return sp._first_of_runs(code, code != sp.INVALID_CODE).sum()


def _ptv3_geometry_one(grid_coord, mask, coord, min_coord, unproj, *,
                       grid_size: float, pixel_capacity: int,
                       orders: Sequence[str], n_stages: int,
                       patch_size: int, pool_capacity_div: int,
                       use_fusion: bool) -> PTv3Geometry:
    """PTv3 geometry of ONE scene: the shared part, then per stage its
    serialization and, past stage 0, its pooling and 3^3 table."""
    fine = _fine_geometry_one(grid_coord, mask, coord, min_coord, unproj,
                              grid_size=grid_size,
                              pixel_capacity=pixel_capacity,
                              use_fusion=use_fusion)
    dev = grid_coord.device
    caps = ptv3_stage_caps(fine.fine_mask.shape[0], n_stages, patch_size,
                           pool_capacity_div)
    offs3 = sp.kernel_offsets(3)
    cur_coords, cur_mask = fine.coords, fine.fine_mask
    sers = [serialize(cur_coords, cur_mask, orders)]
    clusters, nbrs, dropped = [], [], []
    for cap in caps[1:]:
        cl = sp.pool_clusters(cur_coords, cur_mask, cap)
        dropped.append(torch.clamp_min(
            _distinct_parents(cur_coords, cur_mask) - cap, 0))
        clusters.append(cl)
        nbrs.append(sp.find_neighbors(
            sp.SparseVoxels(cl.coords, _no_feats(cap, dev), cl.mask), offs3))
        sers.append(serialize(cl.coords, cl.mask, orders))
        cur_coords, cur_mask = cl.coords, cl.mask
    pool_dropped = torch.stack(dropped) if dropped else \
        torch.zeros(0, dtype=torch.long, device=dev)
    shared = fine._asdict()
    del shared["coords"]
    return PTv3Geometry(**shared, clusters=tuple(clusters), nbrs=tuple(nbrs),
                        sers=tuple(sers), pool_dropped=pool_dropped)


def build_ptv3_geometry(data, unprojected, *, grid_size: float,
                        pixel_capacity: int, orders: Sequence[str],
                        n_stages: int, patch_size: int,
                        pool_capacity_div: int,
                        use_fusion: bool) -> PTv3Geometry:
    """Batched PTv3 geometry (inputs as :func:`build_spunet_geometry`).
    Stage capacities follow :func:`ptv3_stage_caps` from the final set's
    rows (M + pixel_capacity under fusion): 84,096 -> 28,032 -> 9,360 ->
    3,120 -> 1,056 at the published size."""
    scenes = []
    for b in range(data["mask"].shape[0]):
        scenes.append(_ptv3_geometry_one(
            data["grid_coord"][b], data["mask"][b], data["coord"][b],
            data["min_coord"][b] if use_fusion else None,
            unprojected[b] if use_fusion else None,
            grid_size=grid_size, pixel_capacity=pixel_capacity,
            orders=orders, n_stages=n_stages, patch_size=patch_size,
            pool_capacity_div=pool_capacity_div, use_fusion=use_fusion))
    return _stack(scenes)
